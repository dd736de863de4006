"""Quick check of the 3xTF32 PSA kernels on one NVIDIA GPU.

Builds ``semseg_torch/csrc/psa.cu`` (printing the registers and spills of
the 3xTF32 kernels and any ptxas warning), runs the 3xTF32 resident
forward, dx and da (f32 operands) at small and Cityscapes shapes, and prints
their largest error against the plain f32 versions as a share of
``chip_smoke.py``'s ``PSA_REL`` bar and of the JAX package's element-wise
bars (forward rtol = atol = 1e-5, dx and da rtol 1e-4, atol 1e-5), their
distance from their own plain versions
(``*_tf32x3_reference``), whether ``m`` is exact and ``l`` within 1e-5, and
whether two calls agree bit for bit. Beside it, the element-wise ratio of
each f32 result (the kernel, the plain f32 version, the 3xTF32 plain
version) against a float64 plain version: how far f32
arithmetic itself is from the JAX bars at these extents (da's float64
version takes ``delta`` in float64 too); for da also the ratio against
``chip_smoke.py``'s derived bar (``da_f32_ratios``: JAX's bar plus
``DA_F32_K`` p 2^-24 (|x|^T |g| / norm + sum_c |g out|)), the least K that
bar would need for each result, and a single TF32 pass as a contrast that
must fail it. At (N, 512, 2025) it also times the
three entry points (operand packs and da's ``delta`` included), and at (1,
512, 7921) the flash backward's route (the 3xTF32 dx and da) against the
plain da + dx (CUDA events over 10 back-to-back calls). Faster than
``chip_smoke.py`` for iterating on the kernels; an older kernel's times
come from a checkout of its commit.

Usage, from the repository root on a machine with the card:
    python3 chip_probes/psa_tf32x3_check.py
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from semseg_torch.ops import psa  # noqa: E402
from semseg_torch.ops._build import build_library  # noqa: E402
from chip_smoke import DA_F32_K  # noqa: E402

SHAPES = [(1, 16, 64), (2, 24, 100), (1, 130, 97), (3, 16, 200), (1, 5, 1), (2, 300, 150),
          (8, 512, 900), (8, 512, 2025), (16, 512, 2025), (1, 512, 7921)]


def ms(fn, reps=10):
    for _ in range(3):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def ratios(got, want, rtol, atol):
    """(max |err|, max err / PSA_REL bar, max err / (atol + rtol |want|))."""
    err = (got - want).abs()
    bar = 1e-4 * want.abs().max().item() + 1e-5
    return err.max().item(), err.max().item() / bar, (err / (atol + rtol * want.abs())).max().item()


def elem64(results, want64, rtol, atol):
    """``name=ratio`` of each result's largest |err| / (atol + rtol |want64|)."""
    bar = atol + rtol * want64.abs()
    return ", ".join(f"{k} {((v.double() - want64).abs() / bar).max().item():.4f}"
                     for k, v in results.items())


def check_da(x, a, g, out, m, l, norm):
    """The 3xTF32 da against its plain versions and float64 (delta too)."""
    da = psa.psa_softmax_bmm_bwd_da_tf32x3(x, a, g, m, l, out, norm)
    torch.cuda.synchronize()
    da32 = psa.psa_softmax_bmm_bwd_da_reference(x, a, g, m, l, out, norm)
    demul = psa.psa_softmax_bmm_bwd_da_tf32x3_reference(x, a, g, m, l, out, norm)
    err, rel, elem = ratios(da, da32, 1e-4, 1e-5)
    same = torch.equal(da, psa.psa_softmax_bmm_bwd_da_tf32x3(x, a, g, m, l, out, norm))
    print(f"da  {tuple(x.shape)}: max err {err:.3e} ({rel:.4f} of PSA_REL, {elem:.4f} of JAX "
          f"1e-4/1e-5 element-wise; vs its plain version {(da - demul).abs().max().item():.3e}), "
          f"repeat identical {same}", flush=True)
    p64 = torch.exp(a.double() - m.double()[:, None]) / l.double()[:, None]
    d64 = (g.double() * out.double()).sum(1)
    want64 = p64 * (torch.bmm(x.double().transpose(1, 2), g.double()) / norm - d64[:, None])
    results = {"kernel": da, "f32 plain": da32, "3xTF32 plain": demul,
               "one TF32 pass": psa.psa_softmax_bmm_bwd_da_reference(
                   psa.tf32_split(x)[0], a, psa.tf32_split(g)[0], m, l, out, norm)}
    print(f"    da vs f64, of JAX's 1e-4/1e-5: " + elem64(results, want64, 1e-4, 1e-5), flush=True)
    # The cancellation term per unit of K, and the rest of the derived bar.
    unit = 2.0 ** -24 * p64 * (torch.bmm(x.double().abs().transpose(1, 2), g.double().abs())
                               / norm + (g.double() * out.double()).abs().sum(1)[:, None])
    jax_bar = 1e-4 * want64.abs() + 1e-5
    row = []
    for k, v in results.items():
        err = (v.double() - want64).abs()
        row.append(f"{k} {(err / (jax_bar + DA_F32_K * unit)).max().item():.4f} (least K "
                   f"{((err - jax_bar) / unit).max().item():.3f})")
    print(f"    da vs f64, of the derived bar (K = {DA_F32_K}): " + ", ".join(row), flush=True)
    del p64, want64, unit, jax_bar, results, da32, demul


def main():
    if not torch.cuda.is_available():
        print("psa_tf32x3_check: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    b = build_library("psa")
    print(f"build {b.seconds:.1f} s", flush=True)
    log = b.log.splitlines()
    for k, ln in enumerate(log):  # ptxas's registers and spills of the 3xTF32 kernels
        if "Compiling entry function" in ln and "tf32x3" in ln:
            print("\n".join(s.strip() for s in log[k:k + 4]), flush=True)
        if "warning" in ln.lower():
            print(ln.strip(), flush=True)
    dev = torch.device("cuda")
    norm = 1.3
    for n, c, hw in SHAPES:
        g0 = torch.Generator(device=dev).manual_seed(hw)
        x = torch.randn(n, c, hw, generator=g0, device=dev)
        a = torch.randn(n, hw, hw, generator=g0, device=dev) * 3
        g = torch.randn(n, c, hw, generator=g0, device=dev)
        with torch.no_grad():
            out, m, l = psa.psa_softmax_bmm_tf32x3(x, a, norm, return_stats=True)
            torch.cuda.synchronize()
            want = psa.psa_softmax_bmm_reference(x, a, norm)
            emul = psa.psa_softmax_bmm_tf32x3_reference(x, a, norm)
            m_ref, l_ref = psa.psa_softmax_stats(a)
            err, rel, elem = ratios(out, want, 1e-5, 1e-5)
            same = torch.equal(out, psa.psa_softmax_bmm_tf32x3(x, a, norm))
            print(f"fwd {(n, c, hw)}: max err {err:.3e} ({rel:.4f} of PSA_REL, {elem:.4f} of "
                  f"JAX 1e-5 element-wise; vs its plain version "
                  f"{(out - emul).abs().max().item():.3e}), m exact {torch.equal(m, m_ref)}, l rel "
                  f"{((l - l_ref).abs() / l_ref).max().item():.2e}, repeat identical {same}",
                  flush=True)
            want64 = torch.bmm(x.double(), torch.softmax(a.double(), dim=1)) / norm
            print(f"    fwd vs f64, of JAX's 1e-5: " + elem64(
                {"kernel": out, "f32 plain": want, "3xTF32 plain": emul}, want64, 1e-5, 1e-5),
                  flush=True)
            del want64
            dx = psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g, m_ref, l_ref, norm)
            torch.cuda.synchronize()
            dx32 = psa.psa_softmax_bmm_bwd_dx_reference(x, a, g, m_ref, l_ref, norm)
            demul = psa.psa_softmax_bmm_bwd_dx_tf32x3_reference(x, a, g, m_ref, l_ref, norm)
            err, rel, elem = ratios(dx, dx32, 1e-4, 1e-5)
            same = torch.equal(dx, psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g, m_ref, l_ref, norm))
            print(f"dx  {(n, c, hw)}: max err {err:.3e} ({rel:.4f} of PSA_REL, {elem:.4f} of "
                  f"JAX 1e-4/1e-5 element-wise; vs its plain version "
                  f"{(dx - demul).abs().max().item():.3e}), repeat identical {same}", flush=True)
            p64 = torch.exp(a.double() - m_ref.double()[:, None]) / l_ref.double()[:, None]
            want64 = torch.bmm(g.double(), p64.transpose(1, 2)) / norm
            del p64
            print(f"    dx vs f64, of JAX's 1e-4/1e-5: " + elem64(
                {"kernel": dx, "f32 plain": dx32, "3xTF32 plain": demul}, want64, 1e-4, 1e-5),
                  flush=True)
            del want64
            check_da(x, a, g, out, m_ref, l_ref, norm)
            if hw == 2025:
                t_new = ms(lambda: psa.psa_softmax_bmm_tf32x3(x, a, norm))
                t_dx = ms(lambda: psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g, m_ref, l_ref, norm))
                t_da = ms(lambda: psa.psa_softmax_bmm_bwd_da_tf32x3(x, a, g, m_ref, l_ref, out,
                                                                      norm))
                print(f"times {(n, c, hw)}: fwd 3xTF32 {t_new:.4f} ms; dx 3xTF32 {t_dx:.4f}; "
                      f"da 3xTF32 {t_da:.4f}", flush=True)
            if hw == 7921:
                t_route = ms(lambda: psa.psa_softmax_bmm_flash_bwd(x, a, g, m_ref, l_ref, out,
                                                                   norm))
                t_plain = ms(lambda: psa.psa_softmax_bmm_bwd_reference(x, a, g, m_ref, l_ref, out,
                                                                       norm), reps=3)
                print(f"times {(n, c, hw)}: flash backward route {t_route:.4f} ms, plain da + "
                      f"dx {t_plain:.4f}", flush=True)
        del x, a, g
        torch.cuda.empty_cache()
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
