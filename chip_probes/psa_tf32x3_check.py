"""Quick check of the 3xTF32 PSA kernels on one NVIDIA GPU.

Builds ``semseg_torch/csrc/psa.cu`` (printing the registers and spills of
the 3xTF32 kernels), runs the 3xTF32 resident forward and dx (f32 operands)
at small and Cityscapes shapes, and prints their largest error against the
plain f32 versions as a share of ``chip_smoke.py``'s ``PSA_REL`` bar and of
the JAX package's element-wise bars (forward rtol = atol = 1e-5, dx rtol
1e-4, atol 1e-5), their distance from their own plain versions
(``*_tf32x3_reference``), whether ``m`` is exact and ``l`` within 1e-5, and
whether two calls agree bit for bit. Beside it, the element-wise ratio of
each f32 result (the kernel, the plain f32 version, the 3xTF32 plain
version, the SIMT kernel) against a float64 plain version: how far f32
arithmetic itself is from the JAX bars at these extents. At (N, 512, 2025) it also times the
two entry points (operand pack included) and the SIMT kernels they replace
(CUDA events over 10 back-to-back calls). Faster than ``chip_smoke.py`` for
iterating on the kernels.

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
                {"kernel": out, "f32 plain": want, "3xTF32 plain": emul,
                 "SIMT": psa._forward_simt(x, a, norm, False, False)}, want64, 1e-5, 1e-5),
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
                {"kernel": dx, "f32 plain": dx32, "3xTF32 plain": demul,
                 "SIMT": psa._bwd_dx_simt(x, a, g, m_ref, l_ref, norm)}, want64, 1e-4, 1e-5),
                  flush=True)
            del want64
            if hw == 2025:
                t_new = ms(lambda: psa.psa_softmax_bmm_tf32x3(x, a, norm))
                t_old = ms(lambda: psa._forward_simt(x, a, norm, False, False))
                t_dx = ms(lambda: psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g, m_ref, l_ref, norm))
                t_dx_old = ms(lambda: psa._bwd_dx_simt(x, a, g, m_ref, l_ref, norm))
                print(f"times {(n, c, hw)}: fwd 3xTF32 {t_new:.4f} ms vs SIMT {t_old:.4f}; "
                      f"dx 3xTF32 {t_dx:.4f} vs SIMT {t_dx_old:.4f}", flush=True)
        del x, a, g
        torch.cuda.empty_cache()
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
