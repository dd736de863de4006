"""Quick check of the tensor-core PSA kernels on one NVIDIA GPU.

Builds ``semseg_torch/csrc/psa.cu``, runs the tensor-core forward, dx and
da (bf16 operands) at small and Cityscapes shapes, and prints their largest
error against the plain f32 versions as a share of the element-wise bars
of ``tests/test_torch_cuda.py`` (da also against its bf16 plain version,
and two calls compared bit for bit). At (N, 512, 2025) it also times the
three kernels (CUDA events over 10 back-to-back calls of the entry points).
Faster than ``chip_smoke.py`` for iterating on the kernels; an older
kernel's times come from a checkout of its commit.

Usage, from the repository root on a machine with the card:
    python3 chip_probes/psa_wgmma_check.py
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from semseg_torch.ops import psa  # noqa: E402
from semseg_torch.ops._build import build_library  # noqa: E402


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


def main():
    if not torch.cuda.is_available():
        print("psa_wgmma_check: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    b = build_library("psa")
    print(f"build {b.seconds:.1f} s", flush=True)
    log = b.log.splitlines()
    for k, ln in enumerate(log):  # ptxas's registers and spills of the da kernel
        if "Compiling entry function" in ln and "psa_da_wgmma" in ln:
            print("\n".join(s.strip() for s in log[k:k + 4]), flush=True)
    dev = torch.device("cuda")
    norm = 1.3
    for n, c, hw in [(1, 16, 64), (1, 130, 97), (3, 16, 200), (2, 64, 150), (1, 5, 1),
                     (8, 512, 2025), (16, 512, 2025)]:
        g0 = torch.Generator(device=dev).manual_seed(hw)
        x = torch.randn(n, c, hw, generator=g0, device=dev).to(torch.bfloat16)
        a = (torch.randn(n, hw, hw, generator=g0, device=dev) * 3).to(torch.bfloat16)
        g = torch.randn(n, c, hw, generator=g0, device=dev)
        with torch.no_grad():
            out, m, l = psa.psa_softmax_bmm_wgmma(x, a, norm, return_stats=True)
            torch.cuda.synchronize()
            want = psa.psa_softmax_bmm_reference(x, a, norm)
            p = torch.softmax(a.float(), dim=1)
            bar = 2.0 ** -8 * torch.bmm(x.float().abs(), p) / norm + 1e-6
            err = (out - want).abs()
            m_ref, l_ref = psa.psa_softmax_stats(a)
            print(f"fwd {(n, c, hw)}: max err {err.max().item():.3e}, worst err/bar "
                  f"{(err / bar).max().item():.3f}, m exact {torch.equal(m, m_ref)}, l rel "
                  f"{((l - l_ref).abs() / l_ref).max().item():.2e}", flush=True)
            dx = psa.psa_softmax_bmm_bwd_dx_wgmma(x, a, g, m_ref, l_ref, norm)
            torch.cuda.synchronize()
            dx32 = psa.psa_softmax_bmm_bwd_dx_reference(x.float(), a, g, m_ref, l_ref, norm)
            ulp = 2.0 ** (torch.floor(torch.log2(dx32.abs().clamp_min(1e-30))) - 7)
            bar = 2.0 ** -7 * torch.bmm(g.abs(), p.transpose(1, 2)) / norm + ulp
            err = (dx.float() - dx32).abs()
            print(f"dx  {(n, c, hw)}: max err {err.max().item():.3e}, worst err/bar "
                  f"{(err / bar).max().item():.3f}", flush=True)
            da = psa.psa_softmax_bmm_bwd_da_wgmma(x, a, g, m_ref, l_ref, want, norm)
            torch.cuda.synchronize()
            same = torch.equal(da, psa.psa_softmax_bmm_bwd_da_wgmma(x, a, g, m_ref, l_ref, want,
                                                                     norm))
            da16 = psa.psa_softmax_bmm_bwd_da_bf16_reference(x, a, g, m_ref, l_ref, want, norm)
            da32 = psa.psa_softmax_bmm_bwd_da_reference(x.float(), a.float(), g, m_ref, l_ref,
                                                        want, norm)
            pe = psa._probs(a, m_ref, l_ref)
            ulp = 2.0 ** (torch.floor(torch.log2(da32.abs().clamp_min(1e-30))) - 7)
            bar = pe * 2.0 ** -8 * torch.bmm(x.float().abs().transpose(1, 2), g.abs()) / norm + ulp
            err = (da.float() - da32).abs()
            print(f"da  {(n, c, hw)}: max err {err.max().item():.3e}, worst err/bar "
                  f"{(err / bar).max().item():.3f}, vs bf16 plain max "
                  f"{(da.float() - da16.float()).abs().max().item():.3e}, repeat identical "
                  f"{same}", flush=True)
            if hw == 2025:
                t_new = ms(lambda: psa.psa_softmax_bmm_wgmma(x, a, norm))
                t_dx = ms(lambda: psa.psa_softmax_bmm_bwd_dx_wgmma(x, a, g, m_ref, l_ref, norm))
                t_da = ms(lambda: psa.psa_softmax_bmm_bwd_da_wgmma(x, a, g, m_ref, l_ref, want,
                                                                   norm))
                t_delta = ms(lambda: psa._delta(g, want))
                print(f"times {(n, c, hw)}: fwd wgmma {t_new:.4f} ms; dx wgmma {t_dx:.4f}; da "
                      f"wgmma {t_da:.4f} (delta alone {t_delta:.4f})", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
