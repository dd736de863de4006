"""Quick check of the tensor-core PSA kernels on one NVIDIA GPU.

Builds ``semseg_torch/csrc/psa.cu``, runs the tensor-core forward and dx
(bf16 operands) at small and Cityscapes shapes, and prints their largest
error against the plain f32 versions as a share of the element-wise bars
of ``tests/test_torch_cuda.py``. At (N, 512, 2025) it also times both
kernels and the SIMT kernels they replaced (CUDA events over 10 back-to-back
calls). Faster than ``chip_smoke.py`` for iterating on the kernels.

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
    print(f"build {build_library('psa').seconds:.1f} s", flush=True)
    dev = torch.device("cuda")
    norm = 1.3
    for n, c, hw in [(1, 16, 64), (1, 130, 97), (3, 16, 200), (2, 64, 150), (8, 512, 2025),
                     (16, 512, 2025)]:
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
            if hw == 2025:
                t_new = ms(lambda: psa.psa_softmax_bmm_wgmma(x, a, norm))
                t_old = ms(lambda: psa._forward_simt(x, a, norm, False, False))
                t_dx = ms(lambda: psa.psa_softmax_bmm_bwd_dx_wgmma(x, a, g, m_ref, l_ref, norm))
                t_dx_old = ms(lambda: psa._bwd_dx_simt(x, a, g, m_ref, l_ref, norm))
                print(f"times {(n, c, hw)}: fwd wgmma {t_new:.4f} ms vs simt {t_old:.4f}; "
                      f"dx wgmma {t_dx:.4f} vs simt {t_dx_old:.4f}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
