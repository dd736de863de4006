"""How far the TPU's own bf16 rounding of dx lands from the JAX license.

Runs on the CPU; no card needed. The JAX package's bf16 license for the PSA
backward is rtol = atol = 1e-2 (``tests/test_psa_pallas.py``). On a TPU,
``_bwd_dx_kernel`` at DEFAULT precision rounds p and g to bf16 and sums in
f32; ``psa_softmax_bmm_bwd_dx_bf16_reference`` in the port models exactly
that. JAX in interpret mode on the CPU cannot show it: there DEFAULT
precision runs the product in full f32. This prints, for that plain
version against the f32 plain dx at the Cityscapes PSANet extent (C = 512,
hw = 2025) with A = randn * 3 and g = randn (numpy seeds), the license
ratio ``max |d| / (1e-2 + 1e-2 |ref|)`` of the bf16 result (p and g
rounded to bf16, f32 sums, the output rounded to bf16, as the TPU kernel
returns it), and beside it the ratio of the output rounding alone: above 1 means the TPU kernel's own
roundings exceed the license at that scale.

Usage, from the repository root:
    python3 chip_probes/bf16_dx_license.py [--n 1 8] [--seeds 0 1]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from semseg_torch.ops import psa  # noqa: E402


def license_ratio(n, c, hw, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(n, c, hw).astype(np.float32)).to(torch.bfloat16)
    a = torch.from_numpy((rs.randn(n, hw, hw) * 3).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rs.randn(n, c, hw).astype(np.float32))
    m, l = psa.psa_softmax_stats(a)
    got = psa.psa_softmax_bmm_bwd_dx_bf16_reference(x, a, g, m, l).float()  # bf16 out
    want = psa.psa_softmax_bmm_bwd_dx_reference(x.float(), a, g, m, l)  # f32 out
    bar = 1e-2 + 1e-2 * want.abs()
    ratio = (got - want).abs() / bar
    k = int(ratio.argmax())
    out_only = ((want.to(torch.bfloat16).float() - want).abs() / bar).max().item()
    return ratio.max().item(), out_only, want.flatten()[k].item()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    torch.set_num_threads(4)
    for n in args.n:
        for seed in args.seeds:
            t0 = time.perf_counter()
            ratio, out_only, at = license_ratio(n, 512, 2025, seed)
            print(f"(N, C, hw) = ({n}, 512, 2025), seed {seed}: license ratio {ratio:.4f} "
                  f"(worst element's |ref| {abs(at):.4e}; the bf16 output rounding alone "
                  f"{out_only:.4f}) "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
