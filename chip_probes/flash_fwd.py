"""The flash PSA forward and the shrink-1 f32 train step of any checkout of
the port, on one NVIDIA GPU.

With the ``semseg_torch`` package of ``--root``, times the flash forward
entry point (``psa_softmax_bmm_flash``) at the shrink-1 extent (1, 512,
7921), A = randn * 3, f32 and bf16 operands (CUDA events, median of 20, as
``chip_smoke.py::cuda_ms``), beside the plain version and the bound, and
prints its error: f32 against JAX's element-wise rtol = atol = 1e-5 in
float64 (``elementwise_f64``), bf16 against ``fwd_bars``, both as the share
of the bar. Then it times ``chip_smoke.py``'s phase-17 f32 PSANet50 step at
shrink 1 (batch 2, 705x705, forward and backward, no update; host clock,
synchronised; one warm-up and 3 timed steps). Two checkouts (an older
commit unpacked with ``git archive`` under ``build/``, and this one) are
compared on one card in one call, in turns. The kernels build under
``<root>/build/``.

Usage, from the repository root on a machine with the card:
    python3 chip_probes/flash_fwd.py --root build/parent
    python3 chip_probes/flash_fwd.py --root .
"""

import argparse
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose semseg_torch to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_phases", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_device()
    import semseg_torch
    from semseg_torch.models.build import build_model
    from semseg_torch.ops import psa

    tag = f"[flash_fwd {root.name or 'root'}]"
    print(f"{tag} semseg_torch from {Path(semseg_torch.__file__).parent}", flush=True)
    dev = torch.device("cuda", 0)
    n, c, hw = 1, 512, 7921
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, c, hw, generator=g, device=dev).to(dt)
        a = (torch.randn(n, hw, hw, generator=g, device=dev) * 3).to(dt)
        with torch.inference_mode():
            out = psa.psa_softmax_bmm_flash(x, a)
            torch.cuda.synchronize()
            if dt == torch.float32:
                err = smoke.elementwise_f64(out, x, torch.softmax(a.double(), dim=1))
                bar = "JAX's 1e-5 element-wise against f64"
            else:
                want = psa.psa_softmax_bmm_reference(x, a)
                err = ((out - want).abs() / smoke.fwd_bars(x, a)).max().item()
                bar = "fwd_bars"
                del want
            ms = smoke.cuda_ms(lambda: psa.psa_softmax_bmm_flash(x, a))
            plain_ms = smoke.cuda_ms(lambda: psa.psa_softmax_bmm_reference(x, a))
        bound_ms, bound_by = smoke.psa_fwd_bound(n, c, hw, dt)
        print(f"{tag} flash forward {(n, c, hw)} {str(dt).split('.')[-1]}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}; error {err:.4f} of "
              f"{bar}", flush=True)
        del x, a, out
        torch.cuda.empty_cache()

    model = build_model(smoke.psanet_cfg(shrink_factor=1), dtype=torch.float32, device=dev,
                        seed=0, train=True)
    pairs = [smoke.street_sample(10 + s) for s in range(2)]
    images = torch.stack([smoke.normalized_window(p[0], 705, dev)[0] for p in pairs])
    labels = torch.from_numpy(np.stack([p[1][:705, :705] for p in pairs])).long().to(dev)
    smoke.train_grads(model, images, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        smoke.train_grads(model, images, labels)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    print(f"{tag} shrink-1 f32 train step, batch 2, 705x705: {step_s:.4f} s per step over 3",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
