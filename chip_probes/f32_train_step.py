"""The f32 PSANet50 train step of any checkout of the port, on one NVIDIA GPU.

Times ``chip_smoke.py``'s phase-16 f32 step (batch 8, 705x705 crops, 2
warm-up and 5 timed steps on a device-resident batch) with the ``semseg_torch``
package of ``--root``, so that two checkouts (an older commit unpacked with
``git archive`` under ``build/``, and this one) can be compared on one card
in one call, in turns. Launch counts are not checked: kernel names differ
between checkouts. The kernels build under ``<root>/build/``.

Usage, from the repository root on a machine with the card:
    python3 chip_probes/f32_train_step.py --root build/parent
    python3 chip_probes/f32_train_step.py --root .
"""

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose semseg_torch to time")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("f32_train_step: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_phases", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_device()
    import semseg_torch

    print(f"semseg_torch from {Path(semseg_torch.__file__).parent}", flush=True)
    res = smoke.phase_f32_train_timing(torch.device("cuda", 0), args.batch, per_step=None)
    print(f"f32 train step {root}: {res}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
