"""Phase 27 of ``chip_smoke.py`` on any checkout of the port, and the cost of
cuDNN's deterministic algorithms, on one NVIDIA GPU.

``--root DIR`` runs phase 27 (``chip_smoke.phase_repro``: float32 training
through ``semseg_torch.train.run`` twice uninterrupted and once preempted and
resumed, on the ADE20K PSPNet50 and the Cityscapes PSANet50 recipes; the
test driver's per-shape caches over ADE20K-like image sizes; ADE20K and
VOC2012 serving) with the ``semseg_torch`` package of ``DIR``: gated for
this checkout (``--root .``), ungated for another, so that an older commit
unpacked with ``git archive`` under ``build/`` shows its readings. The
kernels build under ``DIR/build/``.

``--cost`` times the float32 train step on a device-resident batch with
``torch.backends.cudnn.deterministic`` off and on, in the order off, on,
on, off: PSANet50 at batch 8, 705x705 (``chip_smoke.py`` phase 16's shape)
and the ADE20K PSPNet50 recipe's step at batch 16, 473x473, 150 classes;
each arm 2 warm-up and 5 timed steps (``chip_smoke.f32_arm``), with its peak
memory. JSON lines go to standard output and to
``build/chip_smoke/repro_cost.jsonl``.

Usage, from the repository root on a machine with the card:
    python3 chip_probes/repro_smoke.py --root build/parent
    python3 chip_probes/repro_smoke.py --cost
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
COST_STEPS, COST_WARMUP = 7, 2


def cost(smoke, dev, smi):
    """The float32 step with the flag off and on (see the module's
    docstring); one JSON line an arm."""
    ade = SimpleNamespace(**{**vars(smoke.pspnet_cfg()), "classes": 150, "train_h": 473,
                             "train_w": 473, "test_h": 473, "test_w": 473, "base_size": 512})
    pairs = [smoke.ade_sample(600 + k, 473, 473) for k in range(16)]
    ade_batch = tuple(torch.from_numpy(np.stack(v)).to(dev) for v in zip(*pairs))
    arms = (("PSANet50 705x705 batch 8", smoke.psanet_cfg(),
             smoke.street_batch(dev, 8, 705, 300), smoke.F32_TRAIN_STEP),
            ("ADE20K PSPNet50 473x473 batch 16", ade, ade_batch, {}))
    smoke.OUT_DIR.mkdir(parents=True, exist_ok=True)
    saved = torch.backends.cudnn.deterministic
    try:
        with open(smoke.OUT_DIR / "repro_cost.jsonl", "w") as f:
            for label, cfg, (images, labels), per_step in arms:
                for det in (False, True, True, False):
                    torch.backends.cudnn.deterministic = det
                    arm = smoke.f32_arm(dev, cfg, images, labels, COST_STEPS, per_step,
                                        warmup=COST_WARMUP)
                    line = dict(arm=label, cudnn_deterministic=det, step_s=arm["step_s"],
                                images_per_s=images.shape[0] / arm["step_s"],
                                seconds=arm["seconds"], peak_gib=arm["peak_gib"], card=smi)
                    f.write(json.dumps(line) + "\n")
                    print(json.dumps(line), flush=True)
                    del arm
    finally:
        torch.backends.cudnn.deterministic = saved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None, help="checkout whose semseg_torch runs phase 27")
    ap.add_argument("--cost", action="store_true", help="time the flag's cost")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repro_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = Path(args.root).resolve() if args.root else HERE
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_phases", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, smi = smoke.phase_device()
    import semseg_torch

    print(f"semseg_torch from {Path(semseg_torch.__file__).parent}", flush=True)
    dev = torch.device("cuda", 0)
    if args.cost:
        cost(smoke, dev, smi)
    if args.root:
        smoke.phase_repro(dev, smi, gate=root == HERE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
