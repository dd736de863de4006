"""``chip_smoke.py``'s phase 26 alone, on the card: the device line, the
kernel build, the 48 street images of phase 13 (written under ``build/``
if absent), then the 101-layer Cityscapes recipes with and without
``remat`` (PSANet101 f32 steps bit for bit against each other, the f32
step at batch 16 with ``remat``, the bf16 recipe through
``semseg_torch.train.run``, PSPNet101 and PSANet101 serving). About two
minutes of chip time.

Usage, from the repository root: ``python3 chip_probes/remat_smoke.py``
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("remat_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    root = Path("build") / "chip_smoke_data"
    if not (root / "train.txt").is_file():
        chip_smoke.write_dataset(root)
    images = [chip_smoke.street_image(seed) for seed in range(chip_smoke.R101_SERVE)]
    by_path, out = chip_smoke.phase_r101(torch.device("cuda", 0), root, images, smi)
    print(json.dumps({"launches_by_path": {p: {k: v for k, v in c.items() if v}
                                           for p, c in by_path.items()},
                      "readings": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
