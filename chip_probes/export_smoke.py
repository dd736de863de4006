"""``chip_smoke.py``'s phase 22 alone, on the card: the device line, the
kernel build, then the serving export (the CUDA-targeted PSANet50 crop
artifact reloaded in a fresh process, the PSANet50 and PSPNet50
full-scope artifacts at 1024x2048 against ``predict``). About two minutes
of chip time.

Usage, from the repository root: ``python3 chip_probes/export_smoke.py``
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("export_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    images = [chip_smoke.street_image(seed) for seed in range(3)]
    print(chip_smoke.phase_export(torch.device("cuda", 0), images, smi))
    return 0


if __name__ == "__main__":
    sys.exit(main())
