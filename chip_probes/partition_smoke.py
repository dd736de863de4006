"""``chip_smoke.py``'s phase 23 alone, on the card: the device line, the
kernel build, then the evaluator's ``window`` and ``spatial`` partitions
over two entries of the card (``devices=[cuda:0, cuda:0]``) and its
``host`` pipeline, at 1024x2048 with PSPNet50 and PSANet50. About a
minute of chip time.

Usage, from the repository root: ``python3 chip_probes/partition_smoke.py``
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("partition_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    images = [chip_smoke.street_image(seed) for seed in range(3)]
    print(chip_smoke.phase_partitions(torch.device("cuda", 0), images, smi))
    return 0


if __name__ == "__main__":
    sys.exit(main())
