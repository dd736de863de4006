"""``chip_smoke.py``'s phase 28 alone, on the card: the device line, the
kernel build, then the inference-mode BatchNorm kernel against its plain
version at the PSPNet50 serving shapes (bit for bit, times beside the byte
bound) and a bf16 PSPNet50 eval forward of 8 windows with and without it.
About two minutes of chip time.

Usage, from the repository root: ``python3 chip_probes/batchnorm_smoke.py``
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("batchnorm_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    print(chip_smoke.phase_batchnorm(torch.device("cuda", 0), smi))
    return 0


if __name__ == "__main__":
    sys.exit(main())
