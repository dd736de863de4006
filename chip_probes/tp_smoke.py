"""``chip_smoke.py``'s phase 24 alone, on the card: the device line, the
kernel build, the 48 street images of phase 13 (written under ``build/``
if absent), then tensor-parallel training as ranks sharing the card over
gloo (the PSA kernels at a TP rank's 256 channels against their plain
versions, the f32 step as 1 x 2 and 2 x 2 data x model ranks against one
process, gated on the one-ulp floor, and the bf16 driver through
``semseg_torch.train.spawn`` with ``model_parallel 2``). About two
minutes of chip time.

Usage, from the repository root: ``python3 chip_probes/tp_smoke.py``
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("tp_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    root = Path("build") / "chip_smoke_data"
    if not (root / "train.txt").is_file():
        chip_smoke.write_dataset(root)
    by_path, _, _ = chip_smoke.phase_tp(torch.device("cuda", 0), root, smi, None)
    print(by_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
