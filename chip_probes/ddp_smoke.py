"""``chip_smoke.py``'s phase 21 alone, on the card: the device line, the
kernel build, the 48 street images of phase 13 (written under ``build/``
if absent), then data-parallel training as two ranks sharing the card
over gloo (the f32 DDP step against one process, gated on the one-ulp
floor, and the bf16 driver through ``semseg_torch.train.spawn``). About
a minute and a half of chip time.

Usage, from the repository root: ``python3 chip_probes/ddp_smoke.py``
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("ddp_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    root = Path("build") / "chip_smoke_data"
    if not (root / "train.txt").is_file():
        chip_smoke.write_dataset(root)
    by_path = chip_smoke.phase_ddp(torch.device("cuda", 0), root, smi, None)
    print(by_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
