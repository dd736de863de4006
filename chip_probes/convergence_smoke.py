"""``chip_smoke.py``'s phase 25 alone, on the card: the device line, the
kernel build, the 48 street images of phase 13 (written under ``build/``
if absent), then the convergence license (the PSA kernels at (8, 512, 49)
against their plain versions; ``semseg_torch.convergence.run`` for
PSPNet50 and PSANet50, f32 and bf16, seed 0, 400 steps, with its gates)
and the launch script (``semseg_torch/tool/train.sh``, train then test,
beside the arms). About four minutes of chip time.

Usage, from the repository root: ``python3 chip_probes/convergence_smoke.py``
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("convergence_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    root = Path("build") / "chip_smoke_data"
    if not (root / "train.txt").is_file():
        chip_smoke.write_dataset(root)
    by_path, _, _, _ = chip_smoke.phase_convergence(torch.device("cuda", 0), smi)
    print(by_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
