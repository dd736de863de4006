"""Shared data and configs of the port's driver tests
(``tests/test_torch_drivers.py``, ``tests/test_torch_test_driver.py``):
seeded synthetic PNGs with list files, and the argument lists of
``config/cityscapes/cityscapes_psanet50.yaml`` cut to their size."""

import os

import cv2
import numpy as np
import pytest
import torch

from semseg_torch import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config/cityscapes/cityscapes_psanet50.yaml")
IGNORE = 255
CLASSES = 5
H, W = 48, 64
CROP = 17  # 3x3 features: the PSA mask 3x3 at shrink 2


@pytest.fixture(autouse=True, scope="module")
def threads():
    """Two intra-op threads: the suite runs in several pytest workers that
    share the CPU's cores, and these tests are mostly small convolutions."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def write_dataset(root, n=4):
    """``n`` seeded images with label PNGs, ``train.txt`` listing them,
    palette and names files."""
    rs = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    lines = []
    for k in range(n):
        img = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
        img[:, : W // 2] //= 3  # a dark half: something to segment
        cv2.imwrite(os.path.join(root, "img", f"{k}.png"), img)
        label = rs.randint(0, CLASSES, (H, W)).astype(np.uint8)
        label[:4] = IGNORE
        cv2.imwrite(os.path.join(root, "img", f"{k}_label.png"), label)
        lines.append(f"img/{k}.png img/{k}_label.png")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(lines[:3]) + "\n")  # 3: batch_size_val 2 leaves a partial batch
    np.savetxt(os.path.join(root, "colors.txt"),
               np.random.RandomState(1).randint(0, 256, (CLASSES, 3)), fmt="%d")
    with open(os.path.join(root, "names.txt"), "w") as f:
        f.write("\n".join(f"class{c}" for c in range(CLASSES)) + "\n")


def argv(root, *extra):
    """``--config`` and the overrides that point the config at ``root``'s
    data at 17x17 crops; ``extra`` KEY VALUE pairs follow."""
    root = str(root)
    return ["--config", CONFIG, "data_root", root,
            "train_list", os.path.join(root, "train.txt"),
            "val_list", os.path.join(root, "val.txt"),
            "test_list", os.path.join(root, "train.txt"),
            "classes", str(CLASSES), "train_h", str(CROP), "train_w", str(CROP),
            "test_h", str(CROP), "test_w", str(CROP), "base_size", str(W),
            "batch_size", "2", "batch_size_val", "2", "epochs", "2", "workers", "2",
            "print_freq", "1", "manual_seed", "3", "save_path", os.path.join(root, "exp"),
            "colors_path", os.path.join(root, "colors.txt"),
            "names_path", os.path.join(root, "names.txt"),
            "save_folder", os.path.join(root, "result"), *extra]


def cfg(root, *extra, **keys):
    """The training driver's config of ``argv(root, *extra)``, with
    ``keys`` set on it (``_preempt_after_step`` among them)."""
    out = train.parse_args(argv(root, *extra))
    out.update(keys)
    return out
