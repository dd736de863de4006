"""List-file segmentation dataset (a copy of ``semseg_tpu/data/dataset.py``).

Behavior-compatible with the reference (``util/dataset.py:17-71``): each
line of the list file is ``image_path label_path`` relative to
``data_root`` (test split: image only, label path is a placeholder).
Images are read BGR by cv2 and converted to RGB float32; labels are read
grayscale.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from semseg_torch.data.transform import _cv2

logger = logging.getLogger(__name__)

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm")


def is_image_file(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def make_dataset(
    split: str = "train",
    data_root: Optional[str] = None,
    data_list: Optional[str] = None,
) -> List[Tuple[str, str]]:
    if split not in ("train", "val", "test"):
        raise ValueError(f"bad split {split}")
    if not os.path.isfile(data_list):
        raise RuntimeError(f"Image list file does not exist: {data_list}")
    items = []
    with open(data_list) as f:
        lines = f.readlines()
    logger.info("Totally %d samples in %s set.", len(lines), split)
    for line in lines:
        parts = line.strip().split(" ")
        if split == "test":
            if len(parts) != 1:
                raise RuntimeError(f"Image list line error: {line}")
            image_name = os.path.join(data_root, parts[0])
            label_name = image_name  # placeholder, unused for test
        else:
            if len(parts) != 2:
                raise RuntimeError(f"Image list line error: {line}")
            image_name = os.path.join(data_root, parts[0])
            label_name = os.path.join(data_root, parts[1])
        items.append((image_name, label_name))
    return items


def read_image(path: str) -> np.ndarray:
    """RGB float32 HWC image."""
    cv2 = _cv2()
    image = cv2.imread(path, cv2.IMREAD_COLOR)
    if image is None:
        raise RuntimeError(f"Failed to read image: {path}")
    return np.float32(cv2.cvtColor(image, cv2.COLOR_BGR2RGB))


def read_label(path: str) -> np.ndarray:
    cv2 = _cv2()
    label = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if label is None:
        raise RuntimeError(f"Failed to read label: {path}")
    return label


class SemData:
    """Map-style dataset of (image, label) pairs."""

    def __init__(
        self,
        split: str = "train",
        data_root: Optional[str] = None,
        data_list: Optional[str] = None,
        transform: Optional[Callable] = None,
    ):
        self.split = split
        self.data_list = make_dataset(split, data_root, data_list)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, index: int):
        image_path, label_path = self.data_list[index]
        image = read_image(image_path)
        if self.split == "test":
            label = np.zeros(image.shape[:2], dtype=np.uint8)
        else:
            label = read_label(label_path)
        if image.shape[:2] != label.shape[:2]:
            raise RuntimeError(
                f"Image & label shape mismatch: {image_path} {label_path}"
            )
        if self.transform is not None:
            image, label = self.transform(image, label)
        return image, label


class Uint8Wire:
    """Wraps a dataset whose images are float [0,255] pixels and emits
    them as uint8 — the per-sample conversion for the
    ``image_wire_dtype: uint8`` path (quarter the f32 wire bytes, with
    normalization moved onto the device).

    Running the conversion here puts it on the loader's worker threads
    via ``cv2.convertScaleAbs`` (round-half-to-even + saturate, identical
    to ``clip(rint(x), 0, 255)`` for the non-negative pixels this
    pipeline produces) — cv2 releases the GIL, unlike a main-loop
    ``np.rint`` over the stacked batch, which on a small host steals the
    core from the decode workers.
    """

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int):
        image, label = self.dataset[index]
        if image.dtype != np.uint8:
            # convertScaleAbs takes |x| before saturating, which would
            # silently flip negatives (e.g. a Normalize accidentally left
            # in the chain) to positive magnitudes — fail loudly instead.
            lo = image.min()
            if lo < 0:
                raise ValueError(
                    f"Uint8Wire expects raw [0,255] pixels, got min {lo}: "
                    "is Normalize still in the transform chain?"
                )
            image = _cv2().convertScaleAbs(image)
        return image, label
