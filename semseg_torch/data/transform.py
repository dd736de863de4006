"""Paired (image, label) augmentation transforms, cv2/numpy (a copy of
``semseg_tpu/data/transform.py``; cv2 is imported at first use, so the
module imports without it).

Numerics-compatible with the reference pipeline (``util/transform.py``):
cv2 INTER_LINEAR for images / INTER_NEAREST for labels, mean-valued border
fill for images and ignore-label fill for labels, normalization in 0-255
scale. Outputs stay numpy (HWC float32 image, HW int64 label) — device
transfer happens in the loader/engine, not per-sample.

Randomness: by default transforms draw from a context-local RNG when one
is active (see ``per_sample_rng`` — the loader seeds one per (seed, epoch,
sample) so augmentation is deterministic regardless of worker count or
thread scheduling, fixing the reference's unwired ``worker_init_fn``,
reference ``tool/train.py:50-51``), falling back to Python's global
``random`` module otherwise. Pass ``rng`` explicitly for isolated streams.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
import numbers
import random as _random
from typing import Iterable, Optional, Sequence

import numpy as np

_context_rng: contextvars.ContextVar = contextvars.ContextVar(
    "semseg_transform_rng", default=None
)


@contextlib.contextmanager
def per_sample_rng(seed: int, epoch: int, index: int):
    """Activate a deterministic RNG for the transforms in this context.

    The stream depends only on (seed, epoch, index) — identical batches
    for any worker count or scheduling order.
    """
    rng = _random.Random((seed * 1_000_003 + epoch) * 1_000_003 + index)
    token = _context_rng.set(rng)
    try:
        yield rng
    finally:
        _context_rng.reset(token)


class _RngProxy:
    """Resolves to the context RNG if active, else the global module."""

    def random(self):
        rng = _context_rng.get()
        return (rng or _random).random()

    def randint(self, a, b):
        rng = _context_rng.get()
        return (rng or _random).randint(a, b)


_default_rng = _RngProxy()


@functools.lru_cache(maxsize=None)
def _cv2():
    """cv2, imported and set up (no internal threads, no OpenCL) once."""
    import cv2

    cv2.setNumThreads(0)
    try:
        cv2.ocl.setUseOpenCL(False)
    except AttributeError:  # pragma: no cover
        pass
    return cv2


class Compose:
    def __init__(self, segtransforms: Sequence):
        self.segtransforms = list(segtransforms)

    def __call__(self, image, label):
        for t in self.segtransforms:
            image, label = t(image, label)
        return image, label


class ToArray:
    """Validate and emit (HWC float32 image, HW int64 label) numpy arrays.

    The NHWC analog of the reference ``ToTensor`` (``util/transform.py:22``)
    — no axis transpose: NHWC is the native device layout here.
    """

    def __call__(self, image, label):
        if not isinstance(image, np.ndarray) or not isinstance(label, np.ndarray):
            raise TypeError("ToArray expects numpy arrays (cv2-read images)")
        if image.ndim == 2:
            image = image[:, :, None]
        if image.ndim != 3:
            raise ValueError(f"image must be HW or HWC, got {image.shape}")
        if label.ndim != 2:
            raise ValueError(f"label must be HW, got {label.shape}")
        return image.astype(np.float32), label.astype(np.int64)


# The reference drivers construct ``transform.ToTensor()``; keep the name.
ToTensor = ToArray


class Normalize:
    """(channel - mean) / std, in the image's native 0-255 scale."""

    def __init__(self, mean, std=None):
        if std is not None and len(mean) != len(std):
            raise ValueError("mean/std length mismatch")
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = None if std is None else np.asarray(std, dtype=np.float32)

    def __call__(self, image, label):
        image = image - self.mean
        if self.std is not None:
            image = image / self.std
        return image, label


class Resize:
    """Resize to (h, w): bilinear image, nearest label."""

    def __init__(self, size):
        if not (isinstance(size, Iterable) and len(tuple(size)) == 2):
            raise ValueError("size must be (h, w)")
        self.size = tuple(size)

    def __call__(self, image, label):
        cv2 = _cv2()
        image = cv2.resize(
            image, self.size[::-1], interpolation=cv2.INTER_LINEAR
        )
        label = cv2.resize(
            label, self.size[::-1], interpolation=cv2.INTER_NEAREST
        )
        return image, label


class RandScale:
    """Random scale in [scale_min, scale_max], optional aspect jitter."""

    def __init__(self, scale, aspect_ratio=None, rng=None):
        scale = tuple(scale)
        if not (
            len(scale) == 2
            and all(isinstance(s, numbers.Number) for s in scale)
            and 0 < scale[0] < scale[1]
        ):
            raise ValueError(f"bad scale range {scale}")
        self.scale = scale
        if aspect_ratio is not None:
            aspect_ratio = tuple(aspect_ratio)
            if not (
                len(aspect_ratio) == 2
                and all(isinstance(a, numbers.Number) for a in aspect_ratio)
                and 0 < aspect_ratio[0] < aspect_ratio[1]
            ):
                raise ValueError(f"bad aspect_ratio range {aspect_ratio}")
        self.aspect_ratio = aspect_ratio
        self.rng = rng or _default_rng

    def __call__(self, image, label):
        cv2 = _cv2()
        scale = self.scale[0] + (self.scale[1] - self.scale[0]) * self.rng.random()
        aspect = 1.0
        if self.aspect_ratio is not None:
            aspect = self.aspect_ratio[0] + (
                self.aspect_ratio[1] - self.aspect_ratio[0]
            ) * self.rng.random()
            aspect = math.sqrt(aspect)
        fx, fy = scale * aspect, scale / aspect
        image = cv2.resize(
            image, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR
        )
        label = cv2.resize(
            label, None, fx=fx, fy=fy, interpolation=cv2.INTER_NEAREST
        )
        return image, label


class Crop:
    """Random or center crop to (h, w); pads smaller inputs first
    (image: mean padding, label: ignore_label padding)."""

    def __init__(self, size, crop_type="center", padding=None, ignore_label=255, rng=None):
        if isinstance(size, int):
            self.crop_h = self.crop_w = size
        else:
            size = tuple(size)
            if not (
                len(size) == 2
                and all(isinstance(s, int) and s > 0 for s in size)
            ):
                raise ValueError(f"bad crop size {size}")
            self.crop_h, self.crop_w = size
        if crop_type not in ("center", "rand"):
            raise ValueError("crop_type must be 'rand' or 'center'")
        self.crop_type = crop_type
        if padding is not None:
            padding = list(padding)
            if len(padding) != 3 or not all(
                isinstance(p, numbers.Number) for p in padding
            ):
                raise ValueError("padding must be a 3-number list")
        self.padding = padding
        if not isinstance(ignore_label, int):
            raise ValueError("ignore_label must be an int")
        self.ignore_label = ignore_label
        self.rng = rng or _default_rng

    def __call__(self, image, label):
        cv2 = _cv2()
        h, w = label.shape
        pad_h = max(self.crop_h - h, 0)
        pad_w = max(self.crop_w - w, 0)
        if pad_h > 0 or pad_w > 0:
            if self.padding is None:
                raise RuntimeError("Crop needs padding for small inputs")
            top, left = pad_h // 2, pad_w // 2
            image = cv2.copyMakeBorder(
                image, top, pad_h - top, left, pad_w - left,
                cv2.BORDER_CONSTANT, value=self.padding,
            )
            label = cv2.copyMakeBorder(
                label, top, pad_h - top, left, pad_w - left,
                cv2.BORDER_CONSTANT, value=self.ignore_label,
            )
        h, w = label.shape
        if self.crop_type == "rand":
            h_off = self.rng.randint(0, h - self.crop_h)
            w_off = self.rng.randint(0, w - self.crop_w)
        else:
            h_off = (h - self.crop_h) // 2
            w_off = (w - self.crop_w) // 2
        image = image[h_off : h_off + self.crop_h, w_off : w_off + self.crop_w]
        label = label[h_off : h_off + self.crop_h, w_off : w_off + self.crop_w]
        return image, label


class RandRotate:
    """Rotate by a uniform angle in [min, max] with probability p."""

    def __init__(self, rotate, padding, ignore_label=255, p=0.5, rng=None):
        rotate = tuple(rotate)
        if not (len(rotate) == 2 and rotate[0] < rotate[1]):
            raise ValueError(f"bad rotate range {rotate}")
        self.rotate = rotate
        if padding is None or len(list(padding)) != 3:
            raise ValueError("padding must be a 3-number list")
        self.padding = list(padding)
        self.ignore_label = ignore_label
        self.p = p
        self.rng = rng or _default_rng

    def __call__(self, image, label):
        cv2 = _cv2()
        if self.rng.random() < self.p:
            angle = self.rotate[0] + (
                self.rotate[1] - self.rotate[0]
            ) * self.rng.random()
            h, w = label.shape
            matrix = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1)
            image = cv2.warpAffine(
                image, matrix, (w, h), flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_CONSTANT, borderValue=self.padding,
            )
            label = cv2.warpAffine(
                label, matrix, (w, h), flags=cv2.INTER_NEAREST,
                borderMode=cv2.BORDER_CONSTANT, borderValue=self.ignore_label,
            )
        return image, label


class RandomHorizontalFlip:
    def __init__(self, p=0.5, rng=None):
        self.p = p
        self.rng = rng or _default_rng

    def __call__(self, image, label):
        cv2 = _cv2()
        if self.rng.random() < self.p:
            image = cv2.flip(image, 1)
            label = cv2.flip(label, 1)
        return image, label


class RandomVerticalFlip:
    def __init__(self, p=0.5, rng=None):
        self.p = p
        self.rng = rng or _default_rng

    def __call__(self, image, label):
        cv2 = _cv2()
        if self.rng.random() < self.p:
            image = cv2.flip(image, 0)
            label = cv2.flip(label, 0)
        return image, label


class RandomGaussianBlur:
    def __init__(self, radius=5, p=0.5, rng=None):
        self.radius = radius
        self.p = p
        self.rng = rng or _default_rng

    def __call__(self, image, label):
        cv2 = _cv2()
        if self.rng.random() < self.p:
            image = cv2.GaussianBlur(image, (self.radius, self.radius), 0)
        return image, label


class RGB2BGR:
    def __call__(self, image, label):
        cv2 = _cv2()
        return cv2.cvtColor(image, cv2.COLOR_RGB2BGR), label


class BGR2RGB:
    def __call__(self, image, label):
        cv2 = _cv2()
        return cv2.cvtColor(image, cv2.COLOR_BGR2RGB), label
