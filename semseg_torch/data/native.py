"""Native (C++/OpenCV) host data pipeline of the port: a copy of
``semseg_tpu/data/native.py`` that builds its own extension.

``NativeSemData`` stands in for ``SemData`` + the train-time ``Compose``
(RandScale, RandRotate, RandomGaussianBlur, RandomHorizontalFlip, Crop,
ToTensor, Normalize; reference ``tool/train.py:194-201``) and runs decode
and all pixel work in the unchanged ``csrc/hostpipe.cpp``: one GIL-free
call per sample. The random parameters are drawn in Python from the same
per-(seed, epoch, sample) stream as the Python transforms
(``transform.per_sample_rng``), in the same order, so the two pipelines
give the same samples up to the decoders and OpenCV builds (exact but for
rotation, whose sub-pixel bins differ between OpenCV builds at ties; see
``tests/test_torch_native.py``).

The extension is compiled at first use (``available()`` or the first
``NativeSemData``) with ``g++`` against the Python, numpy and system
OpenCV C++ headers, into ``build/semseg_torch_host/`` at the repository
root; a sha256 stamp of the source and flags beside it skips the rebuild.
When it cannot be built (no compiler, headers or OpenCV libraries),
``available()`` is False and ``build_error()`` says why; the training
driver then warns and uses the Python pipeline.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from semseg_torch.data.dataset import make_dataset
from semseg_torch.data.transform import _default_rng

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "csrc" / "hostpipe.cpp"
BUILD_DIR = _REPO / "build" / "semseg_torch_host"
OPENCV_INCLUDE = "/usr/include/opencv4"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden")
LIBS = ("-lopencv_imgcodecs", "-lopencv_imgproc", "-lopencv_core")


def _command(out: Path):
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++/c++) on PATH")
    if not os.path.isdir(OPENCV_INCLUDE):
        raise RuntimeError(f"no system OpenCV C++ headers at {OPENCV_INCLUDE}")
    return [cxx, *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
            f"-I{np.get_include()}", f"-I{OPENCV_INCLUDE}", str(SOURCE), "-o", str(out), *LIBS]


def build_extension() -> Path:
    """Compile ``csrc/hostpipe.cpp`` into ``build/semseg_torch_host/``
    unless a build of the same source and flags is there; the path."""
    lib = BUILD_DIR / ("_hostpipe" + sysconfig.get_config_var("EXT_SUFFIX"))
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        _command(lib)[1:]).encode()).hexdigest()
    stamp = lib.with_name(lib.name + ".sha256")
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    proc = subprocess.run(_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) for {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


@functools.lru_cache(maxsize=None)
def _load():
    """``(module, None)`` or ``(None, error text)``; built at first call."""
    try:
        path = build_extension()
        loader = importlib.machinery.ExtensionFileLoader("_hostpipe", str(path))
        spec = importlib.util.spec_from_file_location("_hostpipe", str(path), loader=loader)
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
        return module, None
    except Exception as exc:  # reported by build_error()
        return None, f"{type(exc).__name__}: {exc}"


def available() -> bool:
    """Whether the extension is built (building it if needed) and loads."""
    return _load()[0] is not None


def build_error() -> Optional[str]:
    """Why the extension is not available, or None."""
    return _load()[1]


def _cv_round(x: float) -> int:
    """cvRound: round half to even (OpenCV's saturate_cast<int>(double))."""
    return int(np.rint(np.float64(x)))


class NativeSemData:
    """Map-style dataset emitting augmented (image f32 HWC, label i64 HW)
    crops through the native pipeline."""

    def __init__(
        self,
        split: str,
        data_root: Optional[str],
        data_list: Optional[str],
        *,
        crop_h: int,
        crop_w: int,
        mean: Sequence[float],
        std: Optional[Sequence[float]],
        ignore_label: int = 255,
        crop_type: str = "rand",
        scale: Optional[Sequence[float]] = (0.5, 2.0),
        rotate: Optional[Sequence[float]] = (-10.0, 10.0),
        blur_p: float = 0.5,
        flip_p: float = 0.5,
        rotate_p: float = 0.5,
        normalize: bool = True,
        rng=None,
    ):
        module, error = _load()
        if module is None:
            raise RuntimeError(f"native host pipeline not available: {error}")
        if crop_type not in ("rand", "center"):
            raise ValueError(crop_type)
        self._hostpipe = module
        self.split = split
        self.data_list = make_dataset(split, data_root, data_list)
        self.crop_h, self.crop_w = int(crop_h), int(crop_w)
        self.mean = [float(m) for m in mean]
        self.std = None if std is None else [float(s) for s in std]
        self.ignore_label = int(ignore_label)
        self.crop_type = crop_type
        self.scale = None if scale is None else tuple(scale)
        self.rotate = None if rotate is None else tuple(rotate)
        self.blur_p = blur_p
        self.flip_p = flip_p
        self.rotate_p = rotate_p
        # normalize=False emits raw 0-255 float pixels (the uint8 wire with
        # on-device normalisation); mean still fills rotation and crop
        # padding, as the reference's mean-padded borders.
        self.normalize = bool(normalize)
        self.rng = rng or _default_rng

    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, index: int):
        image_path, label_path = self.data_list[index]
        img, lab = self._hostpipe.read_pair(image_path, label_path)
        if img.shape[:2] != lab.shape[:2]:
            raise RuntimeError(f"Image & label shape mismatch: {image_path} {label_path}")
        h, w = lab.shape
        rng = self.rng

        # Parameter draws: the order and arithmetic of the Python transforms
        # (transform.py RandScale/RandRotate/Blur/HFlip/Crop), so the
        # (seed, epoch, index) stream gives the same batches.
        fx = fy = 0.0
        if self.scale is not None:
            s = self.scale[0] + (self.scale[1] - self.scale[0]) * rng.random()
            fx = fy = s
            # cv::resize(fx, fy) output dims (cvRound), for the crop draws
            h, w = _cv_round(h * s), _cv_round(w * s)
        has_rotate, angle = 0, 0.0
        if self.rotate is not None and rng.random() < self.rotate_p:
            has_rotate = 1
            angle = self.rotate[0] + (self.rotate[1] - self.rotate[0]) * rng.random()
        blur = 1 if (self.blur_p > 0 and rng.random() < self.blur_p) else 0
        flip = 1 if (self.flip_p > 0 and rng.random() < self.flip_p) else 0

        pad_h = max(self.crop_h - h, 0)
        pad_w = max(self.crop_w - w, 0)
        ph, pw = h + pad_h, w + pad_w
        if self.crop_type == "rand":
            h_off = rng.randint(0, ph - self.crop_h)
            w_off = rng.randint(0, pw - self.crop_w)
        else:
            h_off = (ph - self.crop_h) // 2
            w_off = (pw - self.crop_w) // 2

        std = self.std or [1.0, 1.0, 1.0]
        norm_mean = self.mean if self.normalize else [0.0, 0.0, 0.0]
        has_std = 1 if (self.normalize and self.std is not None) else 0
        return self._hostpipe.augment(
            img, lab, fx, fy, has_rotate, angle, blur, flip,
            self.crop_h, self.crop_w, h_off, w_off,
            self.mean[0], self.mean[1], self.mean[2], self.ignore_label,
            norm_mean[0], norm_mean[1], norm_mean[2],
            std[0], std[1], std[2], has_std,
        )
