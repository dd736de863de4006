"""Separable bilinear resizes as two float32 matrix products.

Port of ``semseg_tpu/ops/resize.py``. The same ``[out, in]`` interpolation
matrices are built with numpy (align-corners for logits and PPM features,
reference ``model/pspnet.py:25,95``; the cv2 INTER_LINEAR half-pixel grid
for images and probability maps) and applied rows first, then columns:
``out = M_h @ x @ M_w^T`` over the last two axes of ``[..., H, W]``. Every
row of a matrix has at most two non-zero weights, so each output value is
the same two-term weighted sum as in the JAX package.

``F.interpolate(align_corners=False)`` is not used for the half-pixel grid:
its source coordinates are not clipped to ``[0, in-1]`` the way
``_interp_matrix_half_pixel`` clips them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from semseg_torch.utils.misc import CACHE_ENTRIES, tensor_cache


@functools.lru_cache(maxsize=CACHE_ENTRIES)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] row-stochastic align-corners interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 or in_size == 1:
        # align_corners with a single output (or input) sample: coordinate 0.
        m[:, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    coords = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (coords - lo).astype(np.float32)
    rows = np.arange(out_size)
    m[rows, lo] += 1.0 - frac
    m[rows, hi] += frac
    return m


@functools.lru_cache(maxsize=CACHE_ENTRIES)
def _interp_matrix_half_pixel(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] half-pixel-centers bilinear matrix (cv2 INTER_LINEAR grid):
    ``src = (dst + 0.5) * in/out - 0.5`` with edge clamping."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (coords - lo).astype(np.float32)
    rows = np.arange(out_size)
    m[rows, lo] += 1.0 - frac
    m[rows, hi] += frac
    return m


@tensor_cache
def interp_matrix(in_size: int, out_size: int, half_pixel: bool,
                  device: torch.device) -> torch.Tensor:
    """The ``[out, in]`` float32 matrix as a tensor on ``device``, built
    once per (sizes, grid, device) outside inference mode, and anew for
    each use while a program is traced (``utils.misc.tensor_cache``: the
    last ``CACHE_ENTRIES`` keys used are kept)."""
    m = (_interp_matrix_half_pixel if half_pixel else _interp_matrix)(
        in_size, out_size
    )
    return torch.from_numpy(m).to(device)


def _resize_cf(x: torch.Tensor, size, half_pixel: bool) -> torch.Tensor:
    out_h, out_w = int(size[0]), int(size[1])
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x
    mh = interp_matrix(h, out_h, half_pixel, x.device)
    mw = interp_matrix(w, out_w, half_pixel, x.device)
    # float32 accumulation whatever the source dtype, then back to it
    # (the JAX package promotes to float32 the same way).
    y = torch.matmul(mh, x.float())
    y = torch.matmul(y, mw.t())
    return y.to(x.dtype)


def resize_bilinear_align_corners_cf(x: torch.Tensor, size) -> torch.Tensor:
    """Align-corners bilinear resize of channels-first ``[..., H, W]``
    input to ``size=(out_h, out_w)``; equals ``F.interpolate(x, size,
    mode='bilinear', align_corners=True)``."""
    return _resize_cf(x, size, half_pixel=False)


def resize_bilinear_half_pixel_cf(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel-centers bilinear resize of ``[..., H, W]`` input: the
    cv2 ``INTER_LINEAR`` grid (modulo cv2's 11-bit fixed-point weights)."""
    return _resize_cf(x, size, half_pixel=True)
