"""Point-wise Spatial Attention mask expansion (relative -> absolute).

Port of ``semseg_tpu/ops/psamask.py``. Per position ``(h, w)`` the network
predicts a ``mask_h x mask_w`` grid of relative attention logits; they are
placed into a dense ``(H*W) x (H*W)`` matrix clipped at the image borders,
with unwritten entries exactly zero (the zeros take part in the softmax
that follows; reference ``lib/psa/src/cpu/psamask.cpp:11-113``).

The dense matrix is block-Toeplitz in the relative offset,
``A[(h2,w2),(h,w)] = rel[h, w, h2-h+half_h, w2-w+half_w]``, so it is built
with the *skew* trick (pad + reshape + slice) instead of a gather or a
scatter: every step is data movement, so a bf16 input stays bf16 and loses
nothing.

Modes (reference ``lib/psa/functions/psamask.py:8-25``):
- ``psa_type=0`` (COLLECT): ``buffer[n, src=(h2,w2), h, w] = rel@query (h,w)``
- ``psa_type=1`` (DISTRIBUTE): ``buffer[n, own=(h,w), h2, w2] = rel@query (h,w)``

``psa_attention_matrix`` and ``psa_mask`` take the JAX layout (NHWC ``y``)
so that tests compare like with like; the channels-first model calls
``psa_attention_matrix_cf``. All return the same ``A``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

COLLECT = 0
DISTRIBUTE = 1
BI_DIRECTION = 2


def _skew(x: torch.Tensor) -> torch.Tensor:
    """Relative -> absolute along the trailing axis pair.

    Input ``x[..., q, r]`` with ``r`` of size ``2Q-1`` holding relative
    offsets ``r - (Q-1) = k - q``; returns ``a[..., q, k]`` of size
    ``[..., Q, Q]`` with ``a[..., q, k] = x[..., q, k - q + Q - 1]``.
    """
    *batch, q, r = x.shape
    if r != 2 * q - 1:
        raise ValueError(f"skew needs r == 2q-1, got q={q}, r={r}")
    if q == 1:
        return x
    flat = x.reshape(*batch, q * (2 * q - 1))
    # a[q, k] = flat[(Q-1) + q*(2Q-2) + k]: drop the first Q-1 elements,
    # then rows of stride 2Q-2 put k in the leading columns.
    flat = flat[..., q - 1: q - 1 + q * (2 * q - 2)]
    return flat.reshape(*batch, q, 2 * q - 2)[..., :q]


def _pad_relative(rel: torch.Tensor, full_h: int, full_w: int) -> torch.Tensor:
    """Zero-pad ``rel[..., mask_h, mask_w]`` to ``[..., full_h, full_w]``,
    centred so that relative offset 0 stays in the middle (the reference
    clips the mask window at borders and leaves the rest zero,
    ``psamask.cpp:20-29``)."""
    *_, mask_h, mask_w = rel.shape
    if mask_h > full_h or mask_w > full_w:
        raise ValueError(
            f"mask ({mask_h}x{mask_w}) exceeds the full relative extent "
            f"({full_h}x{full_w}) for this feature size")
    if (mask_h, mask_w) == (full_h, full_w):
        return rel  # the recipes' default mask: no copy of the logits
    half_h, half_w = (mask_h - 1) // 2, (mask_w - 1) // 2
    pad_top = (full_h - 1) // 2 - half_h
    pad_left = (full_w - 1) // 2 - half_w
    return F.pad(rel, (pad_left, full_w - mask_w - pad_left,
                       pad_top, full_h - mask_h - pad_top))


def _relative_to_absolute(rel: torch.Tensor) -> torch.Tensor:
    """``rel[N, H, W, mask_h, mask_w]`` (any strides) -> ``T[N, H, W, H2,
    W2]`` with ``T[n, h, w, h2, w2] = rel[n, h, w, h2-h+half_h,
    w2-w+half_w]`` for in-range offsets and 0 elsewhere (a view of the
    last skew's output)."""
    n, h, w, mask_h, mask_w = rel.shape
    if mask_h % 2 != 1 or mask_w % 2 != 1:
        raise ValueError(f"mask dims must be odd, got {mask_h}x{mask_w}")
    rel = _pad_relative(rel, 2 * h - 1, 2 * w - 1)
    t = _skew(rel.permute(0, 1, 3, 2, 4))  # [N, H, dh, W, W2]
    t = _skew(t.permute(0, 3, 4, 1, 2))    # [N, W, W2, H, H2]
    return t.permute(0, 3, 1, 4, 2)        # [N, H, W, H2, W2]


def _attention(t: torch.Tensor, psa_type: int) -> torch.Tensor:
    n, h, w = t.shape[:3]
    if psa_type == COLLECT:
        t = t.permute(0, 3, 4, 1, 2)  # A[src=(h2,w2), query=(h,w)]
    elif psa_type != DISTRIBUTE:      # A[own=(h,w), target=(h2,w2)]
        raise ValueError(f"psa_type must be 0 or 1, got {psa_type}")
    return t.reshape(n, h * w, h * w)


def psa_attention_matrix(y: torch.Tensor, psa_type: int, mask_h: int,
                         mask_w: int) -> torch.Tensor:
    """Dense attention matrix ``A[N, HW, HW]`` in bmm orientation from NHWC
    ``y[N, H, W, mask_h*mask_w]``: the softmax runs over axis 1 and the
    aggregation contracts features against axis 1
    (``out[c, j] = sum_i x[c, i] * A[i, j]``)."""
    n, h, w, c = y.shape
    if c != mask_h * mask_w:
        raise ValueError(f"channels {c} != mask_h*mask_w {mask_h * mask_w}")
    rel = y.reshape(n, h, w, mask_h, mask_w)
    return _attention(_relative_to_absolute(rel), psa_type)


def psa_attention_matrix_cf(y: torch.Tensor, psa_type: int, mask_h: int,
                            mask_w: int) -> torch.Tensor:
    """``psa_attention_matrix`` for channels-first
    ``y[N, mask_h*mask_w, H, W]`` (the attention conv's output)."""
    n, c, h, w = y.shape
    if c != mask_h * mask_w:
        raise ValueError(f"channels {c} != mask_h*mask_w {mask_h * mask_w}")
    rel = y.view(n, mask_h, mask_w, h, w).permute(0, 3, 4, 1, 2)
    return _attention(_relative_to_absolute(rel), psa_type)


def psa_mask(y: torch.Tensor, psa_type: int, mask_h: int,
             mask_w: int) -> torch.Tensor:
    """Reference-layout buffer ``[N, H*W, H, W]`` (channels-first) from NHWC
    ``y``: the parity surface of ``lib.psa.functional.psa_mask``."""
    n, h, w, _ = y.shape
    return psa_attention_matrix(y, psa_type, mask_h, mask_w).reshape(n, h * w, h, w)


class PSAMask:
    """Callable wrapper (parity with the reference
    ``lib.psa.modules.PSAMask``); unset mask dims default to the full
    relative extent of the input."""

    def __init__(self, psa_type: int = COLLECT, mask_h: int | None = None,
                 mask_w: int | None = None):
        if psa_type not in (COLLECT, DISTRIBUTE):
            raise ValueError(f"psa_type must be 0 or 1, got {psa_type}")
        if (mask_h is None) != (mask_w is None):
            raise ValueError("mask_h and mask_w must both be set or unset")
        self.psa_type = psa_type
        self.mask_h = mask_h
        self.mask_w = mask_w

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        n, h, w, c = y.shape
        mask_h = self.mask_h if self.mask_h is not None else 2 * h - 1
        mask_w = self.mask_w if self.mask_w is not None else 2 * w - 1
        if c != mask_h * mask_w:
            raise ValueError(f"channels {c} != mask_h*mask_w {mask_h * mask_w}")
        return psa_mask(y, self.psa_type, mask_h, mask_w)
