"""PSPNet: dilated ResNet + Pyramid Pooling Module + segmentation heads.

Port of ``semseg_tpu/models/pspnet.py`` (reference ``model/pspnet.py``):
- PPM: adaptive average pooling to bins (1,2,3,6), 1x1 ConvBN(2048->512)
  per bin, align-corners upsample back, concat -> 4096 channels;
- ``cls`` head: 3x3 ConvBN(->512) + Dropout2d(0.1) + 1x1 conv to classes;
  ``aux`` head from layer3 (1024->256->classes), run in train mode only
  but present so that reference state_dicts load strictly;
- input constraint ``(H-1) % 8 == 0``; logits upsampled to
  ``(H-1)/8*zoom_factor+1`` and returned float32.

``forward(x, zoom=False)`` returns the logits at feature resolution from
the same weights; the fused stitch kernel does the zoom upsample itself.

Under tensor parallelism (``parallel/tensor.py``; ``tp`` set by
``build_model``) each PPM branch's conv and BN and the heads' 3x3 conv and
BN run on the rank's output channels; each is gathered in the unsharded
channel order before the concat or the dropout, and the logits conv stays
replicated.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from semseg_torch.models.layers import (
    Conv2d,
    ConvBN,
    Dropout2d,
    torch_default_conv_init_,
)
from semseg_torch.models.resnet import SEG_DILATIONS, SEG_STRIDES, ResNet
from semseg_torch.ops.pool import AdaptiveAvgPool2d
from semseg_torch.parallel.tensor import column_parallel
from semseg_torch.ops.resize import resize_bilinear_align_corners_cf


class PPM(nn.Module):
    """Pyramid Pooling Module; branch ``i`` is ``features.{i}`` =
    (pool, conv, bn, relu)."""

    tp = None

    def __init__(self, in_dim: int, reduction_dim: int, bins: Sequence[int]):
        super().__init__()
        self.features = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool2d(b), *ConvBN(in_dim, reduction_dim, 1))
            for b in bins
        )

    def forward(self, x):
        size = x.shape[-2:]
        out = [x] + [resize_bilinear_align_corners_cf(
            column_parallel(f[0](x), self.tp, *f[1:]), size) for f in self.features]
        return torch.cat(out, 1)


class SegHead(nn.Sequential):
    """``Sequential(conv, bn, relu, dropout, conv)``, the reference's
    ``cls``/``aux`` naming."""

    tp = None

    def forward(self, x):
        conv, bn, relu, dropout, logits = self
        return logits(dropout(column_parallel(x, self.tp, conv, bn, relu)))


def seg_head(in_dim: int, mid: int, classes: int, dropout: float):
    return SegHead(
        *ConvBN(in_dim, mid, 3, padding=1),
        Dropout2d(p=dropout),
        Conv2d(mid, classes, 1),
    )


class PSPNet(ResNet):
    def __init__(self, layers: int = 50, bins=(1, 2, 3, 6), dropout: float = 0.1,
                 classes: int = 2, zoom_factor: int = 8, use_ppm: bool = True,
                 dtype: torch.dtype = torch.float32):
        if layers not in (50, 101, 152):
            raise ValueError(f"layers={layers} not in (50, 101, 152)")
        if 2048 % len(bins) != 0:
            raise ValueError(f"2048 not divisible by {len(bins)} bins")
        if classes <= 1:
            raise ValueError("classes must be > 1")
        if zoom_factor not in (1, 2, 4, 8):
            raise ValueError(f"zoom_factor={zoom_factor} not in (1,2,4,8)")
        super().__init__(depth=layers, stage_strides=SEG_STRIDES,
                         stage_dilations=SEG_DILATIONS, dtype=dtype)
        self.classes = classes
        self.zoom_factor = zoom_factor
        self.use_ppm = use_ppm
        fea_dim = 2048
        if use_ppm:
            self.ppm = PPM(fea_dim, fea_dim // len(bins), bins)
            fea_dim *= 2
        self.cls = seg_head(fea_dim, 512, classes, dropout)
        self.aux = seg_head(1024, 256, classes, dropout)

    def init_weights(self, generator: torch.Generator):
        """Backbone: kaiming fan_out; PPM and heads: PyTorch's default
        conv init (reference ``model/pspnet.py:15-78`` builds them outside
        ``ResNet.__init__``)."""
        super().init_weights(generator)
        heads = [self.cls, self.aux] + ([self.ppm] if self.use_ppm else [])
        for head in heads:
            for m in head.modules():
                if isinstance(m, nn.Conv2d):
                    torch_default_conv_init_(m, generator)

    def forward(self, x, zoom: bool = True):
        return segment(self, x, zoom, self.ppm if self.use_ppm else None)


def seg_out_hw(model: ResNet, h_in: int, w_in: int):
    """The zoomed logits' ``(h, w)`` for a ``h_in x w_in`` input, which
    must satisfy ``(H-1) % 8 == 0`` and ``(W-1) % 8 == 0``."""
    if (h_in - 1) % 8 or (w_in - 1) % 8:
        raise ValueError(f"(H-1) and (W-1) must be multiples of 8, got {(h_in, w_in)}")
    return ((h_in - 1) // 8 * model.zoom_factor + 1, (w_in - 1) // 8 * model.zoom_factor + 1)


def segment(model: ResNet, x, zoom: bool, context):
    """The forward shared by PSPNet and PSANet: backbone, ``context`` module
    on layer4 (PPM or PSA; ``None`` = identity), ``cls`` head, optional
    zoom upsample, float32 logits; in train mode also the ``aux`` head on
    layer3."""
    out_hw = seg_out_hw(model, x.shape[-2], x.shape[-1])
    resize = zoom and model.zoom_factor != 1

    _, _, c3, c4 = model.features(x)
    feat = c4 if context is None else context(c4)
    logits = model.cls(feat)
    if resize:
        logits = resize_bilinear_align_corners_cf(logits, out_hw)
    logits = logits.float()
    if model.training:
        aux = model.aux(c3)
        if resize:
            aux = resize_bilinear_align_corners_cf(aux, out_hw)
        return logits, aux.float()
    return logits
