"""PSANet: dilated ResNet + Point-wise Spatial Attention + seg heads.

Port of ``semseg_tpu/models/psanet.py`` (reference ``model/psanet.py``),
channels-first. The PSA module, per direction:
- 1x1 ConvBN reduce 2048->512 (``psa.reduce`` / ``psa.reduce_p``);
- optional spatial shrink to ``(h-1)//shrink+1`` (align-corners bilinear);
- attention: 1x1 ConvBN(512) + ReLU + 1x1 conv (no bias) to
  ``mask_h*mask_w`` relative logits (``psa.attention.{0,1,3}``);
- relative->absolute expansion (``ops/psamask.py``, the skew) or the
  ``compact`` pure-reshape path;
- softmax over source positions and the aggregation
  ``out[c, j] = (1/norm) * sum_i x[c, i] * A[i, j]``: the CUDA kernels of
  ``ops/psa.py`` on CUDA tensors, a plain float32 softmax + bmm elsewhere;
- bi-direction runs collect + distribute and concatenates; 1x1 ConvBN proj
  back to 2048, unshrink, concat with the module input -> 4096 channels.

``forward(x, zoom=False)`` returns the logits at feature resolution from
the same weights; the fused stitch kernel does the zoom upsample itself.
``remat`` goes to the backbone (``models/resnet.py``): the PSA module
(its kernels launch once a direction and step) and the heads' dropout are
not checkpointed.

Under tensor parallelism (``parallel/tensor.py``; ``tp`` set by
``build_model``) a direction runs its aggregation on the rank's channel
shard: ``reduce`` keeps the rank's output channels, shrunk per channel;
their gather feeds the attention head, whose two convs are sharded and
gathered in turn (the logits conv's ``mask_h * mask_w`` channels unevenly
when that count is odd); then the kernel runs on the rank's channels of x
with the full A behind ``copy_to_tp``. That is exact: the forward is
independent per channel, and the gradient of A, ``p * (x^T g / norm -
sum_c g * out)``, is a sum over channels that ``copy_to_tp``'s all-reduce
completes. The two directions' shards are gathered and concatenated in the
unsharded order, ``proj`` is sharded and gathered before the unshrink.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from semseg_torch.models.layers import Conv2d, ConvBN, torch_default_conv_init_
from semseg_torch.models.pspnet import seg_head, segment
from semseg_torch.models.resnet import SEG_DILATIONS, SEG_STRIDES, ResNet
from semseg_torch.ops.psa import psa_softmax_bmm_auto
from semseg_torch.ops.psamask import (
    BI_DIRECTION,
    COLLECT,
    DISTRIBUTE,
    psa_attention_matrix_cf,
)
from semseg_torch.ops.resize import resize_bilinear_align_corners_cf
from semseg_torch.parallel.tensor import (
    column_parallel,
    copy_to_tp,
    gather_from_tp,
    sharded,
)


def use_fused_attention(fused_attention: Optional[bool], device) -> bool:
    """Resolve the fused-kernel choice for one attention branch:
    True/False force; None = auto, the CUDA kernels for CUDA tensors and
    the plain version on the CPU. Which kernel runs (resident or flash) is
    chosen per shape by ``ops/psa.select_psa_kernel``."""
    if fused_attention is not None:
        return bool(fused_attention)
    return torch.device(device).type == "cuda"


def _attention_head(mid: int, mask_hw: int) -> nn.Sequential:
    """``Sequential(conv, bn, relu, conv)``: the reference's
    ``attention``/``attention_p`` naming, ``.3`` the logits conv."""
    return nn.Sequential(*ConvBN(mid, mid, 1), Conv2d(mid, mask_hw, 1, bias=False))


class PSA(nn.Module):
    tp = None

    def __init__(self, in_channels: int = 2048, mid_channels: int = 512,
                 psa_type: int = BI_DIRECTION, compact: bool = False,
                 shrink_factor: int = 2, mask_h: int = 59, mask_w: int = 59,
                 normalization_factor: float = 1.0, psa_softmax: bool = True,
                 fused_attention: Optional[bool] = None):
        super().__init__()
        if psa_type not in (COLLECT, DISTRIBUTE, BI_DIRECTION):
            raise ValueError(f"psa_type must be 0, 1 or 2, got {psa_type}")
        self.psa_type = psa_type
        self.compact = compact
        self.shrink_factor = shrink_factor
        self.mask_h, self.mask_w = mask_h, mask_w
        self.normalization_factor = normalization_factor
        self.psa_softmax = psa_softmax
        self.fused_attention = fused_attention
        self.reduce = nn.Sequential(*ConvBN(in_channels, mid_channels, 1))
        self.attention = _attention_head(mid_channels, mask_h * mask_w)
        if psa_type == BI_DIRECTION:
            self.reduce_p = nn.Sequential(*ConvBN(in_channels, mid_channels, 1))
            self.attention_p = _attention_head(mid_channels, mask_h * mask_w)
        n_branch = 2 if psa_type == BI_DIRECTION else 1
        self.proj = nn.Sequential(*ConvBN(mid_channels * n_branch, in_channels, 1))

    def _branch(self, x, psa_type: int, reduce: nn.Module, attention: nn.Module):
        """One attention direction: reduce, shrink, attend, aggregate. The
        result holds the channels of the rank's shard of ``reduce`` (all of
        them without TP)."""
        tp = self.tp if sharded(reduce[0]) else None  # reduce's channels split over tp
        xr = reduce(copy_to_tp(x, tp))
        n, c, h, w = xr.shape
        if self.shrink_factor != 1:
            h = (h - 1) // self.shrink_factor + 1
            w = (w - 1) // self.shrink_factor + 1
            xr = resize_bilinear_align_corners_cf(xr, (h, w))
        y = gather_from_tp(xr, tp, reduce[0].out_channels)
        y = column_parallel(column_parallel(y, self.tp, *attention[:3]), self.tp, attention[3])
        hw = h * w
        if self.compact:
            # Channels index absolute positions (reference
            # model/psanet.py:63-66,82-83). The channels-first view is
            # [n, channel, position], the transpose of the JAX package's
            # NHWC reshape, so here DISTRIBUTE transposes.
            a = y.reshape(n, hw, hw)
            if psa_type == DISTRIBUTE:
                a = a.transpose(1, 2)
        else:
            a = psa_attention_matrix_cf(y, psa_type, self.mask_h, self.mask_w)
        del y  # free the logits before the aggregation (2 GB at shrink 1 in f32)
        a = copy_to_tp(a, tp)  # its gradient sums over the channels of every rank
        x_flat = xr.reshape(n, c, hw)
        if self.psa_softmax and use_fused_attention(self.fused_attention, x.device):
            # A stays in the compute dtype: its values come from the
            # attention conv through data movement only. The operand dtype
            # picks the precision, as the JAX kernel's _precision_for does:
            # f32 operands run f32 math throughout; bf16 operands run the
            # product on the tensor cores with p rounded to bf16 and f32
            # sums (one bf16 MXU pass on the TPU).
            agg = psa_softmax_bmm_auto(x_flat.contiguous(), a.contiguous(),
                                       self.normalization_factor)
        else:
            a = a.float()
            if self.psa_softmax:
                a = torch.softmax(a, dim=1)
            agg = torch.bmm(x_flat.float(), a) * (1.0 / self.normalization_factor)
        return agg.reshape(n, c, h, w).to(x.dtype), (h, w)

    def forward(self, x):
        tp = self.tp if sharded(self.reduce[0]) else None
        mid = self.reduce[0].out_channels
        if self.psa_type in (COLLECT, DISTRIBUTE):
            feat, (h, w) = self._branch(x, self.psa_type, self.reduce, self.attention)
            feat = gather_from_tp(feat, tp, mid)
        else:
            col, (h, w) = self._branch(x, COLLECT, self.reduce, self.attention)
            dis, _ = self._branch(x, DISTRIBUTE, self.reduce_p, self.attention_p)
            feat = torch.cat([gather_from_tp(col, tp, mid), gather_from_tp(dis, tp, mid)], 1)
        feat = column_parallel(feat, self.tp, *self.proj)
        if self.shrink_factor != 1:
            h = (h - 1) * self.shrink_factor + 1
            w = (w - 1) * self.shrink_factor + 1
            feat = resize_bilinear_align_corners_cf(feat, (h, w))
        return torch.cat([x, feat], 1)


class PSANet(ResNet):
    def __init__(self, layers: int = 50, dropout: float = 0.1, classes: int = 2,
                 zoom_factor: int = 8, use_psa: bool = True,
                 psa_type: int = BI_DIRECTION, compact: bool = False,
                 shrink_factor: int = 2, mask_h: int = 59, mask_w: int = 59,
                 normalization_factor: float = 1.0, psa_softmax: bool = True,
                 fused_attention: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        if layers not in (50, 101, 152):
            raise ValueError(f"layers={layers} not in (50, 101, 152)")
        if classes <= 1:
            raise ValueError("classes must be > 1")
        if zoom_factor not in (1, 2, 4, 8):
            raise ValueError(f"zoom_factor={zoom_factor} not in (1,2,4,8)")
        super().__init__(depth=layers, stage_strides=SEG_STRIDES,
                         stage_dilations=SEG_DILATIONS, dtype=dtype, remat=remat)
        self.classes = classes
        self.zoom_factor = zoom_factor
        self.use_psa = use_psa
        fea_dim = 2048
        if use_psa:
            self.psa = PSA(fea_dim, 512, psa_type, compact, shrink_factor,
                           mask_h, mask_w, normalization_factor, psa_softmax,
                           fused_attention)
            fea_dim *= 2
        self.cls = seg_head(fea_dim, 512, classes, dropout)
        self.aux = seg_head(1024, 256, classes, dropout)

    def init_weights(self, generator: torch.Generator):
        """Backbone: kaiming fan_out; PSA convs and heads: PyTorch's default
        conv init (JAX ``psanet.py:84-105``, ``torch_default_conv_init``)."""
        super().init_weights(generator)
        heads = [self.cls, self.aux] + ([self.psa] if self.use_psa else [])
        for head in heads:
            for m in head.modules():
                if isinstance(m, nn.Conv2d):
                    torch_default_conv_init_(m, generator)

    def forward(self, x, zoom: bool = True):
        return segment(self, x, zoom, self.psa if self.use_psa else None)
