"""Deep-base ResNet backbones (NCHW).

Port of ``semseg_tpu/models/resnet.py``:
- deep-base stem: three 3x3 convs (3->64 s2, 64->64, 64->128) + max pool
  instead of the single 7x7 conv (reference ``model/resnet.py:106-113``);
- BasicBlock (18/34) and Bottleneck (50/101/152) residual blocks, with
  the stride and dilation on the 3x3 conv;
- per-stage (stride, dilation); segmentation uses strides (1, 2, 1, 1)
  and dilations (1, 1, 2, 4), output stride 8 (reference
  ``model/pspnet.py:49-58``);
- kaiming fan_out init for convs, BN weight 1 and bias 0;
- ``remat``: each residual block of layer1..layer4 is recomputed in the
  backward pass (JAX ``nn.remat``, ``models/resnet.py:162-166``), trading
  one more backbone forward for the blocks' saved activations.

Submodules carry the reference state_dict names: ``layer0.{0,1,3,4,6,7}``
for the stem, ``layer{s}.{b}.conv{i}/bn{i}`` and ``downsample.{0,1}``;
:class:`ResNetClassifier` adds the ImageNet ``fc``.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from semseg_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    ConvBN,
    kaiming_normal_fan_out_,
    recomputing,
    torch_default_conv_init_,
)
from semseg_torch.ops.pool import max_pool2d


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(out + residual)


_ARCH = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}

SEG_STRIDES = (1, 2, 1, 1)
SEG_DILATIONS = (1, 1, 2, 4)


def _stage(block, inplanes, planes, blocks, stride, dilation):
    out = planes * block.expansion
    downsample = None
    if stride != 1 or inplanes != out:
        downsample = nn.Sequential(
            Conv2d(inplanes, out, 1, stride=stride, bias=False),
            BatchNorm2d(out),
        )
    return nn.Sequential(
        block(inplanes, planes, stride, dilation, downsample),
        *(block(out, planes, 1, dilation) for _ in range(1, blocks)),
    )


class ResNet(nn.Module):
    """ResNet backbone; ``forward`` returns the outputs of layer1..layer4.

    ``dtype`` is the compute dtype: the input is cast to it, parameters
    stay float32. Classification default: strides (1, 2, 2, 2), dilations
    (1, 1, 1, 1); segmentation passes ``SEG_STRIDES``/``SEG_DILATIONS``.

    With ``remat``, a train-mode forward under grad runs each residual
    block of layer1..layer4 through a non-reentrant checkpoint: only the
    block's input is kept, and the block runs again in the backward pass
    under ``layers.recomputing`` (BatchNorm takes the same moments and
    tracks nothing), so the step is the one without ``remat``, bit for bit.
    The stem, the max pool and everything after layer4 are not
    checkpointed; eval, ``no_grad`` and ``inference_mode`` run as without.
    """

    def __init__(self, depth: int = 50, deep_base: bool = True,
                 stage_strides: Tuple[int, ...] = (1, 2, 2, 2),
                 stage_dilations: Tuple[int, ...] = (1, 1, 1, 1),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        block, counts = _ARCH[depth]
        self.dtype = dtype
        self.remat = remat
        if deep_base:
            self.layer0 = nn.Sequential(
                *ConvBN(3, 64, 3, stride=2, padding=1),
                *ConvBN(64, 64, 3, padding=1),
                *ConvBN(64, 128, 3, padding=1),
            )
        else:
            self.layer0 = nn.Sequential(*ConvBN(3, 64, 7, stride=2, padding=3))
        inplanes = 128 if deep_base else 64
        for s, (planes, blocks) in enumerate(zip((64, 128, 256, 512), counts)):
            setattr(self, f"layer{s + 1}", _stage(
                block, inplanes, planes, blocks, stage_strides[s],
                stage_dilations[s],
            ))
            inplanes = planes * block.expansion

    def init_weights(self, generator: torch.Generator):
        """Kaiming fan_out normal for every backbone conv (reference
        ``model/resnet.py:123-128``); BN keeps weight 1, bias 0."""
        for layer in (self.layer0, self.layer1, self.layer2, self.layer3,
                      self.layer4):
            for m in layer.modules():
                if isinstance(m, nn.Conv2d):
                    kaiming_normal_fan_out_(m.weight, generator)

    def features(self, x):
        x = max_pool2d(self.layer0(x.to(self.dtype)), 3, 2, 1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        out = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            if remat:
                for block in layer:
                    # The blocks hold no randomness: no RNG state to keep.
                    x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                                   context_fn=_remat_contexts)
            else:
                x = layer(x)
            out.append(x)
        return tuple(out)

    def forward(self, x):
        return self.features(x)


def _remat_contexts():
    """``checkpoint``'s ``context_fn``: nothing around the forward, and
    ``recomputing`` around the recompute."""
    return contextlib.nullcontext(), recomputing()


class ResNetClassifier(ResNet):
    """ImageNet-style classifier (JAX ``models/resnet.py:173-196``): the
    backbone at the classification strides, a float32 mean over H and W of
    layer4, and ``fc`` in the compute dtype; float32 logits ``[N,
    num_classes]``."""

    def __init__(self, depth: int = 50, num_classes: int = 1000, deep_base: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__(depth=depth, deep_base=deep_base, dtype=dtype, remat=remat)
        self.fc = nn.Linear(512 * _ARCH[depth][0].expansion, num_classes)

    def init_weights(self, generator: torch.Generator):
        """The backbone's kaiming fan_out; ``fc`` keeps ``nn.Linear``'s
        default, U(+-1/sqrt(fan_in)) for weight and bias (the reference's
        kaiming loop covers only convs and BatchNorm)."""
        super().init_weights(generator)
        torch_default_conv_init_(self.fc, generator)

    def forward(self, x):
        pooled = self.features(x)[3].float().mean(dim=(2, 3)).to(self.dtype)
        return F.linear(pooled, self.fc.weight.to(self.dtype),
                        self.fc.bias.to(self.dtype)).float()


def _make(depth):
    """The ``resnet{depth}`` factory (JAX ``models/resnet.py:198-217``)."""

    def ctor(seg: bool = True, **kwargs) -> ResNet:
        if seg:
            kwargs.setdefault("stage_strides", SEG_STRIDES)
            kwargs.setdefault("stage_dilations", SEG_DILATIONS)
        return ResNet(depth=depth, **kwargs)

    ctor.__name__ = ctor.__qualname__ = f"resnet{depth}"
    ctor.__doc__ = (f"``ResNet(depth={depth}, **kwargs)``; ``seg=True`` (the default) sets "
                    "the segmentation strides and dilations (output stride 8) unless "
                    "``kwargs`` names them.")
    return ctor


resnet18 = _make(18)
resnet34 = _make(34)
resnet50 = _make(50)
resnet101 = _make(101)
resnet152 = _make(152)
