"""Plain PyTorch PSPNet and PSANet, the benchmark's reference.

Written from the published description (hszhao/semseg ``model/resnet.py``,
``model/pspnet.py``, ``model/psanet.py``, ``lib/psa``): a deep-base ResNet
dilated to output stride 8, the pyramid pooling module or point-wise
spatial attention, and the ``cls`` and ``aux`` heads. Everything runs in
float32 with ``nn.Conv2d``, ``nn.BatchNorm2d``, ``F.interpolate`` and
``torch.bmm``; the attention matrix is built with one ``gather``. It
imports nothing of the program under test. Parameter and buffer names are
the published ones, so one state dict made by the benchmark loads into
both sides.

``quantize`` (``reference/quant.py``) hooks every convolution and the
attention product: with it set, operands are rounded to a lower precision
before each product. It is how the control of ``correct`` is computed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bench_h100.reference import quant

COLLECT, DISTRIBUTE, BI_DIRECTION = 0, 1, 2


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose operands pass through the control's rounding
    when one is set."""

    def forward(self, x):
        return quant.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                            self.dilation)


def conv_bn(cin, cout, k=1, stride=1, padding=0, dilation=1, relu=True):
    mods = [Conv2d(cin, cout, k, stride=stride, padding=padding, dilation=dilation,
                   bias=False), nn.BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    return mods


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class DilatedResNet(nn.Module):
    """Deep-base stem (three 3x3 convs, max pool), bottleneck stages with
    strides (1, 2, 1, 1) and dilations (1, 1, 2, 4)."""

    def __init__(self, layers=50):
        super().__init__()
        self.layer0 = nn.Sequential(*conv_bn(3, 64, 3, 2, 1), *conv_bn(64, 64, 3, 1, 1),
                                    *conv_bn(64, 128, 3, 1, 1))
        inplanes = 128
        for s, (planes, blocks, stride, dil) in enumerate(zip(
                (64, 128, 256, 512), DEPTHS[layers], (1, 2, 1, 1), (1, 1, 2, 4))):
            down = None
            if stride != 1 or inplanes != planes * 4:
                down = nn.Sequential(Conv2d(inplanes, planes * 4, 1, stride=stride,
                                            bias=False), nn.BatchNorm2d(planes * 4))
            mods = [Bottleneck(inplanes, planes, stride, dil, down)]
            inplanes = planes * 4
            mods += [Bottleneck(inplanes, planes, 1, dil) for _ in range(1, blocks)]
            setattr(self, f"layer{s + 1}", nn.Sequential(*mods))

    def backbone(self, x):
        x = F.max_pool2d(self.layer0(x), 3, 2, 1)
        x = self.layer1(x)
        x = self.layer2(x)
        c3 = self.layer3(x)
        return c3, self.layer4(c3)


def head(cin, mid, classes, dropout=0.1):
    """``Sequential(conv, bn, relu, dropout, conv)``; the dropout masks come
    from :class:`Dropout2d`'s ``masks`` when set."""
    return nn.Sequential(*conv_bn(cin, mid, 3, 1, 1), Dropout2d(dropout),
                         Conv2d(mid, classes, 1))


class Dropout2d(nn.Module):
    """Channel dropout whose keep masks are drawn from ``generator`` (the
    training step's stream) or handed in whole."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        keep = torch.rand(x.shape[0], x.shape[1], 1, 1, device=x.device,
                          generator=self.generator) >= self.p
        return x * (keep.float() / (1.0 - self.p))


def up(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


class PPM(nn.Module):
    def __init__(self, cin=2048, reduction=512, bins=(1, 2, 3, 6)):
        super().__init__()
        self.bins = bins
        self.features = nn.ModuleList(
            nn.Sequential(nn.Identity(), *conv_bn(cin, reduction)) for _ in bins)

    def forward(self, x):
        size = x.shape[-2:]
        return torch.cat([x] + [up(f(F.adaptive_avg_pool2d(x, b)), size)
                                for b, f in zip(self.bins, self.features)], 1)


def attention_index(h, w, mask_h, mask_w, device):
    """``idx[s, q]``: the row of the relative logits ``[mask_h*mask_w + 1,
    h*w]`` that the absolute matrix takes at source ``s`` for query ``q``;
    offsets outside the mask point at the extra zero row (``lib/psa``'s
    ``psamask`` leaves them zero)."""
    hh = torch.arange(h, device=device)
    ww = torch.arange(w, device=device)
    qh, qw = hh.repeat_interleave(w), ww.repeat(h)          # query position
    dh = qh[:, None] - qh[None, :] + (mask_h - 1) // 2      # [s, q]
    dw = qw[:, None] - qw[None, :] + (mask_w - 1) // 2
    valid = (dh >= 0) & (dh < mask_h) & (dw >= 0) & (dw < mask_w)
    return torch.where(valid, dh * mask_w + dw, mask_h * mask_w)


def attention_matrix(y, psa_type, mask_h, mask_w):
    """``lib/psa``'s ``psamask`` followed by the reshape to ``[n, hw, hw]``:
    COLLECT ``A[s, q]`` and DISTRIBUTE ``A[q, s]`` hold the logit that query
    ``q`` predicts for the offset of ``s``."""
    n, _, h, w = y.shape
    rel = torch.cat([y.reshape(n, mask_h * mask_w, h * w),
                     y.new_zeros(n, 1, h * w)], 1)
    idx = attention_index(h, w, mask_h, mask_w, y.device)
    a = torch.gather(rel, 1, idx.expand(n, -1, -1))          # [n, s, q]
    return a if psa_type == COLLECT else a.transpose(1, 2)


class PSA(nn.Module):
    def __init__(self, cin=2048, mid=512, psa_type=BI_DIRECTION, shrink_factor=2,
                 mask_h=59, mask_w=59, normalization_factor=1.0, psa_softmax=True):
        super().__init__()
        self.psa_type = psa_type
        self.shrink = shrink_factor
        self.mask_h, self.mask_w = mask_h, mask_w
        self.norm = normalization_factor
        self.softmax = psa_softmax
        self.reduce = nn.Sequential(*conv_bn(cin, mid))
        self.attention = nn.Sequential(*conv_bn(mid, mid), Conv2d(mid, mask_h * mask_w, 1,
                                                                  bias=False))
        if psa_type == BI_DIRECTION:
            self.reduce_p = nn.Sequential(*conv_bn(cin, mid))
            self.attention_p = nn.Sequential(*conv_bn(mid, mid),
                                             Conv2d(mid, mask_h * mask_w, 1, bias=False))
        self.proj = nn.Sequential(*conv_bn(mid * (2 if psa_type == BI_DIRECTION else 1),
                                           cin))

    def branch(self, x, psa_type, reduce, attention):
        x = reduce(x)
        n, c, h, w = x.shape
        if self.shrink != 1:
            h, w = (h - 1) // self.shrink + 1, (w - 1) // self.shrink + 1
            x = up(x, (h, w))
        a = attention_matrix(attention(x), psa_type, self.mask_h, self.mask_w)
        if self.softmax:
            a = torch.softmax(a, dim=1)
        out = quant.bmm(x.reshape(n, c, h * w), a) * (1.0 / self.norm)
        return out.reshape(n, c, h, w)

    def forward(self, x):
        if self.psa_type == BI_DIRECTION:
            feat = torch.cat([self.branch(x, COLLECT, self.reduce, self.attention),
                              self.branch(x, DISTRIBUTE, self.reduce_p, self.attention_p)], 1)
        else:
            feat = self.branch(x, self.psa_type, self.reduce, self.attention)
        feat = self.proj(feat)
        if self.shrink != 1:
            feat = up(feat, x.shape[-2:])
        return torch.cat([x, feat], 1)


class SegNet(DilatedResNet):
    """PSPNet (``context="ppm"``) or PSANet (``context="psa"``): backbone,
    context module on layer4, ``cls`` head, the zoom upsample; in train mode
    also the ``aux`` head on layer3. Returns float32 logits."""

    def __init__(self, context, layers=50, classes=19, zoom_factor=8, **psa):
        super().__init__(layers)
        self.zoom_factor = zoom_factor
        if context == "ppm":
            self.ppm = PPM()
        else:
            self.psa = PSA(**psa)
        self.context_name = context
        self.cls = head(4096, 512, classes)
        self.aux = head(1024, 256, classes)

    def forward(self, x, zoom=True):
        h = (x.shape[-2] - 1) // 8 * self.zoom_factor + 1
        w = (x.shape[-1] - 1) // 8 * self.zoom_factor + 1
        c3, c4 = self.backbone(x)
        logits = self.cls(getattr(self, self.context_name)(c4))
        if zoom and self.zoom_factor != 1:
            logits = up(logits, (h, w))
        if not self.training:
            return logits
        aux = self.aux(c3)
        if zoom and self.zoom_factor != 1:
            aux = up(aux, (h, w))
        return logits, aux


def build(config: dict, device="cpu") -> SegNet:
    """The reference model for a configuration file's ``model`` section."""
    m = config["model"]
    if m["arch"] == "psp":
        return SegNet("ppm", m["layers"], m["classes"], m["zoom_factor"]).to(device)
    feat = (m["train_h"] - 1) // (8 * m["shrink_factor"]) + 1
    mask = 2 * feat - 1
    return SegNet("psa", m["layers"], m["classes"], m["zoom_factor"],
                  psa_type=m["psa_type"], shrink_factor=m["shrink_factor"],
                  mask_h=mask, mask_w=mask,
                  normalization_factor=m["normalization_factor"],
                  psa_softmax=bool(m["psa_softmax"])).to(device)


def init_kinds(model: SegNet):
    """``(name, kind, fan)`` for every entry of the state dict: backbone
    convs ``"kaiming"`` (normal, std sqrt(2 / fan_out)), every other conv's
    weight and bias ``"uniform"`` (PyTorch's default, U(+-1/sqrt(fan_in))),
    BatchNorm ``"one"``/``"zero"`` (weight and running variance 1, bias and
    running mean 0, no batches tracked)."""
    kinds = []
    convs = {n: m for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
    for name, t in model.state_dict().items():
        mod, _, leaf = name.rpartition(".")
        if mod in convs:
            w = convs[mod].weight
            receptive = w.shape[2] * w.shape[3]
            fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
            if name.startswith("layer"):
                kinds.append((name, "kaiming", fan_out))
            else:
                kinds.append((name, "uniform", fan_in))
        elif leaf in ("weight", "running_var"):
            kinds.append((name, "one", 0))
        else:
            kinds.append((name, "zero", 0))
    return kinds
