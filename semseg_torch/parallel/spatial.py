"""Spatial partition of an inference forward over several devices: every
activation's rows (the H axis) are split into contiguous ranges, one range
per device, and each op fetches the global input rows that its output rows
need from whichever devices own them.

The counterpart of the JAX evaluator's ``partition='spatial'``
(``semseg_tpu/engine/evaluator.py:109-165``), where GSPMD shards each
window's H axis and inserts the halo exchanges. Here the exchange is
explicit and the rules are per op:

- a convolution's output rows ``[a, b)`` read input rows ``[a*s - p,
  (b-1)*s - p + d*(k-1) + 1)``; the rows outside the image are the zero
  padding of the single-device conv, and the conv runs with no H padding
  (the max pool alike, its padded rows never win). A dilated conv's halo
  may be larger than a slab (layer4's is 4 rows, and a 33x33 window's
  feature map has 5), so rows come from any owner, not only a neighbour;
- pointwise modules (eval-mode BatchNorm, ReLU, dropout) run on each slab;
- the adaptive average pools of the PPM sum each device's rows in float32
  (``P_h[:, rows] @ x @ P_w^T``) and add the partial sums on the primary
  device, in device order; the pooled bins live there;
- an align-corners resize (the PPM upsample, the x8 zoom) gives each
  device its output rows ``M[rows, :]`` against the input rows they touch;
- the PSA module's attention is global: its input is gathered on the
  primary device and the module, with its CUDA kernels, runs whole there
  (what GSPMD does with an opaque ``pallas_call``); its output is split
  again.

The op results agree with the single-device forward up to the order of
float32 sums. :class:`Spatial` holds the devices and one replica of the
model per device entry (entries on one device share it) and walks the
segmentation models (``features``, the context module, ``cls`` and the
zoom of ``models/pspnet.py::segment``) and any ``nn.Sequential`` model of
the modules it has rules for (then the zoom back to the window); another
model raises. Inference only: BatchNorm must be in eval mode.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from semseg_torch.utils.misc import tensor_cache


def split_rows(height: int, n: int) -> List[int]:
    """Start rows of ``n`` contiguous ranges covering ``height`` rows as
    evenly as possible, the first ``height % n`` one row longer (5 rows
    over 3 devices: 2, 2, 1), and ``height`` at the end."""
    base, extra = divmod(height, n)
    starts = [0]
    for k in range(n):
        starts.append(starts[-1] + base + (k < extra))
    return starts


class RowShards:
    """A ``[N, C, H, W]`` activation held as row slabs: ``parts[k]`` holds
    rows ``starts[k]:starts[k + 1]`` on the ``k``-th device entry, or is
    None when that range is empty."""

    def __init__(self, parts: List[Optional[torch.Tensor]], starts: List[int]):
        self.parts = parts
        self.starts = starts

    @property
    def height(self) -> int:
        return self.starts[-1]

    def _some(self) -> torch.Tensor:
        return next(p for p in self.parts if p is not None)

    @property
    def width(self) -> int:
        return self._some().shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self._some().dtype


@tensor_cache
def _pool_matrix(size: int, bins: int, device: torch.device) -> torch.Tensor:
    """``[bins, size]`` float32: row ``i`` averages the adaptive pool's
    region ``floor(i*size/bins) .. ceil((i+1)*size/bins)``."""
    m = np.zeros((bins, size), np.float32)
    for i in range(bins):
        lo, hi = (i * size) // bins, -((-(i + 1) * size) // bins)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return torch.from_numpy(m).to(device)


class Spatial:
    """The devices of a spatial partition and the model's replica on each
    entry. ``devices[0]`` is the primary: inputs come from it and outputs
    return to it."""

    def __init__(self, devices: Sequence[torch.device], replicas: Sequence[nn.Module]):
        if len(devices) != len(replicas):
            raise ValueError(f"{len(devices)} devices, {len(replicas)} replicas")
        self.devices = list(devices)
        self.replicas = list(replicas)

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    @staticmethod
    def sub(ms, name: str):
        """The submodule ``name`` of each replica."""
        return tuple(m.get_submodule(name) for m in ms)

    # ------------------------------------------------------------------
    # moving rows
    # ------------------------------------------------------------------
    def scatter(self, x: torch.Tensor) -> RowShards:
        """A whole ``[N, C, H, W]`` tensor split evenly over the devices."""
        starts = split_rows(x.shape[-2], len(self.devices))
        parts = [x[:, :, a:b].to(dev) if b > a else None
                 for dev, a, b in zip(self.devices, starts, starts[1:])]
        return RowShards(parts, starts)

    def on_primary(self, x: torch.Tensor) -> RowShards:
        """A whole tensor owned by the primary device alone."""
        h = x.shape[-2]
        return RowShards([x.to(self.primary)] + [None] * (len(self.devices) - 1),
                         [0] + [h] * len(self.devices))

    def rows(self, x: RowShards, lo: int, hi: int, k: int, fill: float = 0.0) -> torch.Tensor:
        """Global rows ``lo:hi`` of ``x`` on device entry ``k``, taken from
        whichever entries own them; rows outside ``[0, H)`` are ``fill``."""
        dev = self.devices[k]
        pieces = []
        for j, part in enumerate(x.parts):
            s, e = x.starts[j], x.starts[j + 1]
            a, b = max(lo, s), min(hi, e)
            if part is not None and b > a:
                pieces.append(part[:, :, a - s:b - s].to(dev))
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)
        top, bottom = max(0, -lo), max(0, hi - x.height)
        if top or bottom:
            out = F.pad(out, (0, 0, top, bottom), value=fill)
        return out

    def gather(self, x: RowShards, k: int = 0) -> torch.Tensor:
        """All rows of ``x`` on device entry ``k`` (the primary by default)."""
        return self.rows(x, 0, x.height, k)

    def _rowwise(self, x: RowShards, out_h: int, need, fill: float, make) -> RowShards:
        """Output rows split evenly; entry ``k`` computes its range ``[a,
        b)`` as ``make(k, inp, a, b)`` from the input rows ``need(a, b)``."""
        starts = split_rows(out_h, len(self.devices))
        parts = []
        for k, (a, b) in enumerate(zip(starts, starts[1:])):
            if b == a:
                parts.append(None)
                continue
            lo, hi = need(a, b)
            parts.append(make(k, self.rows(x, lo, hi, k, fill), a, b))
        return RowShards(parts, starts)

    def map(self, fn, *xs: RowShards) -> RowShards:
        """``fn(k, *slabs)`` on each entry's slabs of row-aligned inputs."""
        starts = xs[0].starts
        if any(x.starts != starts for x in xs[1:]):
            raise ValueError("row ranges differ")
        parts = [None if xs[0].parts[k] is None else fn(k, *(x.parts[k] for x in xs))
                 for k in range(len(starts) - 1)]
        return RowShards(parts, starts)

    # ------------------------------------------------------------------
    # ops
    # ------------------------------------------------------------------
    def conv2d(self, ms, x: RowShards) -> RowShards:
        """``ms[k]``: the same ``nn.Conv2d`` on each entry (the port's
        ``Conv2d`` runs in its input's dtype, as here)."""
        m = ms[0]
        if m.padding_mode != "zeros" or isinstance(m.padding, str):
            raise ValueError(f"spatial conv needs integer zero padding, got {m.padding}")
        kh, sh, ph, dh = m.kernel_size[0], m.stride[0], m.padding[0], m.dilation[0]
        out_h = (x.height + 2 * ph - dh * (kh - 1) - 1) // sh + 1

        def make(k, inp, a, b):
            mk = ms[k]
            bias = None if mk.bias is None else mk.bias.to(inp.dtype)
            return F.conv2d(inp, mk.weight.to(inp.dtype), bias, mk.stride,
                            (0, mk.padding[1]), mk.dilation, mk.groups)

        return self._rowwise(x, out_h, lambda a, b: (a * sh - ph, (b - 1) * sh - ph
                                                     + dh * (kh - 1) + 1), 0.0, make)

    def max_pool2d(self, x: RowShards, kernel: int = 3, stride: int = 2,
                   padding: int = 1) -> RowShards:
        """``F.max_pool2d`` with a square window; padded rows never win."""
        out_h = (x.height + 2 * padding - kernel) // stride + 1
        return self._rowwise(
            x, out_h, lambda a, b: (a * stride - padding, (b - 1) * stride - padding + kernel),
            float("-inf"), lambda k, inp, a, b: F.max_pool2d(inp, kernel, stride, (0, padding)))

    def resize(self, x: RowShards, size) -> RowShards:
        """Align-corners bilinear resize to ``size`` (``ops/resize.py``):
        each output row range takes ``M_h[rows, cols]`` against the input
        rows ``cols`` it touches, float32 sums, back to the input dtype."""
        from semseg_torch.ops.resize import _interp_matrix, interp_matrix

        out_h, out_w = int(size[0]), int(size[1])
        if (x.height, x.width) == (out_h, out_w):
            return x
        host = _interp_matrix(x.height, out_h)

        def need(a, b):
            cols = np.nonzero(host[a:b].any(axis=0))[0]
            return int(cols[0]), int(cols[-1]) + 1

        def make(k, inp, a, b):
            dev = self.devices[k]
            lo, hi = need(a, b)
            mh = interp_matrix(x.height, out_h, False, dev)[a:b, lo:hi]
            mw = interp_matrix(x.width, out_w, False, dev)
            y = torch.matmul(mh, inp.float())
            return torch.matmul(y, mw.t()).to(inp.dtype)

        return self._rowwise(x, out_h, need, 0.0, make)

    def adaptive_avg_pool2d(self, x: RowShards, bins: int) -> RowShards:
        """``ops/pool.adaptive_avg_pool2d`` to ``bins x bins``: each entry's
        float32 partial sums over its rows, added on the primary in entry
        order; the pooled map belongs to the primary."""
        total = None
        for k, part in enumerate(x.parts):
            if part is None:
                continue
            dev, a, b = self.devices[k], x.starts[k], x.starts[k + 1]
            ph = _pool_matrix(x.height, bins, dev)[:, a:b]
            pw = _pool_matrix(x.width, bins, dev)
            y = torch.matmul(torch.matmul(ph, part.float()), pw.t()).to(self.primary)
            total = y if total is None else total + y
        return self.on_primary(total.to(x.dtype))

    def cat(self, xs: Sequence[RowShards]) -> RowShards:
        return self.map(lambda k, *parts: torch.cat(parts, dim=1), *xs)

    # ------------------------------------------------------------------
    # modules
    # ------------------------------------------------------------------
    def apply(self, ms, x: RowShards) -> RowShards:
        """Module ``ms[0]`` (``ms[k]`` its replica on entry ``k``) on ``x``."""
        from semseg_torch.models.layers import BatchNorm2d, Dropout2d
        from semseg_torch.models.psanet import PSA
        from semseg_torch.models.pspnet import PPM
        from semseg_torch.models.resnet import BasicBlock, Bottleneck
        from semseg_torch.ops.pool import AdaptiveAvgPool2d

        m = ms[0]
        if isinstance(m, nn.Conv2d):
            return self.conv2d(ms, x)
        if isinstance(m, nn.MaxPool2d):
            k, st, p = (v if isinstance(v, int) else v[0]
                        for v in (m.kernel_size, m.stride, m.padding))
            if m.dilation not in (1, (1, 1)) or m.ceil_mode:
                raise ValueError("spatial max pool needs dilation 1 and floor mode")
            return self.max_pool2d(x, k, st, p)
        if isinstance(m, (BatchNorm2d, nn.ReLU, Dropout2d)):
            if m.training:
                raise ValueError("spatial partition runs inference: put the model in eval mode")
            return self.map(lambda k, p: ms[k](p), x)
        if isinstance(m, nn.Sequential):
            for i in range(len(m)):
                x = self.apply(tuple(mk[i] for mk in ms), x)
            return x
        if isinstance(m, (Bottleneck, BasicBlock)):
            return self._block(ms, x)
        if isinstance(m, AdaptiveAvgPool2d):
            return self.adaptive_avg_pool2d(x, m.output_size)
        if isinstance(m, PPM):
            size = (x.height, x.width)
            return self.cat([x] + [self.resize(self.apply(tuple(mk.features[i] for mk in ms), x),
                                               size) for i in range(len(m.features))])
        if isinstance(m, PSA):
            # global attention: the module runs whole on the primary
            return self.scatter(m(self.gather(x)))
        raise TypeError(f"the spatial partition has no rule for {type(m).__name__}")

    def _block(self, ms, x: RowShards) -> RowShards:
        """A residual block (``models/resnet.py``): the convs in turn,
        then ``relu(out + residual)``."""
        convs = ("conv1", "conv2", "conv3") if hasattr(ms[0], "conv3") else ("conv1", "conv2")
        out = x
        for i, name in enumerate(convs, start=1):
            out = self.apply(self.sub(ms, f"bn{i}"), self.apply(self.sub(ms, name), out))
            if i < len(convs):
                out = self.map(lambda k, p: torch.relu_(p), out)
        residual = x if ms[0].downsample is None else self.apply(self.sub(ms, "downsample"), x)
        return self.map(lambda k, a, r: torch.relu_(a + r), out, residual)

    def forward(self, x: torch.Tensor, zoom: bool = True) -> torch.Tensor:
        """The model's float32 logits for a whole normalized ``[N, 3, H, W]``
        batch on the primary device, computed over the row partition and
        gathered there: ``models/pspnet.py::segment`` for PSPNet and
        PSANet; an ``nn.Sequential`` model's modules in turn, then, with
        ``zoom`` and a ``zoom_factor`` other than 1, the resize back to
        ``H x W``."""
        from semseg_torch.models.psanet import PSANet
        from semseg_torch.models.pspnet import PSPNet, seg_out_hw

        model = self.replicas[0]
        if model.training:
            raise ValueError("spatial partition runs inference: put the model in eval mode")
        segmentation = isinstance(model, (PSPNet, PSANet))
        if not (segmentation or isinstance(model, nn.Sequential)):
            raise TypeError(f"{type(model).__name__} has no spatial rule (a segmentation "
                            "model or an nn.Sequential)")
        ms = tuple(self.replicas)
        dtype = getattr(model, "dtype", torch.float32)
        xs = self.map(lambda k, p: p.to(dtype), self.scatter(x))
        zoom = zoom and getattr(model, "zoom_factor", 1) != 1
        if not segmentation:
            xs = self.apply(ms, xs)
            return self.gather(self.resize(xs, x.shape[-2:]) if zoom else xs).float()
        out_hw = seg_out_hw(model, x.shape[-2], x.shape[-1])
        xs = self.max_pool2d(self.apply(self.sub(ms, "layer0"), xs), 3, 2, 1)
        for name in ("layer1", "layer2", "layer3", "layer4"):
            xs = self.apply(self.sub(ms, name), xs)
        context = "ppm" if isinstance(model, PSPNet) else "psa"
        if getattr(model, f"use_{context}"):
            xs = self.apply(self.sub(ms, context), xs)
        xs = self.apply(self.sub(ms, "cls"), xs)
        if zoom:
            xs = self.resize(xs, out_hw)
        return self.gather(xs).float()
