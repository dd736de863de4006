"""Core layers: compute-dtype convs, BatchNorm with the JAX numerics,
channel dropout from an explicit generator, ConvBN, and the two weight
inits of the reference.

Port of ``semseg_tpu/models/layers.py``. Parameters are float32; a model
built for bf16 runs its convolutions in bf16 (the weight is cast to the
activation dtype at each call, as flax casts ``param_dtype`` to ``dtype``)
while BatchNorm statistics math stays float32.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def set_precision(dtype, matmul_precision=None) -> None:
    """The float32 precision contract (JAX ``layers.py:53-89``): float32
    models run cuBLAS matmuls and cuDNN convolutions in full float32 (TF32
    off; cuDNN defaults to TF32 for convolutions on Hopper), unless the
    config's ``matmul_precision`` is ``high``, which turns TF32 on. Other
    dtypes leave the flags alone. The flags are process-wide: a bf16 model
    built after a float32 one keeps TF32 off."""
    if matmul_precision not in (None, "default", "high", "highest"):
        raise ValueError(f"matmul_precision must be default/high/highest, "
                         f"got {matmul_precision}")
    if dtype == torch.float32:
        tf32 = matmul_precision == "high"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in the dtype of its input."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation,
                        self.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose eval path is the JAX package's
    (``layers.py:142-145``): ``(x - mean) * rsqrt(var + eps) * weight +
    bias`` in float32, cast back to the input dtype. Train mode takes its
    moments in float32 on the input, running statistics with momentum 0.1
    and the unbiased variance, as the JAX ``BatchNorm``
    (``layers.py:147-199``), in one of three forms (set by
    :func:`set_batchnorm_replicas`):

    - ``groups == 1`` and no ``process_group`` (the default): PyTorch's own
      batch norm over (N, H, W) of the float32 input;
    - ``groups > 1``: JAX's ``_grouped`` (``layers.py:177-199``), moments
      per equal batch slice, running statistics from slice 0 with the
      unbiased variance over its count; the one-process form of
      ``sync_bn: False`` over ``groups`` replicas;
    - a ``process_group``: moments over the batch of every rank of the
      group, all-reduced as one float32 tensor (:class:`_SyncBatchNorm`);
      the running variance's unbiased count is the global one (JAX
      ``layers.py:151-166`` under ``axis_name``)."""

    groups = 1
    process_group = None

    def forward(self, x):
        if self.training:
            if self.process_group is not None:
                return self._synced(x)
            if self.groups > 1:
                return self._grouped(x)
            return super().forward(x.float()).to(x.dtype)
        shape = (1, -1, 1, 1)
        y = (x.float() - self.running_mean.view(shape)) * torch.rsqrt(
            self.running_var.view(shape) + self.eps
        )
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)

    @torch.no_grad()
    def _track(self, mean, var, count):
        """Running statistics: momentum EMA of the mean and of the unbiased
        variance over ``count`` samples."""
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var * (count / max(count - 1, 1)), alpha=m)
        self.num_batches_tracked.add_(1)

    def _grouped(self, x):
        g, b = self.groups, x.shape[0]
        if b % g:
            raise ValueError(f"batch {b} not divisible by {g} BatchNorm groups")
        xf = x.float().reshape(g, b // g, *x.shape[1:])
        mean = xf.mean(dim=(1, 3, 4))  # [g, C]
        var = (xf.square().mean(dim=(1, 3, 4)) - mean.square()).clamp_min(0.0)
        self._track(mean[0].detach(), var[0].detach(), (b // g) * x.shape[2] * x.shape[3])
        shape = (g, 1, -1, 1, 1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        y = y * self.weight.view(1, 1, -1, 1, 1) + self.bias.view(1, 1, -1, 1, 1)
        return y.reshape(x.shape).to(x.dtype)

    def _synced(self, x):
        y, mean, var = _SyncBatchNorm.apply(x.float(), self.weight, self.bias, self.eps,
                                            self.process_group)
        # Every rank holds an equal batch: the global count (JAX
        # ``count = local_count * psum(1)``), known without a host sync.
        count = x.shape[0] * x.shape[2] * x.shape[3] * dist.get_world_size(self.process_group)
        self._track(mean, var, count)
        return y.to(x.dtype)


class _SyncBatchNorm(torch.autograd.Function):
    """Batch norm over the batches of every rank of a process group, in
    JAX's arithmetic (``layers.py:151-166``): the forward all-reduces one
    float32 tensor ``[sum x, sum x^2, count]`` and takes ``var = max(E[x^2]
    - E[x]^2, 0)``; the backward all-reduces ``[sum dy, sum dy * xhat]``.
    The returned weight and bias gradients are the rank's own sums, which
    DDP averages over the ranks with every other gradient. One
    ``all_reduce`` each way, which every backend runs on CPU and CUDA
    tensors (gloo has no ``all_gather`` of CUDA tensors, which
    ``torch.nn.SyncBatchNorm`` needs)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        local = x.shape[0] * x.shape[2] * x.shape[3]
        stats = torch.cat([x.sum(dim=(0, 2, 3)), x.square().sum(dim=(0, 2, 3)),
                           x.new_full((1,), float(local))])
        dist.all_reduce(stats, group=group)
        count = stats[2 * c]
        mean = stats[:c] / count
        var = (stats[c:2 * c] / count - mean.square()).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(xhat, invstd, weight, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        y = xhat * weight.view(shape) + bias.view(shape)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight, count = ctx.saved_tensors
        c = xhat.shape[1]
        sums = torch.cat([dy.sum(dim=(0, 2, 3)), (dy * xhat).sum(dim=(0, 2, 3))])
        dbias, dweight = sums[:c].clone(), sums[c:].clone()
        dist.all_reduce(sums, group=ctx.group)
        shape = (1, -1, 1, 1)
        mean_dy = (sums[:c] / count).view(shape)
        mean_dy_xhat = (sums[c:] / count).view(shape)
        dx = (dy - mean_dy - xhat * mean_dy_xhat) * (invstd * weight).view(shape)
        return dx, dweight, dbias, None, None


def set_batchnorm_replicas(model: nn.Module, groups: int = 1, process_group=None) -> None:
    """Set every :class:`BatchNorm2d` of ``model`` to per-slice moments over
    ``groups`` equal batch slices, or to moments synchronised over
    ``process_group`` (not both)."""
    if groups < 1:
        raise ValueError(f"BatchNorm groups must be >= 1, got {groups}")
    if groups > 1 and process_group is not None:
        raise ValueError("BatchNorm takes batch groups or a process group, not both")
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.groups = int(groups)
            m.process_group = process_group


class Dropout2d(nn.Module):
    """Channel dropout, ``nn.Dropout2d`` semantics (JAX ``Dropout2d``,
    ``layers.py:248-258``: whole channels per sample, kept ones scaled by
    ``1/(1-p)``), drawing its mask from ``self.generator`` (a
    ``torch.Generator`` on the activations' device, set by the trainer;
    None draws from the global generator). The streams differ from JAX's,
    so parity tests run with ``p = 0``."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.generator = None

    def extra_repr(self):
        return f"p={self.p}"

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        if self.p >= 1:
            return torch.zeros_like(x)
        keep = torch.rand(x.shape[0], x.shape[1], 1, 1, device=x.device,
                          generator=self.generator) >= self.p
        return x * (keep.to(x.dtype) / (1.0 - self.p))


class ConvBN(nn.Sequential):
    """Conv2d(bias=False) + BatchNorm + optional ReLU, children ``0, 1, 2``
    like the reference's Sequentials. Iterating yields the modules, so a
    reference Sequential is spelled ``nn.Sequential(*ConvBN(...), ...)``."""

    def __init__(self, in_ch, out_ch, kernel_size=1, stride=1, padding=0,
                 dilation=1, relu=True):
        mods = [
            Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                   dilation=dilation, bias=False),
            BatchNorm2d(out_ch),
        ]
        if relu:
            mods.append(nn.ReLU(inplace=True))
        super().__init__(*mods)


def _fan(w: torch.Tensor):
    receptive = w[0][0].numel()
    return w.shape[1] * receptive, w.shape[0] * receptive  # fan_in, fan_out


@torch.no_grad()
def kaiming_normal_fan_out_(w: torch.Tensor, generator: torch.Generator):
    """``kaiming_normal_(mode='fan_out', nonlinearity='relu')``: the
    backbone's init (reference ``model/resnet.py:123-128``)."""
    _, fan_out = _fan(w)
    return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


@torch.no_grad()
def torch_default_conv_init_(conv: nn.Conv2d, generator: torch.Generator):
    """PyTorch's default Conv2d init, ``kaiming_uniform_(a=sqrt(5))`` =
    U(+-sqrt(1/fan_in)), bias U(+-1/sqrt(fan_in)): every conv the
    reference builds outside ``ResNet.__init__`` keeps it."""
    fan_in, _ = _fan(conv.weight)
    bound = 1.0 / math.sqrt(fan_in)
    conv.weight.uniform_(-bound, bound, generator=generator)
    if conv.bias is not None:
        conv.bias.uniform_(-bound, bound, generator=generator)

