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
    bias`` in float32, cast back to the input dtype. Train mode is
    PyTorch's own, on the float32 input: batch moments over (N, H, W),
    running statistics with momentum 0.1 and the unbiased variance, as the
    JAX ``BatchNorm`` reimplements (``layers.py:147-175``)."""

    def forward(self, x):
        if self.training:
            return super().forward(x.float()).to(x.dtype)
        shape = (1, -1, 1, 1)
        y = (x.float() - self.running_mean.view(shape)) * torch.rsqrt(
            self.running_var.view(shape) + self.eps
        )
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


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

