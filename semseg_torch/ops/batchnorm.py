"""Inference-mode BatchNorm of bf16 activations (CUDA kernel), with the
ReLU and the residual add that follow it in a residual block folded in.

The JAX package's eval BatchNorm (``semseg_tpu/models/layers.py:142-145``)
is ``(x - mean) * rsqrt(var + eps) * weight + bias`` in float32, cast back
to the activation dtype; XLA fuses it into its neighbours. Run eagerly, the
same expression is five float32 passes over the activation and two casts.
On a bfloat16 CUDA tensor ``batchnorm_eval`` launches the kernel in
``csrc/batchnorm.cu``, which reads each element once, does the float32
arithmetic in registers and writes bfloat16 once, bit for bit the eager
result. Everything else runs ``batchnorm_eval_reference``, the eager
expression itself: CPU tensors, float32 models (``supported``), calls that
autograd records (an eval-mode BatchNorm under training, whose gradient the
kernel does not give), and ``torch.export`` or ``torch.compile`` traces.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from semseg_torch.utils.misc import tracing


def supported(dtype) -> bool:
    """Dispatch rule: the kernel takes bfloat16 activations. float32 keeps
    the exact eager path."""
    return dtype == torch.bfloat16


def batchnorm_eval_reference(x: torch.Tensor, bn, residual=None, relu=False) -> torch.Tensor:
    """The eager path, on the kernel's rounding points: ``bn``'s eval
    BatchNorm in float32 cast to ``x``'s dtype, then ``+ residual`` in that
    dtype, then the in-place ReLU."""
    shape = (1, -1, 1, 1)
    y = (x.float() - bn.running_mean.view(shape)) * torch.rsqrt(
        bn.running_var.view(shape) + bn.eps)
    y = (y * bn.weight.view(shape) + bn.bias.view(shape)).to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu_(y) if relu else y


@functools.lru_cache(maxsize=None)
def _lib():
    from semseg_torch.ops._build import load_library

    fn = load_library("batchnorm").semseg_batchnorm_eval
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device, memory_format=torch.contiguous_format):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous(memory_format=memory_format):
        raise ValueError(f"{name}: the CUDA kernel takes a tensor contiguous in {memory_format}")


def batchnorm_eval(x: torch.Tensor, bn, residual=None, relu=False) -> torch.Tensor:
    """``bn``'s inference-mode BatchNorm of ``x`` ``[N, C, H, W]``, then
    ``+ residual`` (a tensor of ``x``'s shape and dtype) and the ReLU if
    asked. A bfloat16 CUDA ``x`` that no autograd graph records runs the
    kernel, which adds one to ``batchnorm_eval.launches``; ``x`` must then
    be contiguous, in NCHW or channels-last order (cuDNN's convolutions keep
    the order of their input), ``residual`` in the same order, of fewer than
    2^31 elements. Returns a new tensor in ``x``'s order."""
    records = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, residual, bn.weight, bn.bias))
    if (x.device.type != "cuda" or not supported(x.dtype) or records or tracing()):
        return batchnorm_eval_reference(x, bn, residual, relu)
    if x.dim() != 4:
        raise ValueError(f"expected [N, C, H, W], got {tuple(x.shape)}")
    n, c, h, w = x.shape
    # The kernel walks memory as [N', C, plane]: an NCHW tensor with plane
    # H W, a channels-last one ([N, H, W, C] in memory) with plane 1.
    if x.is_contiguous():
        order, plane = torch.contiguous_format, h * w
    elif x.is_contiguous(memory_format=torch.channels_last):
        order, plane = torch.channels_last, 1
    else:
        raise ValueError("x: the CUDA kernel takes a tensor contiguous in NCHW or "
                         "channels-last order")
    if residual is not None:
        _check("residual", residual, x.dtype, x.shape, x.device, order)
    params = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    for name, t in zip(("running_mean", "running_var", "weight", "bias"), params):
        _check(name, t, torch.float32, (c,), x.device)
    out = torch.empty_like(x, memory_format=order)
    with torch.cuda.device(x.device):
        rc = _lib()(x.data_ptr(), None if residual is None else residual.data_ptr(),
                    out.data_ptr(), *(t.data_ptr() for t in params), bn.eps, x.numel(), c, plane,
                    int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"batchnorm kernel launch failed: cudaError {rc}")
    batchnorm_eval.launches += 1
    return out


batchnorm_eval.launches = 0
