"""The products of the reference, and the control's lower precision.

By default :func:`conv2d` and :func:`bmm` are float32 products (TF32 is off
wherever the reference runs: ``reference/__init__.py::float32_exact``).
Inside :func:`lowered` each operand of each product is first rounded to a
lower precision, as a program that took that step would compute:

- ``"fp8"``: the operands float8 e4m3 with one scale a tensor (its largest
  magnitude to 448, the format's largest), and in the backward pass the
  products' incoming gradients float8 e5m2 likewise (57344), the step below
  bfloat16 (the usual fp8 training recipe: every product of the forward
  and backward passes takes fp8 inputs, sums in float32);
- ``"tf32"``: TF32 on the tensor cores (the flags), the step below float32
  with TF32 off;
- ``"bf16"``: the operands and the incoming gradients bfloat16, sums in
  float32: not a control but the witness, a plain bfloat16 run of the
  reference in the configuration's own precision.

The operands' rounding passes gradients unchanged (straight through).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

_state = threading.local()
E4M3_MAX, E5M2_MAX = 448.0, 57344.0
# the kinds that round the products' operands: (operand format, its
# largest finite value, incoming gradient format, its largest); None: no
# scale, the format's range holds every value
ROUNDED = {"fp8": (torch.float8_e4m3fn, E4M3_MAX, torch.float8_e5m2, E5M2_MAX),
           "bf16": (torch.bfloat16, None, torch.bfloat16, None)}


def mode():
    return getattr(_state, "mode", None)


@contextlib.contextmanager
def lowered(kind: str):
    if kind not in ("tf32", *ROUNDED):
        raise ValueError(f"unknown lower precision {kind!r}")
    before = mode()
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    _state.mode = kind
    if kind == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        _state.mode = before
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _round(x, dtype, largest):
    if largest is None:
        return x.to(dtype).float()
    scale = x.detach().abs().amax().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).float() * scale


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded (e4m3, bfloat16); backward: the
    gradient unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, *ROUNDED[mode()][:2])

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    """Forward: unchanged; backward: the product's incoming gradient rounded
    (e5m2, bfloat16), which both of its gradient products then read."""

    @staticmethod
    def forward(ctx, y):
        ctx.kind = mode()
        return y

    @staticmethod
    def backward(ctx, g):
        return _round(g, *ROUNDED[ctx.kind][2:])


def _lowered(product, a, b):
    if mode() not in ROUNDED:
        return product(a, b)
    return _OutputGrad.apply(product(_Operand.apply(a), _Operand.apply(b)))


def conv2d(x, weight, bias, stride, padding, dilation):
    if mode() not in ROUNDED:
        return F.conv2d(x, weight, bias, stride, padding, dilation)
    out = _lowered(lambda a, w: F.conv2d(a, w, None, stride, padding, dilation), x, weight)
    return out if bias is None else out + bias.view(1, -1, 1, 1)


def bmm(a, b):
    return _lowered(torch.bmm, a, b)
