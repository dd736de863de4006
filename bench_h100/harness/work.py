"""The work a cell's inputs need, counted from shapes, and the H100's peaks.

FLOPs: convolutions and matrix products (the attention's product too), 2
a multiply-add, counted by ``torch.utils.flop_counter`` on the reference
model built on the ``meta`` device at the cell's shapes, so a number reads
the same work whatever implements it.

Peaks (NVIDIA's H100 SXM data sheet, dense): 989 TFLOP/s bf16 on the tensor
cores; float32 at the port's precision contract (TF32 off) is costed as
3xTF32, 495 / 3 TFLOP/s, the fastest route that keeps float32's accuracy;
3.35 TB/s of HBM. ``bound`` and the PSA bounds are copies of
``chip_smoke.py``'s.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BYTES, PEAK_BF16, PEAK_TF32, PEAK_F32 = 3.35e12, 989e12, 495e12, 67e12
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def peak_flops(dtype) -> float:
    """The peak of the cell's compute dtype that a whole step's share is
    taken against."""
    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32 / 3


def bound(nbytes, flops, dtype, products=True):
    """``(ms, "bytes" or "operations")``: the least time for a function
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``flops`` operations of ``dtype``, on an H100 SXM. Matrix
    products (``products``) run on the tensor cores: bf16 at the bf16 rate,
    f32 at HIGHEST precision as 3xTF32; other f32 operations outside them."""
    byte_ms = nbytes / PEAK_BYTES * 1e3
    if not products:
        op_ms = flops / PEAK_F32 * 1e3
    elif dtype == torch.bfloat16:
        op_ms = flops / PEAK_BF16 * 1e3
    else:
        op_ms = 3 * flops / PEAK_TF32 * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def psa_fwd_bound(n, c, hw, dtype):
    """The PSA forward: reads x and A, writes f32 out; 2 N C hw^2 FLOP."""
    esz = 2 if dtype == torch.bfloat16 else 4
    return bound(n * hw * hw * esz + n * c * hw * (esz + 4), 2 * n * c * hw * hw, dtype)


def psa_dx_bound(n, c, hw, dtype):
    """dx: reads A, f32 g, m and l, writes dx in x's dtype; 2 N C hw^2."""
    esz = 2 if dtype == torch.bfloat16 else 4
    return bound(n * hw * hw * esz + n * c * hw * (4 + esz) + 2 * n * hw * 4,
                 2 * n * c * hw * hw, dtype)


def psa_da_bound(n, c, hw, dtype):
    """da: reads x, A, f32 g and out, m and l, writes da; 2 N C hw^2."""
    esz = 2 if dtype == torch.bfloat16 else 4
    return bound(2 * n * hw * hw * esz + n * c * hw * (esz + 8) + 2 * n * hw * 4,
                 2 * n * c * hw * hw, dtype)


def stitch_bound(pairs, classes, feat, crop):
    """One launch of the fused stitch: reads ``[pairs, 2, classes, feat,
    feat]`` bf16 logits once and writes ``[pairs, classes, crop, crop]`` bf16
    probabilities once; its arithmetic (two taps an axis and a softmax) is
    far below the bytes' time."""
    nbytes = pairs * 2 * classes * feat * feat * 2 + pairs * classes * crop * crop * 2
    return bound(nbytes, 0, torch.bfloat16, products=False)


def _forward_flops(model, shape, train):
    x = torch.empty(shape, device="meta")
    model.train(train)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def _meta_model(config_json: str):
    import json

    from bench_h100.reference.models import build

    return build(json.loads(config_json), device="meta")


def forward_flops(config: dict, batch: int, size: int, train: bool) -> int:
    """Convolution and product FLOPs of one forward of the configuration at
    ``[batch, 3, size, size]`` (train mode: with the aux head)."""
    import json

    return _forward_flops(_meta_model(json.dumps(config, sort_keys=True)),
                          (batch, 3, size, size), train)


def stem_input_grad_flops(batch: int, size: int) -> int:
    """The stem's first convolution (3 -> 64, 3x3, stride 2): its input
    gradient is never computed, and its FLOPs equal its forward's."""
    out = (size - 1) // 2 + 1
    return 2 * batch * out * out * 64 * 3 * 9


def train_step_flops(config: dict, batch: int, size: int) -> int:
    """Forward + backward = 3x the forward, less the stem's input gradient;
    no recomputation."""
    return 3 * forward_flops(config, batch, size, True) - stem_input_grad_flops(batch, size)
