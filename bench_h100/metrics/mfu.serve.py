"""``mfu.serve``: Whole-step share of the peak: the model FLOPs of the completed requests (real windows x 2 for the mirror) per second over the peak of the compute dtype (bf16 989 TFLOP/s; f32 495/3)."""

from bench_h100.metrics._common import mfu_percent


def read(ctx):
    return mfu_percent(ctx)
