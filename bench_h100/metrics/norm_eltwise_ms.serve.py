"""``norm_eltwise_ms.serve``: Device ms per image in BatchNorm, cast, copy and elementwise kernels, the NCHW/NHWC transposes included."""

from bench_h100.metrics._common import class_ms_per_unit


def read(ctx):
    return class_ms_per_unit(ctx, "norm_eltwise")
