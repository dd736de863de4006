"""``conv_ms.serve``: Device ms per image in convolution and GEMM kernels (cuDNN, cuBLAS)."""

from bench_h100.metrics._common import class_ms_per_unit


def read(ctx):
    return class_ms_per_unit(ctx, "conv_gemm")
