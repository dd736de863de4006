"""``train_optimizer_ms.train``: Device ms per step in the program's span semseg.train.optimizer: the poly LR installed and the SGD step."""

from bench_h100.metrics._spans import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "semseg.train.optimizer", "device_s")
