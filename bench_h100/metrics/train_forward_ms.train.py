"""``train_forward_ms.train``: Device ms per step in the program's span semseg.train.forward: input layout, the model's forward and both losses."""

from bench_h100.metrics._spans import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "semseg.train.forward", "device_s")
