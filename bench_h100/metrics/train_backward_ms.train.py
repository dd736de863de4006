"""``train_backward_ms.train``: Device ms per step in the program's span semseg.train.backward: the last step's gradients freed and loss.backward()."""

from bench_h100.metrics._spans import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "semseg.train.backward", "device_s")
