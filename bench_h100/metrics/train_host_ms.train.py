"""``train_host_ms.train``: Host ms per step in the program's span semseg.train.step: the trainer's time to enqueue one step."""

from bench_h100.metrics._spans import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "semseg.train.step", "host_s")
