"""``idle_share.train``: Percent of the traced window in which no operation ran on the device: 1 - (union of kernel, copy and set intervals) / (host-clock window ending in a synchronise)."""

from bench_h100.metrics._common import idle_percent


def read(ctx):
    return idle_percent(ctx)
