"""``psa_roofline.train``: Percent of the PSA forward, dx and da least time (2 each a step at the cell's (N, C, hw)) in the PSA kernels' device time, packs included; silent when no PSA kernel ran."""

from bench_h100.metrics._common import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "psa", "psa_bound_ms_per_unit")
