"""``stitch_roofline.serve``: Percent of the fused stitch's least time (each chunk's bf16 logits read once, its probabilities written once, at 3.35 TB/s) in its kernels' device time; silent when the kernel did not run."""

from bench_h100.metrics._common import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "stitch", "stitch_bound_ms_per_unit")
