"""``eval_host_ms.serve``: Host ms per image in the program's span semseg.eval.image: the evaluator's time to enqueue one request, upload to the queued argmax."""

from bench_h100.metrics._spans import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "semseg.eval.image", "host_s")
