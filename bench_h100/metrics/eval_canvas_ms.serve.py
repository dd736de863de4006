"""``eval_canvas_ms.serve``: Self device ms per image of the program's span semseg.eval.image (upload to the queued argmax) less its forward and stitch spans: resizes, canvas, windows, accumulate, scale sum, argmax, and idle inside a request."""

from bench_h100.metrics._spans import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "semseg.eval.image", "self_device_s")
