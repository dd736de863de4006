"""``eval_forward_ms.serve``: Device ms per image in the program's span semseg.eval.forward: the model's calls on the windows, the stream's time between each span's edges."""

from bench_h100.metrics._spans import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "semseg.eval.forward", "device_s")
