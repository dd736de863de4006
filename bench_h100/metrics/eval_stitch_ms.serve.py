"""``eval_stitch_ms.serve``: Device ms per image in the program's span semseg.eval.stitch: each chunk's logits to window probabilities (the fused stitch with its stack and cast, or softmax and flip average)."""

from bench_h100.metrics._spans import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "semseg.eval.stitch", "device_s")
