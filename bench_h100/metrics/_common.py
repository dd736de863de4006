"""Shared arithmetic of the per-layer readers (not a metric: no entry of
``BENCHMARK.json`` names it)."""

from bench_h100.harness import work


def class_ms_per_unit(ctx, cls):
    """Device milliseconds of a kernel class per image or step of the
    traced window; None when the window did no unit of work."""
    units = ctx.work["units"]
    if not units:
        return None
    return 1e3 * ctx.trace.class_s.get(cls, 0.0) / units


def idle_percent(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu_percent(ctx):
    """The FLOPs the traced window's work needs over its seconds, against the
    peak of the cell's compute dtype."""
    rate = ctx.work["units"] / ctx.trace.window_s
    return 100.0 * ctx.work["flops_per_unit"] * rate / work.peak_flops(ctx.work["dtype"])


def roofline_percent(ctx, cls, bound_key):
    """The least time of a class's work (from the cell's shapes) over its
    device time; None when the shapes say the kernel is off the path (no
    bound) or the window did no unit of work. Raises when the shapes say
    the work was done and no kernel of the class ran: a kernel renamed out
    of ``kernel_classes.json`` would otherwise run unseen."""
    bound_ms = ctx.work.get(bound_key)
    if bound_ms is None or not ctx.work["units"]:
        return None
    seconds = ctx.trace.class_s.get(cls, 0.0)
    if not ctx.trace.class_count.get(cls) or seconds <= 0:
        raise RuntimeError(
            f"{bound_key} is set, so the {cls!r} kernels ran, and no kernel of the "
            f"class {cls!r} is in the trace: kernel_classes.json misses its name")
    return 100.0 * bound_ms * ctx.work["units"] / 1e3 / seconds
