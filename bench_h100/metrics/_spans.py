"""Shared arithmetic of the readers of the program's own spans
(``semseg_torch/utils/trace.py``; not a metric: no entry of
``BENCHMARK.json`` names it)."""


def span_ms_per_unit(ctx, name, field):
    """Milliseconds of a span's tally ``field`` (``device_s``,
    ``self_device_s``, ``host_s``) per image or step of the traced window,
    which is the process's only profiled stretch. None when the window did
    no unit of work, or when the program has no spans (a checkout before
    them). Raises when the work was done and the span has no tally: a span
    renamed in the program would otherwise read nothing."""
    units = ctx.work["units"]
    if not units:
        return None
    try:
        from semseg_torch.utils.trace import tallies
    except ModuleNotFoundError as e:
        if e.name != "semseg_torch.utils.trace":
            raise
        return None
    tally = tallies().get(name)
    if not tally or not tally["count"]:
        raise RuntimeError(
            f"the window did {units} {ctx.work['unit']}(s) and the program's span {name!r} "
            "has no tally: the span was renamed or taken off the path")
    return 1e3 * tally[field] / units
