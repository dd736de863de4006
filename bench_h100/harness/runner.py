"""One run of one cell: the driver, the metrics it reports, ``correct``
and the result line's pieces. ``run.py`` is the command around it."""

from __future__ import annotations

import contextlib
import math
import time
from types import SimpleNamespace

import torch

from bench_h100.harness import manifest
from bench_h100.harness.trace import Profiled

GIB = 2 ** 30


class Context:
    """What a driver gets: the cell, the seed, the window's length, the
    device, and the hooks that mark set-up's end, open the window (traced
    or not), read the memory peak and free the program's memory."""

    def __init__(self, cell, seed, seconds, trace, device, t_start, control=None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.control = control
        self.setup_s = None
        self.peak = 0

    @property
    def cuda(self):
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def setup_done(self):
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def window(self):
        if self.trace:
            return Profiled(self.sync, on_cpu=not self.cuda)
        return contextlib.nullcontext(SimpleNamespace(trace=None))

    def read_peak(self):
        if self.cuda:
            self.peak = torch.cuda.max_memory_allocated(self.device)

    def free(self):
        if self.cuda:
            torch.cuda.empty_cache()


def judge(numbers: dict, limits: dict, attempted: int, failed: int):
    """``(correct, compared)``: every number that ``limits`` names at or
    under its limit (a number that is not finite fails), something
    attempted, nothing failed. ``compared`` maps each name to its value and
    limit; the driver's other numbers are readings only."""
    compared = {}
    ok = attempted > 0 and failed == 0
    for name, (value, detail) in numbers.items():
        if name not in limits:
            continue
        limit = limits[name]["limit"]
        compared[name] = {"value": value, "limit": limit, "at": detail}
        ok = ok and math.isfinite(value) and value <= limit
    for name in limits:
        if name not in numbers:
            raise KeyError(f"the limits name {name!r}, which the driver did not compare")
    return ok, compared


def execute(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, control=None):
    """Run the cell once. Returns ``(result, extra)``: the result line's
    keys, and what only a calibration reads (the control's numbers)."""
    ctx = Context(cell, seed, seconds, trace, device, t_start, control)
    if ctx.cuda:
        torch.cuda.set_device(ctx.device)
        torch.empty(0, device=ctx.device)  # the allocator exists before its stats reset
        torch.cuda.reset_peak_memory_stats(ctx.device)
    out = manifest.driver(cell.driver).run(ctx)
    correct, compared = judge(out["numbers"], cell.limits, out["attempted"], out["failed"])
    measured = {**out["e2e"], "setup_s": ctx.setup_s, "peak_mem_gib": ctx.peak / GIB}
    metrics = {}
    if trace:
        read_ctx = SimpleNamespace(cell=cell, trace=out["trace"], work=out["work"],
                                   e2e=out["e2e"])
        for m in cell.per_layer:
            value = manifest.reader(m["name"]).read(read_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": ctx.peak}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out["trace"].busy_s
        dev["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    result["compared"] = compared
    return result, {"control": out["control"], "measured": measured, "work": out["work"],
                    "numbers": out["numbers"]}
