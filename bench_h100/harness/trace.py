"""The traced window: ``torch.profiler`` (CPU and CUDA activities) over the
whole window, reduced to what the per-layer readers read.

- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, sets);
- ``window_s``: the host clock from the profiler's start to the
  synchronise that ends the window (idle time at either end counts);
- device seconds by kernel class (``bench_h100/kernel_classes.json``,
  first match; ``other`` where none matches) and by kernel name;
- the longest idle gaps of the device, each named by the host operations
  running at its middle (outermost / innermost).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import time
from pathlib import Path

import numpy as np

CLASSES = Path(__file__).resolve().parents[1] / "kernel_classes.json"


def load_classes(path: Path = CLASSES):
    with open(path) as f:
        return [(name, re.compile(rx)) for name, rx in json.load(f)["classes"]]


def classify(name: str, classes) -> str:
    for cls, rx in classes:
        if rx.search(name):
            return cls
    return "other"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    class_s: dict          # kernel class -> device seconds
    class_count: dict      # kernel class -> launches
    kernels: list          # [(name, class, seconds, count)], most time first
    gaps: list             # [(label, seconds)], longest first

    def breakdown(self, n=10):
        return {"device_ops": [[f"{c}: {k}"[:200], s] for k, c, s, _ in self.kernels[:n]],
                "idle_gaps": [[label[:200], s] for label, s in self.gaps[:n]]}


def _union(intervals):
    busy, cur_s, cur_e = 0.0, *intervals[0]
    gaps = []
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, gaps, intervals[0][0], cur_e


def reduce_events(events, t0_us: float, window_s: float, classes=None,
                  n_gaps: int = 10) -> Trace:
    """``events``: ``(name, is_device, start_us, end_us)`` of one profile,
    the window ``window_s`` long from ``t0_us`` on the profiler's clock."""
    t1_us = t0_us + window_s * 1e6
    classes = load_classes() if classes is None else classes
    device = sorted((s, e, n) for n, dev, s, e in events if dev)
    if not device:
        raise RuntimeError("the profiler recorded no device operation in the window")
    busy_us, gaps, first, last = _union([(s, e) for s, e, _ in device])
    gaps = [(t0_us, first)] + gaps + [(last, t1_us)]
    by_name = {}
    for s, e, n in device:
        sec, cnt = by_name.get(n, (0.0, 0))
        by_name[n] = (sec + (e - s) / 1e6, cnt + 1)
    class_s, class_count, kernels = {}, {}, []
    for n, (sec, cnt) in by_name.items():
        c = classify(n, classes)
        class_s[c] = class_s.get(c, 0.0) + sec
        class_count[c] = class_count.get(c, 0) + cnt
        kernels.append((n, c, sec, cnt))
    kernels.sort(key=lambda k: -k[2])
    host = [(s, e, n) for n, dev, s, e in events if not dev]
    hs = np.array([h[0] for h in host]) if host else np.zeros(0)
    he = np.array([h[1] for h in host]) if host else np.zeros(0)
    longest = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:n_gaps]
    named = []
    for a, b in longest:
        mid = (a + b) / 2
        idx = np.nonzero((hs <= mid) & (he >= mid))[0]
        if len(idx):
            spans = sorted(idx, key=lambda i: he[i] - hs[i])
            label = f"{host[spans[-1]][2]} / {host[spans[0]][2]}"
        else:
            label = "no host operation"
        named.append((label, (b - a) / 1e6))
    return Trace(window_s, busy_us / 1e6, class_s, class_count, kernels, named)


class Profiled:
    """``with Profiled(sync) as p:`` around the window; ``p.trace`` after.
    The window ends with a synchronise inside the profile. ``on_cpu`` (the
    CPU rehearsal only): the CPU is the device, its ``aten::`` operations
    the device operations."""

    def __init__(self, sync, on_cpu=False):
        self.sync = sync
        self.on_cpu = on_cpu
        self.trace = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([] if self.on_cpu else [ProfilerActivity.CUDA])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        self.trace = reduce_events(*self._events(), window_s=window_s)
        return False

    def _events(self):
        """``(name, is_device, start_us, end_us)`` of every event, and the
        window's start on the same clock: the profiler's raw events, which
        take seconds to read where its parsed ``events()`` take minutes."""
        from torch.autograd import DeviceType

        def on_device(name, device_type, annotation):
            if self.on_cpu:
                return name.startswith("aten::")
            # record_function ranges also appear on the device's timeline
            # (user annotations): they are spans, not operations.
            return (device_type == DeviceType.CUDA and not annotation
                    and not name.startswith("bench."))

        raw = self._prof.profiler.kineto_results.events()
        events = [(e.name(), on_device(e.name(), e.device_type(), e.is_user_annotation()),
                   e.start_ns() / 1e3, e.end_ns() / 1e3) for e in raw]
        return events, min(s for _, _, s, _ in events)


@contextlib.contextmanager
def span(name: str):
    """A named host span in the trace (``record_function``), nothing
    when no profile runs."""
    from torch.profiler import record_function

    with record_function(name):
        yield
