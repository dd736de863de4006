"""Named spans at the port's layer boundaries, on the profiler's clock.

``with span("semseg.eval.forward", device):`` marks one stretch of work.
With no ``torch.profiler`` session running, or while ``torch.export`` or
``torch.compile`` traces the code, it is one flag check and a shared no-op:
no ``record_function``, no CUDA event, no tally. While a session runs, each
span is

- a ``record_function`` range, so it lies in the profiler's trace on the
  clock of the kernels and copies it launched;
- a host interval (``time.perf_counter``);
- on a CUDA ``device``, a device interval: a pair of timing events on the
  device's current stream, the stream's time between the span's edges (on
  the CPU the device time is the host time).

Each span knows the span open around it on its thread, so its self time is
its time less its direct children's, on the host and, for children on its
own device, on the device. Closed spans wait, in the order they closed,
until their end event has completed; they are then folded into per-name
sums and their events reused, so a long profiled stretch holds a bounded
number of events.

:func:`tallies` waits for the spans still pending and returns the sums of
the newest profiled stretch: a span that runs with no profiler ends the
stretch, and the next profiled span starts a fresh one. Each span's count
is its counter; the kernels' ``.launches`` are the port's launch counters.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from semseg_torch.utils.misc import tracing

FIELDS = ("count", "host_s", "device_s", "self_host_s", "self_device_s")

_OFF = contextlib.nullcontext()


class _Recorder:
    """The process's tallies: per-name sums, the closed spans whose device
    end may still be pending, spare timing events by CUDA device, and each
    thread's stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sums = {}
        self.pending = collections.deque()
        self.spare = collections.defaultdict(list)
        self.local = threading.local()
        self.stale = False  # set by a span run without a profiler

    def stack(self):
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def events(self, index):
        with self.lock:
            spare = self.spare[index]
            if len(spare) >= 2:
                return spare.pop(), spare.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def begin(self):
        """A profiled span opens: after spans that ran unprofiled, the
        stretch starts afresh."""
        if self.stale:
            with self.lock:
                if self.stale:
                    self.sums.clear()
                    for s in self.pending:
                        s.release(self.spare)
                    self.pending.clear()
                    self.stale = False

    def close(self, s):
        with self.lock:
            self.pending.append(s)
            self.fold(wait=False)

    def fold(self, wait):
        """Fold the pending spans, oldest first, up to the first whose end
        has not completed (``wait``: all of them). The caller holds the
        lock."""
        while self.pending:
            s = self.pending[0]
            if s.end is not None:
                if wait:
                    s.end.synchronize()
                elif not s.end.query():
                    return
                device_s = s.start.elapsed_time(s.end) / 1e3
                s.release(self.spare)
            else:
                device_s = s.host_s
            self.pending.popleft()
            t = self.sums.setdefault(s.name, [0, 0.0, 0.0, 0.0, 0.0])
            t[0] += 1
            t[1] += s.host_s
            t[2] += device_s
            t[3] += s.host_s - s.child_host_s
            t[4] += device_s - s.child_device_s
            p, s.parent = s.parent, None
            if p is not None:
                p.child_host_s += s.host_s
                if p.key == s.key:
                    p.child_device_s += device_s


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "key", "index", "parent", "range", "stream", "start", "end",
                 "t0", "host_s", "child_host_s", "child_device_s")

    def __init__(self, name, device):
        device = torch.device(device)
        self.name = name
        self.index = None
        if device.type == "cuda":
            self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.key = self.index if self.index is not None else "host"
        self.start = self.end = None
        self.child_host_s = self.child_device_s = 0.0

    def __enter__(self):
        rec = _RECORDER
        rec.begin()
        stack = rec.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.index is not None:
            self.start, self.end = rec.events(self.index)
            self.stream = torch.cuda.current_stream(self.index)
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.end is not None:
            self.end.record(self.stream)
            self.stream = None
        self.host_s = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        self.range = None
        _RECORDER.stack().pop()
        _RECORDER.close(self)
        return False

    def release(self, spare):
        if self.end is not None:
            spare[self.index] += [self.start, self.end]
            self.start = self.end = None


def span(name: str, device):
    """A context manager marking ``name``'s work on ``device`` (a CUDA
    device's current stream times it; elsewhere the host's clock): while a
    profiler runs, a ``record_function`` range and a tally; otherwise a
    shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        _RECORDER.stale = True
        return _OFF
    if tracing():
        return _OFF
    return _Span(name, device)


def tallies() -> dict:
    """``{name: {"count", "host_s", "device_s", "self_host_s",
    "self_device_s"}}`` over the newest profiled stretch, after waiting for
    the spans whose device end is still pending. Spans still open are not
    counted."""
    rec = _RECORDER
    with rec.lock:
        rec.fold(wait=True)
        return {name: dict(zip(FIELDS, t)) for name, t in rec.sums.items()}
