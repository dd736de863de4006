"""The port's spans (``semseg_torch/utils/trace.py``): a shared no-op with
no profiler; under ``torch.profiler`` a ``record_function`` range and a
tally with self times; a fresh tally for each profiled stretch; the spans
the evaluator and the trainer open; none in an exported graph. CPU, tiny
shapes; the ``cuda``-marked test needs a card."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from semseg_torch.engine import evaluator as teval
from semseg_torch.engine import export, optim, trainer
from semseg_torch.utils import trace
from semseg_torch.utils.trace import span, tallies

CROP, BASE, CLASSES = 17, 32, 5
SCALES = [0.75, 1.25]


class _TinyNet(torch.nn.Module):
    """Two 3x3 convolutions, logits at the window's size; in train mode a
    second head stands for the auxiliary one."""

    dtype = torch.float32
    zoom_factor = 1

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.a = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.b = torch.nn.Conv2d(8, CLASSES, 3, padding=1)
        self.aux = torch.nn.Conv2d(8, CLASSES, 1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)

    def forward(self, x, zoom=True):
        h = torch.relu(self.a(x))
        return (self.b(h), self.aux(h)) if self.training else self.b(h)


def _evaluator():
    return teval.SlidingWindowEvaluator(
        _TinyNet(), classes=CLASSES, crop_h=CROP, crop_w=CROP, mean=[120.0, 110.0, 100.0],
        std=[60.0, 60.0, 60.0], base_size=BASE, scales=SCALES, window_batch=4, device="cpu")


def _image(h=24, w=40, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_off_is_one_shared_noop(monkeypatch):
    """No profiler: every call hands back the same object, which opens no
    ``record_function``, records no CUDA event and keeps no tally."""

    def forbidden(*args, **kwargs):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    first = span("semseg.test.off", "cpu")
    assert span("semseg.test.off.other", "cpu") is first
    for _ in range(3):
        with span("semseg.test.off", torch.device("cuda", 0)):
            pass
    assert "semseg.test.off" not in tallies()


def test_profiled_counts_nesting_and_self_time():
    """Under a CPU profile: counts, the children inside their parent, self
    time the duration less the direct children's (host and device alike: on
    the CPU the device time is the host time), and the names in the
    profiler's events."""
    with _profiled() as prof:
        with span("semseg.test.outer", "cpu"):
            time.sleep(0.01)
            for _ in range(2):
                with span("semseg.test.inner", "cpu"):
                    time.sleep(0.005)
                    with span("semseg.test.leaf", "cpu"):
                        time.sleep(0.002)
    t = tallies()
    outer, inner, leaf = (t[f"semseg.test.{k}"] for k in ("outer", "inner", "leaf"))
    assert (outer["count"], inner["count"], leaf["count"]) == (1, 2, 2)
    for v in (outer, inner, leaf):
        assert v["device_s"] == v["host_s"] > 0
    assert leaf["self_host_s"] == pytest.approx(leaf["host_s"], abs=1e-12)
    assert inner["self_host_s"] == pytest.approx(inner["host_s"] - leaf["host_s"], abs=1e-12)
    assert outer["self_host_s"] == pytest.approx(outer["host_s"] - inner["host_s"], abs=1e-12)
    assert outer["self_device_s"] == pytest.approx(outer["self_host_s"], abs=1e-12)
    assert outer["host_s"] >= inner["host_s"] >= leaf["host_s"] >= 0.004
    assert outer["self_host_s"] >= 0.01
    names = _names(prof)
    assert names.count("semseg.test.inner") == 2 and "semseg.test.outer" in names


def test_second_profiled_stretch_starts_fresh():
    """Spans run with no profiler end a stretch: the next profile's tally
    holds its own spans only, read after it as often as wanted."""
    with _profiled():
        with span("semseg.test.first", "cpu"):
            pass
    assert tallies()["semseg.test.first"]["count"] == 1
    with span("semseg.test.unprofiled", "cpu"):
        pass
    with _profiled():
        for _ in range(3):
            with span("semseg.test.second", "cpu"):
                pass
    t = tallies()
    assert "semseg.test.first" not in t and "semseg.test.unprofiled" not in t
    assert t["semseg.test.second"]["count"] == 3
    assert tallies() == t


@pytest.mark.parametrize("call", ["predict_async", "predict_probs"])
def test_evaluator_request_spans(call):
    """One request: one ``eval.image`` around one ``eval.forward`` and one
    ``eval.stitch`` a chunk over the scales; its self time the rest of the
    request; the prediction the same as unprofiled."""
    ev = _evaluator()
    image = _image()
    want = getattr(ev, call)(image)
    chunks = sum(len(ev._geometry(24, 40, s).chunks) for s in SCALES)
    assert chunks >= 3
    with _profiled() as prof:
        got = getattr(ev, call)(image)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    t = tallies()
    img, fwd, st = (t[f"semseg.eval.{k}"] for k in ("image", "forward", "stitch"))
    assert (img["count"], fwd["count"], st["count"]) == (1, chunks, chunks)
    assert img["self_device_s"] == pytest.approx(
        img["device_s"] - fwd["device_s"] - st["device_s"], abs=1e-9)
    assert 0 < img["self_device_s"] < img["device_s"]
    assert fwd["self_host_s"] == pytest.approx(fwd["host_s"], abs=1e-12)
    names = _names(prof)
    assert names.count("semseg.eval.forward") == chunks
    assert names.count("semseg.eval.image") == 1


def _trainer():
    torch.manual_seed(0)
    model = _TinyNet()
    return trainer.Trainer(model, optim.make_sgd(model, 0.01), classes=CLASSES,
                           ignore_label=255, aux_weight=0.4, base_lr=0.01, max_iter=10,
                           power=0.9, zoom_factor=8)


def test_trainer_step_spans():
    """Two steps: two of each ``train.*`` span, the three parts inside the
    step, and the same losses and weights as two unprofiled steps."""
    rs = np.random.RandomState(1)
    images = torch.from_numpy(rs.randint(0, 256, (2, 17, 17, 3)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, CLASSES, (2, 17, 17)))
    plain, traced = _trainer(), _trainer()
    want = [plain.step(images, labels)["loss"].item() for _ in range(2)]
    with _profiled():
        got = [traced.step(images, labels)["loss"].item() for _ in range(2)]
    assert got == want
    for k, v in plain.module.state_dict().items():
        assert torch.equal(v, traced.module.state_dict()[k]), k
    t = tallies()
    parts = ("forward", "backward", "optimizer")
    for k in ("step",) + parts:
        assert t[f"semseg.train.{k}"]["count"] == 2, k
    step = t["semseg.train.step"]
    children = sum(t[f"semseg.train.{k}"]["host_s"] for k in parts)
    assert step["self_host_s"] == pytest.approx(step["host_s"] - children, abs=1e-9)
    assert 0 <= step["self_host_s"] < step["host_s"]


def test_export_under_a_profiler_holds_no_profiler_op():
    """``torch.export`` of the tiny evaluator's whole program while a
    profiler runs: no profiler operator in the graph, and the trace opened
    no span (only the export's eager warm-up call is tallied)."""
    ev = _evaluator()
    chunks = sum(len(ev._geometry(24, 40, s).chunks) for s in SCALES)
    ev.predict(_image())  # unprofiled: the profile below starts a fresh stretch
    with _profiled():
        exported = export.export_sliding_window(ev, 24, 40)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert tallies()["semseg.eval.forward"]["count"] == chunks


def test_spans_from_many_threads():
    """Threads nesting spans at once, the interpreter switching threads as
    often as it can: every span is counted, each thread's children under
    its own parent."""
    threads, per = 12, 150
    errors = []

    def work():
        try:
            for _ in range(per):
                with span("semseg.test.thread", "cpu"):
                    with span("semseg.test.thread.child", "cpu"):
                        pass
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    t = tallies()
    assert t["semseg.test.thread"]["count"] == t["semseg.test.thread.child"]["count"] \
        == threads * per
    parent, child = t["semseg.test.thread"], t["semseg.test.thread.child"]
    assert parent["self_host_s"] == pytest.approx(parent["host_s"] - child["host_s"],
                                                  abs=1e-9)


@pytest.mark.cuda
def test_cuda_spans_read_the_stream():
    """On the card: a span's device time is its stream's time between its
    edges (a kernel spinning 2N cycles, then N in a child), the parent's
    self time the rest, the host's time only the queueing; a stretch holds
    at most a pair of timing events a span, and one whose spans complete
    as they go reuses them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    cycles = 2_000_000  # ~1 ms
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(dev)
    spare = []
    for wait in (False, True):
        with span("semseg.test.unprofiled", dev):
            pass
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(40):
                with span("semseg.test.cuda", dev):
                    torch.cuda._sleep(2 * cycles)
                    with span("semseg.test.cuda.child", dev):
                        torch.cuda._sleep(cycles)
                if wait:
                    torch.cuda.synchronize(dev)
            t = tallies()
        spare.append(sum(len(v) for v in trace._RECORDER.spare.values()))
        parent, child = t["semseg.test.cuda"], t["semseg.test.cuda.child"]
        assert parent["count"] == child["count"] == 40
        assert 0.25 < child["device_s"] / parent["device_s"] < 0.45
        assert parent["self_device_s"] == pytest.approx(parent["device_s"] - child["device_s"])
        if not wait:
            assert parent["host_s"] < parent["device_s"]  # the host only queued the work
    assert 0 < spare[0] <= 2 * 80 and spare[1] == spare[0]
