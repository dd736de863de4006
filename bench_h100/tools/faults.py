"""Faults planted under the timed path, for the checks that ``correct``
catches them (``tests/test_bench_faults.py``, ``tools/calibrate.py
--fault``). Each is a context manager that patches the program while it
is open.

- ``frozen``: every optimizer step returns the state unchanged;
- ``half_batch``: each training step sees the first half of its batch
  (the loss is the mean over the rest);
- ``altered``: each served class map has a block of its pixels moved to
  the next class where the map is produced.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def frozen():
    step = torch.optim.SGD.step
    torch.optim.SGD.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.SGD.step = step


@contextlib.contextmanager
def half_batch():
    from semseg_torch.engine.trainer import Trainer

    step = Trainer.step

    def half(self, images, labels):
        b = images.shape[0] // 2
        return step(self, images[:b], labels[:b])

    Trainer.step = half
    try:
        yield
    finally:
        Trainer.step = step


@contextlib.contextmanager
def altered(block=64):
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator

    predict = SlidingWindowEvaluator.predict_async

    def wrong(self, image):
        out = predict(self, image).clone()
        out[:block, :block] = (out[:block, :block] + 1) % self.classes
        return out

    SlidingWindowEvaluator.predict_async = wrong
    try:
        yield
    finally:
        SlidingWindowEvaluator.predict_async = predict


FAULTS = {"frozen": frozen, "half_batch": half_batch, "altered": altered}
