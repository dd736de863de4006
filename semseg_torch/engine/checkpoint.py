"""Checkpoint save and resume for the port, on ``torch.save`` /
``torch.load``.

The counterpart of ``semseg_tpu/engine/checkpoint.py`` without orbax:
- ``train_epoch_{N}.pth`` holds ``{"epoch", "step", "state_dict",
  "optimizer"}``: plain tensors, ints, floats, lists and dicts only, so
  ``torch.load(weights_only=True)`` reads it (the port's loader does, and so
  does the JAX package's ``load_torch_checkpoint``, ``convert.py:166-173``).
  ``state_dict`` is in reference naming, as any reference ``.pth``;
- keep-2 rotation (``:71-94``): an epoch save deletes the save
  ``save_freq * keep`` epochs older, and the preemption snapshot;
- async saves (``:116-187``): a host snapshot of the state dicts on the
  caller's thread, then the write on a worker thread; a worker's error is
  raised again at the next ``wait_pending``;
- the preemption snapshot ``train_preempt.pth`` (``:190-216``) and
  ``latest_checkpoint`` (``:219-265``): the snapshot first, then the highest
  epoch;
- completion (``:54-71``): every file is written as ``<name>.tmp`` and
  renamed into place with ``os.replace``, so a save killed mid-write never
  becomes the resume source; ``latest_checkpoint`` skips ``*.tmp`` files
  and logs the skip;
- ``load_state_dict_any`` (``load_model_variables``, ``:330-348``): a
  reference ``.pth``, a DDP ``module.`` ``.pth`` or a port checkpoint gives a
  state_dict. The port never reads orbax: a JAX checkpoint directory raises
  and names the JAX package's ``.pth`` exporter.

A training state is the dict of ``Trainer.state_dict()``: ``{"step",
"state_dict", "optimizer"}``, whose state_dict is the model's own (never
DDP's ``module.``). Over several DDP ranks the training driver saves on
rank 0 alone and resolves ``latest_checkpoint`` there
(``semseg_torch/train.py``).
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Optional

import torch

TMP_SUFFIX = ".tmp"
_EPOCH_FILE = re.compile(r"train_epoch_(\d+)\.pth")
_log = logging.getLogger(__name__)


def checkpoint_path(save_path: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(save_path), f"train_epoch_{epoch}.pth")


def preempt_checkpoint_path(save_path: str) -> str:
    return os.path.join(os.path.abspath(save_path), "train_preempt.pth")


def host_snapshot(obj):
    """``obj`` (nested dicts and lists of tensors and scalars) with every
    tensor copied, detached, to the CPU: a copy the next train step cannot
    change."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_snapshot(v) for v in obj)
    return obj


def _write(payload: dict, path: str) -> str:
    """``torch.save`` to ``path + '.tmp'``, then rename into place."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + TMP_SUFFIX
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _remove(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def _write_epoch(save_path: str, epoch: int, snap: dict, save_freq: int, keep: int) -> str:
    path = _write({"epoch": int(epoch), **snap}, checkpoint_path(save_path, epoch))
    old = epoch - save_freq * keep
    if old > 0:
        _remove(checkpoint_path(save_path, old))
    # An end-of-epoch save supersedes any mid-epoch preemption snapshot.
    _remove(preempt_checkpoint_path(save_path))
    return path


def save_checkpoint(save_path: str, epoch: int, state: dict, save_freq: int = 1,
                    keep: int = 2) -> str:
    """Save ``state`` at ``epoch`` (1-based, like the reference) and prune."""
    return _write_epoch(save_path, epoch, host_snapshot(state), save_freq, keep)


class AsyncSaver:
    """One in-flight async checkpoint save. Instances are independent, so
    concurrent trainers can each own a saver."""

    def __init__(self):
        self._pending: Optional[threading.Thread] = None
        self._error: list = []

    def wait_pending(self) -> None:
        """Join the in-flight save, raising its error again if it failed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error:
            raise self._error.pop()

    def save_async(self, save_path: str, epoch: int, state: dict, save_freq: int = 1,
                   keep: int = 2) -> str:
        """Like :func:`save_checkpoint`, but returns once the state is
        copied to the host; the write and the pruning run on a worker
        thread."""
        self.wait_pending()
        snap = host_snapshot(state)
        error = self._error

        def worker():
            try:
                _write_epoch(save_path, epoch, snap, save_freq, keep)
            except BaseException as exc:  # raised by wait_pending()
                error.append(exc)

        self._pending = threading.Thread(target=worker, daemon=True)
        self._pending.start()
        return checkpoint_path(save_path, epoch)


_default_saver = AsyncSaver()


def wait_pending() -> None:
    """Join the default saver's in-flight save (module-level API)."""
    _default_saver.wait_pending()


def save_checkpoint_async(save_path: str, epoch: int, state: dict, save_freq: int = 1,
                          keep: int = 2) -> str:
    return _default_saver.save_async(save_path, epoch, state, save_freq, keep)


def save_preempt_checkpoint(save_path: str, epoch: int, state: dict) -> str:
    """Mid-epoch snapshot on preemption. ``epoch`` is the 0-based epoch in
    progress (the count of completed epochs): resume fast-forwards the
    loader past ``step - epoch * steps_per_epoch`` batches of it."""
    return _write({"epoch": int(epoch), **host_snapshot(state)},
                  preempt_checkpoint_path(save_path))


def latest_checkpoint(save_path: str) -> Optional[str]:
    """The newest complete checkpoint in ``save_path``: the preemption
    snapshot if there is one (epoch saves delete it), else the highest
    epoch. ``*.tmp`` files, left by a save killed mid-write, are skipped
    with a warning."""
    if not os.path.isdir(save_path):
        return None
    names = sorted(os.listdir(save_path))
    partial = [n for n in names if n.endswith(TMP_SUFFIX)]
    if partial:
        _log.warning("skipping incomplete checkpoint(s) %s (a save killed mid-write)",
                     [os.path.join(save_path, n) for n in partial])
    preempt = preempt_checkpoint_path(save_path)
    if os.path.isfile(preempt):
        return preempt
    epochs = [(int(m.group(1)), n) for n in names if (m := _EPOCH_FILE.fullmatch(n))]
    if not epochs:
        return None
    return os.path.join(save_path, max(epochs)[1])


def load_checkpoint(path: str) -> dict:
    """A port checkpoint as written by the functions above, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_dict_any(path: str) -> dict:
    """A model state_dict from a reference ``.pth``, a DDP ``module.``
    ``.pth`` or a port checkpoint (``module.`` stripped, on the CPU). A JAX
    checkpoint directory (orbax, ``*.ckpt/``) raises: export it to ``.pth``
    with the JAX package first."""
    from semseg_torch.models.convert import load_pth

    if os.path.isdir(path):
        raise ValueError(
            f"'{path}' is a directory (a JAX orbax checkpoint?); the port reads .pth "
            "files only. Export it with the JAX package: python tool/export.py --config "
            f"<config> model_path {path} export_path <out>.pth export_format pth")
    return load_pth(path)
