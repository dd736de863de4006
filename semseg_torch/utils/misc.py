"""Small helpers: copies from ``semseg_tpu/utils/misc.py`` (the port
imports nothing of the JAX package: LR schedules, palette PNGs, directories,
a free port, the logger), the port's device default, cuDNN's deterministic
mode, and the bounded caches of per-shape constants.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading

import numpy as np

# Entries a per-shape cache keeps (resize matrices, kernel taps, window
# coverage, the evaluator's geometries); the least recently used goes first.
# A six-scale image uses 24 resize matrices, so the entries of several
# images fit; a stream of ever new image sizes (ADE20K's validation images,
# a server's clients) no longer grows the device's memory.
CACHE_ENTRIES = 64


def step_learning_rate(base_lr, epoch, step_epoch, multiplier=0.1):
    """Base LR decayed by ``multiplier`` every ``step_epoch`` epochs."""
    return base_lr * (multiplier ** (epoch // step_epoch))


def poly_learning_rate(base_lr, curr_iter, max_iter, power=0.9):
    """``base_lr * (1 - iter/max_iter) ** power`` (reference util.py:34).
    No floor at 0, as the reference; the trainer's schedule is
    ``engine/optim.py::poly_lr``, which floors."""
    return base_lr * (1 - float(curr_iter) / max_iter) ** power


def check_mkdir(dir_name):
    if not os.path.exists(dir_name):
        os.mkdir(dir_name)


def check_makedirs(dir_name):
    os.makedirs(dir_name, exist_ok=True)


def find_free_port() -> int:
    """Pick an OS-assigned free TCP port (a process group's rendezvous)."""
    import socket

    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def colorize(gray: np.ndarray, palette):
    """Palette PNG (PIL 'P' mode) from a uint8 class map.

    ``palette`` is a flat [R0,G0,B0, R1,G1,B1, ...] list or an [N,3] array.
    """
    from PIL import Image

    palette = np.asarray(palette, dtype=np.uint8).reshape(-1).tolist()
    color = Image.fromarray(gray.astype(np.uint8)).convert("P")
    color.putpalette(palette)
    return color


def get_logger(name: str = "main-logger"):
    import logging

    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False  # avoid duplicate lines via the root logger
    handler = logging.StreamHandler()
    fmt = "[%(asctime)s %(levelname)s %(filename)s line %(lineno)d %(process)d] %(message)s"
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)
    return logger


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means ``cuda`` (the
    current CUDA device). The entry points run on the card unless the caller
    names another device: without CUDA, ``None`` raises, and the CPU is
    used only when asked for (``device="cpu"``)."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device given and torch.cuda.is_available() is false: the "
            "port runs on a CUDA device by default; pass device='cpu' to run "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def tracing() -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces the calling
    code: its tensors are then fake or symbolic and must not outlive the
    trace."""
    import torch

    return torch.compiler.is_compiling()


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms and no autotuning inside, the
    caller's two flags after, however the block ends. cuDNN's default f32
    algorithms do not repeat their sums' order from run to run on an H100;
    the deterministic ones do. The flags are the process's."""
    import torch

    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = flags


class LRU:
    """A mapping of at most ``size`` entries: putting one more drops the
    least recently used (read or put). Safe across threads."""

    def __init__(self, size: int = CACHE_ENTRIES):
        self.size = size
        self._entries = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            if key not in self._entries:
                return default
            self._entries.move_to_end(key)
            return self._entries[key]

    def put(self, key, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def values(self):
        with self._lock:
            return list(self._entries.values())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_MISSING = object()


def tensor_cache(fn):
    """``functools.lru_cache(maxsize=CACHE_ENTRIES)`` for functions that
    build constant tensors (resize matrices, kernel taps, window coverage),
    keyed by their hashable arguments. A value is built outside inference
    mode, so that a training step or an export can use it after the
    evaluator built it under ``torch.inference_mode``. While
    :func:`tracing`, a cached value (a real tensor, built eagerly) is
    returned and becomes a constant of the traced program, and a missing one
    is built for the trace and not stored: a cached fake tensor would be
    returned to every later eager call. ``cache_clear()`` empties the cache
    and ``cache`` is the :class:`LRU` itself."""
    import functools

    import torch

    cache = LRU()

    @functools.wraps(fn)
    def wrapper(*args):
        value = cache.get(args, _MISSING)
        if value is not _MISSING:
            return value
        if tracing():
            return fn(*args)
        with torch.inference_mode(False):
            value = fn(*args)
        cache.put(args, value)
        return value

    wrapper.cache = cache
    wrapper.cache_clear = cache.clear
    return wrapper
