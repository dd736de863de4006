"""Small helpers: copies from ``semseg_tpu/utils/misc.py`` (the port
imports nothing of the JAX package), and the port's device default.
"""

from __future__ import annotations

import os

import numpy as np


def check_makedirs(dir_name):
    os.makedirs(dir_name, exist_ok=True)


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


def tensor_cache(fn):
    """``functools.lru_cache`` for functions that build constant tensors
    (resize matrices, kernel taps, window coverage), keyed by their
    hashable arguments. A value is built outside inference mode, so that a
    training step or an export can use it after the evaluator built it
    under ``torch.inference_mode``. While :func:`tracing`, a cached value
    (a real tensor, built eagerly) is returned and becomes a constant of
    the traced program, and a missing one is built for the trace and not
    stored: a cached fake tensor would be returned to every later eager
    call. ``cache_clear()`` empties the cache and ``cache`` is the dict
    itself."""
    import functools

    import torch

    cache = {}

    @functools.wraps(fn)
    def wrapper(*args):
        if args in cache:
            return cache[args]
        if tracing():
            return fn(*args)
        with torch.inference_mode(False):
            cache[args] = fn(*args)
        return cache[args]

    wrapper.cache = cache
    wrapper.cache_clear = cache.clear
    return wrapper
