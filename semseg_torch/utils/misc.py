"""Small helpers copied from ``semseg_tpu/utils/misc.py``.

They are copies rather than imports because ``semseg_tpu.utils`` imports
``jax`` through its package ``__init__`` (``utils/metrics.py``).
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
