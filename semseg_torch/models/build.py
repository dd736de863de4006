"""Model construction from experiment configs.

Port of ``semseg_tpu/models/build.py`` for ``arch: psp``. ``cfg`` is any
object with the config keys as attributes (``semseg_tpu.config.Config``
or a plain namespace).
"""

from __future__ import annotations

import torch

from semseg_torch.models.layers import set_precision
from semseg_torch.models.pspnet import PSPNet


def validate_arch(cfg):
    """Architecture/shape invariants of the config (as in the JAX package)."""
    if cfg.classes <= 1:
        raise ValueError("classes must be > 1")
    if cfg.zoom_factor not in (1, 2, 4, 8):
        raise ValueError(f"zoom_factor={cfg.zoom_factor} not in (1,2,4,8)")
    if cfg.arch not in ("psp", "psa"):
        raise ValueError(f"architecture {cfg.arch!r} not supported")
    if (cfg.train_h - 1) % 8 != 0 or (cfg.train_w - 1) % 8 != 0:
        raise ValueError("(train_h-1) and (train_w-1) must be multiples of 8")


def build_model(cfg, dtype: torch.dtype = torch.float32, device=None,
                seed: int = 0) -> PSPNet:
    """The eval-mode model described by ``cfg`` on ``device``, with seeded
    random weights (load a checkpoint over them to serve real ones).
    float32 models also turn TF32 off (``layers.set_precision``)."""
    validate_arch(cfg)
    if cfg.arch == "psa":
        raise NotImplementedError(
            "arch 'psa' (PSANet) is not ported yet: ROADMAP queue 1 item 10")
    set_precision(dtype)
    model = PSPNet(layers=cfg.layers, classes=cfg.classes,
                   zoom_factor=cfg.zoom_factor, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device or "cpu").eval()
