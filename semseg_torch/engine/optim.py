"""SGD parameter groups and the poly learning rate.

Port of ``semseg_tpu/engine/optim.py``. The reference trains with two LR
groups, the backbone at ``base_lr`` and the new modules (ppm/psa/cls/aux)
at ``10 * base_lr``, with the poly schedule applied to both every
iteration (``tool/train.py:134-140, 299-304``). ``torch.optim.SGD`` is the
update order the JAX package reimplements (``optim.py:34-55``): weight
decay and momentum fold into the gradient before the LR multiply.
"""

from __future__ import annotations

import torch

NEW_MODULE_PREFIXES = ("ppm", "psa", "cls", "aux")


def param_groups(model: torch.nn.Module, base_lr: float,
                 new_module_lr_mult: float = 10.0):
    """Two groups by top-level module name: backbone 1x, new modules
    ``new_module_lr_mult`` x (JAX ``make_lr_mult``). Each group carries its
    ``lr_mult`` for :func:`set_lr`."""
    old, new = [], []
    for name, p in model.named_parameters():
        (new if name.split(".", 1)[0] in NEW_MODULE_PREFIXES else old).append(p)
    return [{"params": old, "lr": base_lr, "lr_mult": 1.0},
            {"params": new, "lr": base_lr * new_module_lr_mult,
             "lr_mult": new_module_lr_mult}]


def make_sgd(model: torch.nn.Module, base_lr: float, momentum: float = 0.9,
             weight_decay: float = 1e-4) -> torch.optim.SGD:
    return torch.optim.SGD(param_groups(model, base_lr), lr=base_lr,
                           momentum=momentum, weight_decay=weight_decay)


def poly_lr(base_lr: float, step: int, max_iter: int, power: float = 0.9) -> float:
    """``base_lr * (1 - step / max_iter) ** power``, floored at 0."""
    return base_lr * max(1.0 - step / max_iter, 0.0) ** power


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Install the scheduled base LR in every group, times its multiplier."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
