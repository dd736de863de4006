"""Utilities: metrics, meters, schedules, IO helpers; the public names of
``semseg_tpu/utils/__init__.py``. The port's one histogram function runs
on tensors on their device, so it stands for both of JAX's: the numpy one
(``intersection_and_union``) and the in-step one
(``intersection_and_union_jax``)."""

from semseg_torch.utils.metrics import AverageMeter, intersection_and_union
from semseg_torch.utils.misc import (
    check_makedirs,
    colorize,
    poly_learning_rate,
    step_learning_rate,
)

intersection_and_union_jax = intersection_and_union

__all__ = [
    "AverageMeter",
    "intersection_and_union",
    "intersection_and_union_jax",
    "check_makedirs",
    "colorize",
    "poly_learning_rate",
    "step_learning_rate",
]
