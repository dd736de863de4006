"""Training and evaluation engine: the public names of
``semseg_tpu/engine/__init__.py``, where the port has them under the same
name, and their counterparts where it does not:

- ``SGDState``, ``sgd_init``, ``sgd_update`` → :func:`make_sgd` (a
  ``torch.optim.SGD`` over the two LR groups);
- ``make_lr_mult`` → :func:`param_groups` (the 10x head group);
- ``TrainState``, ``create_train_state``, ``make_train_step`` →
  :class:`Trainer` (the model, its optimizer, the step count and
  ``Trainer.step``);
- ``make_eval_step`` → :func:`eval_step`.
"""

from semseg_torch.engine.losses import cross_entropy_mean, cross_entropy_sum
from semseg_torch.engine.optim import make_sgd, param_groups, poly_lr
from semseg_torch.engine.trainer import Trainer, eval_step
from semseg_torch.engine.evaluator import SlidingWindowEvaluator

__all__ = [
    "cross_entropy_mean",
    "cross_entropy_sum",
    "make_sgd",
    "param_groups",
    "poly_lr",
    "Trainer",
    "eval_step",
    "SlidingWindowEvaluator",
]
