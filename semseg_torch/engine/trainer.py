"""The training and validation steps on one GPU.

Port of ``semseg_tpu/engine/trainer.py:42-232`` (``make_train_step``,
``make_eval_step``):
device normalisation of raw-pixel images, the label downscale for
``zoom_factor != 8``, main + ``aux_weight`` * aux cross-entropy with the
DDP per-replica mean, backward, the poly LR installed before step k
(step 0 runs at ``base_lr``), the SGD step, and argmax histograms. The
metrics dict has the JAX step's keys and stays on the device.

Images arrive as the host loader emits them, NHWC ``[B, H, W, 3]``
(normalised float, or raw pixels with ``normalize``), and are laid out
channels-first on the device. Dropout draws from one ``torch.Generator``
on the model's device, reseeded every step from ``(rng_seed, step)``, the
counterpart of JAX's ``fold_in(PRNGKey(seed), step)``; the two streams
differ, so parity tests keep dropout off. Restoring ``step_count``
(:meth:`Trainer.load_state_dict`) restores the dropout stream.
"""

from __future__ import annotations

import numpy as np
import torch

from semseg_torch.engine.losses import cross_entropy_sum, nll_and_valid
from semseg_torch.engine.optim import poly_lr, set_lr
from semseg_torch.models.layers import Dropout2d
from semseg_torch.ops.resize import resize_bilinear_align_corners_cf
from semseg_torch.utils.metrics import intersection_and_union


def downscale_labels(labels, zoom_factor: int):
    """Labels on the logits grid ``(H-1)//8*zoom+1`` for ``zoom_factor !=
    8`` (reference ``tool/train.py:262-266``): float labels resized
    bilinearly with align_corners and truncated back to integers."""
    h = (labels.shape[1] - 1) // 8 * zoom_factor + 1
    w = (labels.shape[2] - 1) // 8 * zoom_factor + 1
    lab = resize_bilinear_align_corners_cf(labels.float()[:, None], (h, w))[:, 0]
    return lab.long()


def device_normalize(images, normalize=None):
    """NHWC images -> NCHW float32, ``(x - mean) / std`` when ``normalize``
    is ``(mean, std)`` (raw-pixel wire formats)."""
    images = images.float()
    if normalize is not None:
        mean, std = (torch.tensor(v, dtype=torch.float32, device=images.device)
                     for v in normalize)
        images = (images - mean) / std
    return images.permute(0, 3, 1, 2)


def replica_mean_ce(logits, labels, num_replicas: int, ignore_index: int):
    """Mean over replicas of each replica's valid-pixel-mean CE (DDP
    semantics; JAX ``trainer.py:92-109``). ``logits`` ``[B, C, H, W]``,
    ``B`` divisible by ``num_replicas``."""
    b = logits.shape[0]
    if b % num_replicas:
        raise ValueError(f"batch {b} not divisible by {num_replicas} replicas")
    nll, valid = nll_and_valid(logits, labels, ignore_index)
    group_sum = (nll * valid).reshape(num_replicas, -1).sum(1)
    group_cnt = valid.reshape(num_replicas, -1).sum(1).clamp_min(1.0)
    return (group_sum / group_cnt).mean()


@torch.no_grad()
def eval_step(model, images, labels, *, classes: int, ignore_label: int,
              zoom_factor: int, normalize=None):
    """Center-crop validation step (JAX ``make_eval_step``,
    ``trainer.py:206-232``; reference ``tool/train.py:343-406``): an
    eval-mode forward, for ``zoom_factor != 8`` the logits resized to the
    labels (align corners), the CE sum and valid count, and argmax
    histograms. Returns ``loss_sum``, ``valid_count`` and the
    ``intersection``/``union``/``target`` histograms, on the device. The
    caller sets the model's mode."""
    device = next(model.parameters()).device
    images = device_normalize(images.to(device, non_blocking=True), normalize)
    labels = labels.to(device, non_blocking=True).long()
    logits = model(images)
    if zoom_factor != 8:
        logits = resize_bilinear_align_corners_cf(logits, tuple(labels.shape[1:]))
    loss_sum, count = cross_entropy_sum(logits, labels, ignore_label)
    inter, union, target = intersection_and_union(logits.argmax(1), labels, classes,
                                                  ignore_label)
    return {"loss_sum": loss_sum, "valid_count": count, "intersection": inter,
            "union": union, "target": target}


def dropout_seed(rng_seed: int, step: int) -> int:
    """The per-step dropout seed, a function of ``(rng_seed, step)`` only."""
    return int(np.random.SeedSequence([rng_seed, step]).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """Owns the model (in train mode), its optimizer, the step counter and
    the dropout generator; :meth:`step` is one training iteration."""

    def __init__(self, model, optimizer, *, classes: int, ignore_label: int,
                 aux_weight: float, base_lr: float, max_iter: int, power: float,
                 zoom_factor: int, rng_seed: int = 0, normalize=None):
        self.model = model.train()
        self.optimizer = optimizer
        self.classes = classes
        self.ignore_label = ignore_label
        self.aux_weight = aux_weight
        self.base_lr = base_lr
        self.max_iter = max_iter
        self.power = power
        self.zoom_factor = zoom_factor
        self.rng_seed = rng_seed
        self.normalize = normalize
        self.step_count = 0
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device)
        for m in model.modules():
            if isinstance(m, Dropout2d):
                m.generator = self.generator

    def state_dict(self) -> dict:
        """``{"step", "state_dict", "optimizer"}``: what a checkpoint holds
        (``engine/checkpoint.py``), live tensors on the model's device."""
        return {"step": self.step_count, "state_dict": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restore model, optimizer and step count (and with it the poly LR
        and the dropout stream) from :meth:`state_dict` or a checkpoint."""
        self.model.load_state_dict(state["state_dict"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])

    def validate_step(self, images, labels):
        """:func:`eval_step` on the trainer's model in eval mode; the model
        goes back to train mode after."""
        self.model.eval()
        try:
            return eval_step(self.model, images, labels, classes=self.classes,
                             ignore_label=self.ignore_label, zoom_factor=self.zoom_factor,
                             normalize=self.normalize)
        finally:
            self.model.train()

    def step(self, images, labels):
        """One iteration on a batch (tensors on any device; NHWC images,
        ``[B, H, W]`` integer labels). Returns the metrics dict: ``loss``,
        ``main_loss``, ``aux_loss`` (0-d tensors), ``lr`` (float) and the
        ``intersection``/``union``/``target`` histograms."""
        images = device_normalize(images.to(self.device, non_blocking=True),
                                  self.normalize)
        labels = labels.to(self.device, non_blocking=True)
        if self.zoom_factor != 8:
            labels = downscale_labels(labels, self.zoom_factor)
        labels = labels.long()

        lr = poly_lr(self.base_lr, self.step_count, self.max_iter, self.power)
        set_lr(self.optimizer, lr)
        self.generator.manual_seed(dropout_seed(self.rng_seed, self.step_count))
        self.model.train()
        logits, aux = self.model(images)
        # One replica: DDP's per-replica mean is the batch's valid-pixel mean.
        main_loss = replica_mean_ce(logits, labels, 1, self.ignore_label)
        aux_loss = replica_mean_ce(aux, labels, 1, self.ignore_label)
        loss = main_loss + self.aux_weight * aux_loss
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step_count += 1

        with torch.no_grad():
            inter, union, target = intersection_and_union(
                logits.argmax(1), labels, self.classes, self.ignore_label)
        return {"loss": loss.detach(), "main_loss": main_loss.detach(),
                "aux_loss": aux_loss.detach(), "lr": lr, "intersection": inter,
                "union": union, "target": target}
