"""The training and validation steps, in one process or as one rank of a
data-parallel group.

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

One process computes what ``make_train_step(num_replicas=N)`` computes
with ``Trainer(num_replicas=N)``: the loss is the mean over N equal batch
slices of each slice's valid-pixel mean (BatchNorm's groups are the
model's, ``build_model(replicas=N)``). With a ``process_group`` the
Trainer is one rank of a ``DistributedDataParallel`` run: its loss is the
mean over its own batch, DDP averages the gradients over the ranks (the
reference's ``tool/train.py:269-276``), the logged losses are the mean
over the ranks and the histograms their sum (``tool/train.py:279-290``),
in one collective without a host sync, and the dropout seed folds in the
rank.

While a profiler runs, :meth:`Trainer.step` is the span
``semseg.train.step`` around ``semseg.train.forward`` (input layout, the
model, both losses), ``semseg.train.backward`` (the last step's gradients
freed, the backward) and ``semseg.train.optimizer`` (the poly LR installed,
the SGD step; ``utils/trace.py``).

Under tensor parallelism the model holds its TP shard
(``build_model(tp_group=...)``) and ``process_group`` is the rank's data
group (None for a single data rank): DDP, the metrics and the dropout
seed's rank are the data group's, so TP peers, which hold the same
samples, draw the same masks and count once. :meth:`Trainer.state_dict`
then gathers the full model and momentum (a collective of the TP group)
and :meth:`Trainer.load_state_dict` takes a full one and keeps the shard.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from semseg_torch.engine.losses import cross_entropy_sum, nll_and_valid
from semseg_torch.engine.optim import poly_lr, set_lr
from semseg_torch.models.layers import Dropout2d
from semseg_torch.ops.resize import resize_bilinear_align_corners_cf
from semseg_torch.parallel.dist import all_reduce_sum
from semseg_torch.utils.metrics import intersection_and_union
from semseg_torch.utils.trace import span


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


def dropout_seed(rng_seed: int, step: int, rank: int = 0) -> int:
    """The per-step dropout seed, a function of ``(rng_seed, step, rank)``
    only: ranks draw different channel masks for their different samples,
    and rank 0 draws what one process draws."""
    entropy = [rng_seed, step] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """Owns the model (in train mode), its optimizer, the step counter and
    the dropout generator; :meth:`step` is one training iteration.
    ``self.module`` is the model; ``self.model`` is what the step calls:
    the model, or with a ``process_group`` the model wrapped in
    ``DistributedDataParallel``, which by default broadcasts rank 0's
    buffers (BatchNorm's running statistics) before every forward."""

    def __init__(self, model, optimizer, *, classes: int, ignore_label: int,
                 aux_weight: float, base_lr: float, max_iter: int, power: float,
                 zoom_factor: int, rng_seed: int = 0, normalize=None,
                 num_replicas: int = 1, process_group=None):
        if num_replicas < 1 or (num_replicas > 1 and process_group is not None):
            raise ValueError(f"num_replicas={num_replicas} with a process group: a DDP "
                             "rank's step holds one replica")
        self.module = model.train()
        self.model = self.module
        self.group = process_group
        self.tp = getattr(model, "tp", None)
        self.rank = 0  # in the data group
        self.num_replicas = num_replicas
        if process_group is not None:
            device = next(model.parameters()).device
            self.rank = dist.get_rank(process_group)
            self.model = DistributedDataParallel(
                model, device_ids=[device] if device.type == "cuda" else None,
                process_group=process_group)
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
        (``engine/checkpoint.py``), live tensors on the model's device; the
        model's own names, never DDP's ``module.``. Under TP the full,
        unsharded state, gathered over the TP group: every peer calls it."""
        model_sd, opt_sd = self.module.state_dict(), self.optimizer.state_dict()
        if self.tp is not None:
            from semseg_torch.parallel.tensor import gather_tp_state, param_names

            model_sd, opt_sd = gather_tp_state(model_sd, opt_sd,
                                               param_names(self.module, self.optimizer),
                                               self.tp)
        return {"step": self.step_count, "state_dict": model_sd, "optimizer": opt_sd}

    def load_state_dict(self, state: dict) -> None:
        """Restore model, optimizer and step count (and with it the poly LR
        and the dropout stream) from :meth:`state_dict` or a checkpoint
        (full, also under TP: the rank keeps its shard)."""
        model_sd, opt_sd = state["state_dict"], state["optimizer"]
        if self.tp is not None:
            from semseg_torch.parallel.tensor import (
                param_names,
                shard_optimizer_state,
                shard_state_dict,
            )

            tp = self.tp
            model_sd = shard_state_dict(model_sd, tp.plan, tp.rank, tp.size)
            opt_sd = shard_optimizer_state(opt_sd, param_names(self.module, self.optimizer),
                                           tp.plan, tp.rank, tp.size)
        self.module.load_state_dict(model_sd, strict=True)
        self.optimizer.load_state_dict(opt_sd)
        self.step_count = int(state["step"])

    def validate_step(self, images, labels):
        """:func:`eval_step` on the trainer's model in eval mode (the model
        itself, outside DDP: no collective but, under TP, the head's, so
        every peer calls it); the model goes back to train mode after. The
        sums are this process's own."""
        self.module.eval()
        try:
            return eval_step(self.module, images, labels, classes=self.classes,
                             ignore_label=self.ignore_label, zoom_factor=self.zoom_factor,
                             normalize=self.normalize)
        finally:
            self.module.train()

    def step(self, images, labels):
        """One iteration on a batch (tensors on any device; NHWC images,
        ``[B, H, W]`` integer labels). Returns the metrics dict: ``loss``,
        ``main_loss``, ``aux_loss`` (0-d tensors), ``lr`` (float) and the
        ``intersection``/``union``/``target`` histograms."""
        with span("semseg.train.step", self.device):
            return self._step(images, labels)

    def _step(self, images, labels):
        with span("semseg.train.forward", self.device):
            images = device_normalize(images.to(self.device, non_blocking=True),
                                      self.normalize)
            labels = labels.to(self.device, non_blocking=True)
            if self.zoom_factor != 8:
                labels = downscale_labels(labels, self.zoom_factor)
            labels = labels.long()
            self.generator.manual_seed(dropout_seed(self.rng_seed, self.step_count,
                                                    self.rank))
            self.model.train()
            logits, aux = self.model(images)
            main_loss = replica_mean_ce(logits, labels, self.num_replicas, self.ignore_label)
            aux_loss = replica_mean_ce(aux, labels, self.num_replicas, self.ignore_label)
            loss = main_loss + self.aux_weight * aux_loss
        with span("semseg.train.backward", self.device):
            # the last step's gradients are freed here, not after its
            # optimizer step: callers read them after a step
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("semseg.train.optimizer", self.device):
            lr = poly_lr(self.base_lr, self.step_count, self.max_iter, self.power)
            set_lr(self.optimizer, lr)
            self.optimizer.step()
        self.step_count += 1

        with torch.no_grad():
            inter, union, target = intersection_and_union(
                logits.argmax(1), labels, self.classes, self.ignore_label)
            losses = [loss.detach(), main_loss.detach(), aux_loss.detach()]
            if self.group is not None:
                world = dist.get_world_size(self.group)
                *sums, inter, union, target = all_reduce_sum(
                    [*losses, inter, union, target], self.group)
                losses = [v / world for v in sums]
        return {"loss": losses[0], "main_loss": losses[1], "aux_loss": losses[2], "lr": lr,
                "intersection": inter, "union": union, "target": target}
