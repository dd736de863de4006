"""Plain training steps of the published recipe (hszhao/semseg
``tool/train.py``): images normalised with the ImageNet mean and standard
deviation, main + ``aux_weight`` x aux cross-entropy over the labelled
pixels, SGD with momentum and weight decay, the backbone at ``base_lr``
and the new modules (``ppm``, ``psa``, ``cls``, ``aux``) at ten times
it, the poly rate ``base_lr * (1 - step / max_iter) ** power`` installed
before each step. float32, train-mode BatchNorm over the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEW_MODULES = ("ppm", "psa", "cls", "aux")


def dropout_seed(rng_seed: int, step: int) -> int:
    """The dropout stream's seed for ``step`` as the recipe's trainer draws
    it: ``SeedSequence([rng_seed, step])``, its first 64-bit word halved."""
    return int(np.random.SeedSequence([rng_seed, step]).generate_state(1, np.uint64)[0] >> 1)


class SGD:
    """``torch.optim.SGD`` semantics written out: ``d = g + wd * p``; the
    first step's buffer is ``d``, then ``buf = momentum * buf + d``;
    ``p -= lr * buf``."""

    def __init__(self, model, base_lr, momentum, weight_decay):
        self.params = list(model.named_parameters())
        self.mult = {n: (10.0 if n.split(".", 1)[0] in NEW_MODULES else 1.0)
                     for n, _ in self.params}
        self.momentum, self.wd = momentum, weight_decay
        self.buf = {}

    @torch.no_grad()
    def step(self, lr):
        for name, p in self.params:
            d = p.grad + self.wd * p
            if name in self.buf:
                self.buf[name].mul_(self.momentum).add_(d)
            else:
                self.buf[name] = d.clone()
            p.add_(self.buf[name], alpha=-lr * self.mult[name])


def loss_of(model, images, labels, *, mean, std, aux_weight, ignore_label):
    x = (images.float() - torch.tensor(mean, device=images.device)) \
        / torch.tensor(std, device=images.device)
    logits, aux = model(x.permute(0, 3, 1, 2))
    labels = labels.long()
    main = F.cross_entropy(logits, labels, ignore_index=ignore_label)
    return main + aux_weight * F.cross_entropy(aux, labels, ignore_index=ignore_label)


def run_steps(model, batches, *, recipe, rng_seed, mean, std):
    """Train ``model`` on ``batches`` (``(uint8 NHWC images, labels)`` on
    its device) from step 0. Returns the losses, the first step's
    gradients as the optimizer takes them (``g + wd * p``, by name), the
    change of every state entry (parameters and BatchNorm statistics) over
    all the steps and the BatchNorm statistics' change over the first, all
    float32 on the device."""
    model.train()
    opt = SGD(model, recipe["base_lr"], recipe["momentum"], recipe["weight_decay"])
    gen = torch.Generator(device=next(model.parameters()).device)
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = gen
    start = {k: v.detach().clone().float() for k, v in model.state_dict().items()}
    losses, first_grad, first_bn = [], None, None
    for step, (images, labels) in enumerate(batches):
        lr = recipe["base_lr"] * max(1.0 - step / recipe["max_iter"], 0.0) ** recipe["power"]
        gen.manual_seed(dropout_seed(rng_seed, step))
        for p in model.parameters():
            p.grad = None
        loss = loss_of(model, images, labels, mean=mean, std=std,
                       aux_weight=recipe["aux_weight"], ignore_label=recipe["ignore_label"])
        loss.backward()
        opt.step(lr)
        losses.append(loss.detach().float())
        if first_grad is None:
            first_grad = {n: b.clone() for n, b in opt.buf.items()}
            first_bn = {k: v.detach().float() - start[k] for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))}
    change = {k: v.detach().float() - start[k] for k, v in model.state_dict().items()
              if v.is_floating_point()}
    return torch.stack(losses), first_grad, change, first_bn
