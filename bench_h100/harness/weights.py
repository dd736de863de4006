"""Weights made from ``--seed`` on the device, the same for the program and
the reference: the published initialisation (the backbone's convolutions
normal with std sqrt(2 / fan_out), every other convolution PyTorch's
default U(+-1/sqrt(fan_in)), BatchNorm at weight 1, bias 0 and unit
running statistics), drawn in two calls of one ``torch.Generator`` on the
device: one normal draw for all the normal leaves and one uniform draw for
all the uniform ones, scaled leaf by leaf in one multiply each.
"""

from __future__ import annotations

import math

import torch

from bench_h100.reference.models import init_kinds


def make(reference_model, seed: int, device) -> dict:
    """A float32 state dict (BatchNorm's counters int64) for the reference
    model's names and shapes."""
    shapes = {k: v.shape for k, v in reference_model.state_dict().items()}
    kinds = init_kinds(reference_model)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for kind, draw, scale in (
            ("kaiming", torch.randn, lambda fan: math.sqrt(2.0 / fan)),
            ("uniform", lambda n, **kw: torch.rand(n, **kw).mul_(2).sub_(1),
             lambda fan: 1.0 / math.sqrt(fan))):
        names = [(n, fan) for n, k, fan in kinds if k == kind]
        sizes = [shapes[n].numel() for n, _ in names]
        flat = draw(sum(sizes), generator=gen, device=device, dtype=torch.float32)
        scales = torch.tensor([scale(fan) for _, fan in names], device=device)
        flat.mul_(torch.repeat_interleave(scales, torch.tensor(sizes, device=device)))
        for (n, _), part in zip(names, torch.split(flat, sizes)):
            out[n] = part.view(shapes[n])
    for n, k, _ in kinds:
        if k in ("one", "zero"):
            dtype = torch.int64 if n.endswith("num_batches_tracked") else torch.float32
            fill = torch.ones if k == "one" else torch.zeros
            out[n] = fill(shapes[n], device=device, dtype=dtype)
    return out

