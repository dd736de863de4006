"""Tensor parallelism of the segmentation heads: the sharding plan, the
shards of a state and the two collectives of the sharded forward.

The counterpart of ``semseg_tpu/parallel/sharding_rules.py``. JAX places
the wide head layers channel-sharded on the ``model`` mesh axis and lets
GSPMD insert the collectives; the port runs one process per rank and
spells them out, in Megatron's column-parallel form:

- :func:`tp_plan` names the parameters and buffers JAX's
  ``tp_spec_for_leaf`` shards (``sharding_rules.py:32-47``): under ``ppm``,
  ``cls``, ``aux`` or ``psa``, but not the logits convolutions (``cls.4``,
  ``aux.4``, JAX's ``conv_logits``), the conv weights with at least 256
  output channels and the BatchNorm ``weight``, ``bias``,
  ``running_mean`` and ``running_var`` of at least 256 channels. PSA's
  ``attention{,_p}.3`` (to ``mask_h * mask_w`` channels) is among them:
  JAX names it ``attention_conv``, not ``conv_logits``;
- a rank keeps the ``rank``-th of ``torch.tensor_split(t, M)`` along the
  output channels (:func:`shard_state_dict`; the momentum too,
  :func:`shard_optimizer_state`). Splits may be uneven: the Cityscapes
  PSANet50's 7921 attention channels give shards of 3961 and 3960. Every
  gather pads each shard to the largest and trims
  (:func:`all_gather_channels`), since an ``all_gather`` wants equal sizes;
- :func:`copy_to_tp` (identity forward; the backward all-reduces the
  gradient over the TP group) goes on each replicated input of a sharded
  conv, and :func:`gather_from_tp` (the forward all-gathers the channels;
  the backward keeps the rank's own slice) on its sharded output, so that
  every layer after it computes the same thing on every TP peer.

The collectives run in float32 for lower-precision tensors (exact for
bfloat16 data; the gradient sums are rounded once). Nothing here runs at
import time.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist

TP_MODULES = ("ppm", "cls", "aux", "psa")
MIN_SHARD_CHANNELS = 256
LOGITS_CONVS = ("cls.4", "aux.4")
_BN_ENTRIES = ("weight", "bias", "running_mean", "running_var")


@dataclasses.dataclass(eq=False)
class TensorParallel:
    """One rank's place in its TP group: the group, the rank's index in it,
    the group's size and the plan (sharded name -> full output channels)."""

    group: object
    rank: int
    size: int
    plan: dict


def tp_plan(model: torch.nn.Module) -> dict:
    """``{name: full size of dim 0}`` of the parameters and buffers of an
    unsharded ``model`` that tensor parallelism shards along dim 0 (the
    output channels), by JAX's rule (module docstring)."""
    plan = {}
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        module, leaf = name.rsplit(".", 1)
        if name.split(".", 1)[0] not in TP_MODULES or module in LOGITS_CONVS:
            continue
        wide = t.ndim >= 1 and t.shape[0] >= MIN_SHARD_CHANNELS
        if wide and ((leaf == "weight" and t.ndim == 4) or (leaf in _BN_ENTRIES and t.ndim == 1)):
            plan[name] = int(t.shape[0])
    return plan


def split_sizes(full: int, size: int) -> list:
    """The lengths of ``torch.tensor_split`` of ``full`` into ``size``."""
    return [full // size + (1 if r < full % size else 0) for r in range(size)]


def _shard(t: torch.Tensor, full: int, rank: int, size: int, name: str) -> torch.Tensor:
    if t.shape[0] != full:
        raise ValueError(f"{name}: {t.shape[0]} output channels, the plan says {full} "
                         "(a shard, or another model)")
    return torch.tensor_split(t, size)[rank].clone()


def shard_state_dict(full: dict, plan: dict, rank: int, size: int) -> dict:
    """The ``rank``-th of ``size`` shards of a full state_dict: the planned
    entries split along dim 0, every other entry as it is. Entries of the
    plan that ``full`` lacks are skipped (a backbone-only dict)."""
    return {k: (_shard(v, plan[k], rank, size, k) if k in plan else v) for k, v in full.items()}


def gather_state_dict(shards, plan: dict) -> dict:
    """The full state_dict from the shards of every rank, in rank order:
    the inverse of :func:`shard_state_dict`."""
    return {k: (torch.cat([s[k] for s in shards]) if k in plan else v)
            for k, v in shards[0].items()}


def param_names(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> list:
    """The model's parameter names in the optimizer's state_dict order (its
    integer keys index this list)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]


def _map_momentum(opt_state: dict, names: list, plan: dict, fn) -> dict:
    state = {}
    for idx, entry in opt_state["state"].items():
        name = names[idx]
        state[idx] = {k: (fn(v, name) if name in plan and isinstance(v, torch.Tensor)
                          and v.ndim >= 1 else v) for k, v in entry.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_optimizer_state(opt_state: dict, names: list, plan: dict, rank: int,
                          size: int) -> dict:
    """An SGD state_dict's momentum buffers of planned parameters cut to
    the ``rank``-th shard (``names`` from :func:`param_names`)."""
    return _map_momentum(opt_state, names, plan,
                         lambda v, n: _shard(v, plan[n], rank, size, n))


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a dtype every backend reduces: float32 for narrower floats."""
    return t.float() if t.is_floating_point() and t.element_size() < 4 else t


def all_gather_channels(x: torch.Tensor, sizes: list, group, dim: int = 1) -> torch.Tensor:
    """Every rank's ``x`` (its ``sizes[rank]`` slices along ``dim``)
    concatenated in rank order on every rank of ``group``: each padded to
    the largest shard, gathered, trimmed."""
    top = max(sizes)
    xw = _wire(x)
    if xw.shape[dim] < top:
        pad = list(xw.shape)
        pad[dim] = top - xw.shape[dim]
        xw = torch.cat([xw, xw.new_zeros(pad)], dim)
    xw = xw.contiguous()
    parts = [torch.empty_like(xw) for _ in sizes]
    dist.all_gather(parts, xw, group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim).to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the TP group
    (each rank's holds the part of its own output channels)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = _wire(g).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _GatherFromTP(torch.autograd.Function):
    """Forward: the channels of every rank, concatenated (uneven-safe);
    backward: the rank's own slice of the (replicated) gradient, with no
    collective."""

    @staticmethod
    def forward(ctx, x, sizes, rank, group):
        ctx.offset, ctx.length = sum(sizes[:rank]), sizes[rank]
        return all_gather_channels(x, sizes, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.offset, ctx.length).contiguous(), None, None, None


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """:class:`_CopyToTP` over ``tp``'s group; ``x`` itself without TP."""
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def gather_from_tp(x: torch.Tensor, tp, full: int) -> torch.Tensor:
    """:class:`_GatherFromTP` of a shard of ``full`` channels over ``tp``'s
    group; ``x`` itself without TP."""
    if tp is None:
        return x
    return _GatherFromTP.apply(x, split_sizes(full, tp.size), tp.rank, tp.group)


def sharded(conv: torch.nn.Conv2d) -> bool:
    """Whether ``conv`` holds a shard of its output channels."""
    return conv.weight.shape[0] < conv.out_channels


def column_parallel(x: torch.Tensor, tp, *layers) -> torch.Tensor:
    """``layers`` (a conv, then per-channel layers) on the replicated ``x``:
    with a sharded conv, each rank runs its output channels on
    :func:`copy_to_tp` of ``x`` and the result is gathered, so every rank
    holds the full output; else the layers as they are."""
    split = tp is not None and sharded(layers[0])
    y = copy_to_tp(x, tp) if split else x
    for layer in layers:
        y = layer(y)
    return gather_from_tp(y, tp, layers[0].out_channels) if split else y


def shard_model(model: torch.nn.Module, group, rank: int, size: int) -> TensorParallel:
    """Keep the ``rank``-th of ``size`` shards of every planned parameter
    and buffer of the full ``model`` (in place, before an optimizer is
    made) and set the returned :class:`TensorParallel` as the ``tp`` of the
    model and of its head modules, whose forwards then run sharded."""
    plan = tp_plan(model)
    tp = TensorParallel(group, rank, size, plan)
    with torch.no_grad():
        for name, full in plan.items():
            path, leaf = name.rsplit(".", 1)
            module = model.get_submodule(path)
            value = _shard(getattr(module, leaf), full, rank, size, name)
            if leaf in module._parameters:
                module._parameters[leaf] = torch.nn.Parameter(value)
            else:
                module._buffers[leaf] = value
    model.tp = tp
    for head in TP_MODULES:
        if hasattr(model, head):
            getattr(model, head).tp = tp
    return tp


def gather_tp_state(module_state: dict, opt_state: dict, names: list, tp) -> tuple:
    """The full model and optimizer state_dicts from every TP peer's shards
    (a collective of the TP group: every peer calls it, in the same order);
    entries in their own dtype and device."""
    def gather(t, name):
        return all_gather_channels(t, split_sizes(tp.plan[name], tp.size), tp.group, dim=0)

    model_sd = {k: (gather(v, k) if k in tp.plan else v) for k, v in module_state.items()}
    return model_sd, _map_momentum(opt_state, names, tp.plan, gather)
