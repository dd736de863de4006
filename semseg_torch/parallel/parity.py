"""The data- and tensor-parallel train steps held to one process: a few
train steps on the same global batches, as ``world`` DDP ranks (each on
its contiguous slice, :func:`ddp_steps`), as a ``world / model_parallel x
model_parallel`` grid of DDP and TP ranks (each TP group on one data
slice, :func:`tp_steps`), or in one process with ``Trainer(num_replicas=
data ranks)`` (:func:`one_process_steps`), from the same seeded weights.
They compute the same function, ``make_train_step(num_replicas=data
ranks)``, in another order of their sums; :func:`relative_distances`
measures how far apart they end. The tests run it on the CPU over gloo,
``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import dataclasses
import time
import numpy as np
import torch


# The recipe's SGD (``config/*/*.yaml``): momentum, weight decay, aux
# weight, poly power; ignore label 255; weights from init seed 0.
MOMENTUM, WEIGHT_DECAY, AUX_WEIGHT, POWER, IGNORE, SEED = 0.9, 1e-4, 0.4, 0.9, 255, 0


@dataclasses.dataclass
class StepSpec:
    """What to train: ``cfg`` holds the model keys (``arch``, ``layers``,
    ``classes``, ``zoom_factor``, ``train_h``/``train_w``, ``sync_bn``, the
    PSA keys); ``batches`` the global ``(images NHWC, labels NHW)`` numpy
    pairs (normalised float images), one a step; ``device`` where the
    steps run, named by the caller: ``cuda`` (``cuda:0``, which the ranks
    share over gloo) or ``cpu``; ``dtype`` the model's compute dtype."""

    cfg: object
    batches: list
    device: str
    dtype: str = "float32"
    base_lr: float = 0.002


def _trainer(spec: StepSpec, device, num_replicas=1, process_group=None, tp_group=None):
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import COMPUTE_DTYPES, build_model
    from semseg_torch.models.layers import Dropout2d

    model = build_model(spec.cfg, dtype=COMPUTE_DTYPES[spec.dtype], device=device,
                        seed=SEED, train=True, replicas=num_replicas,
                        process_group=process_group, tp_group=tp_group)
    # Dropout off: ranks draw their masks from rank-folded seeds, one
    # process from one draw over the batch, so the two cannot agree.
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return Trainer(model, make_sgd(model, spec.base_lr, MOMENTUM, WEIGHT_DECAY),
                   classes=spec.cfg.classes, ignore_label=IGNORE, aux_weight=AUX_WEIGHT,
                   base_lr=spec.base_lr, max_iter=len(spec.batches), power=POWER,
                   zoom_factor=spec.cfg.zoom_factor, num_replicas=num_replicas,
                   process_group=process_group)


def _steps(tr: "Trainer", batches, device, rank=0, world=1):
    """Run the batches (each sliced to this rank's part); per step the
    reduced losses, the launch counts and the seconds."""
    from semseg_torch.ops import launch_counters
    from semseg_torch.parallel.dist import shard_batch

    counters = launch_counters()
    out = {"losses": [], "launches": [], "seconds": []}
    for images, labels in batches:
        images, labels = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in shard_batch((images, labels), rank, world))
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        m = tr.step(images, labels)
        out["losses"].append([m[k].item() for k in ("loss", "main_loss", "aux_loss")])
        out["seconds"].append(time.perf_counter() - t0)
        out["launches"].append({k: fn.launches for k, fn in counters.items()})
    out["state"] = {k: v.detach().cpu().numpy()
                    for k, v in tr.state_dict()["state_dict"].items()}
    return out


def _device(spec: StepSpec) -> torch.device:
    return torch.device("cuda", 0) if spec.device == "cuda" else torch.device(spec.device)


def one_process_steps(spec: StepSpec, num_replicas: int) -> dict:
    """The steps in this process with ``Trainer(num_replicas=...)`` on the
    whole global batches: ``{"losses": [[loss, main, aux]] a step,
    "launches": [counts] a step, "seconds": [...], "state": {name:
    array}, "init": the state before the first step}``."""
    device = _device(spec)
    tr = _trainer(spec, device, num_replicas=num_replicas)
    init = {k: v.detach().cpu().numpy().copy() for k, v in tr.module.state_dict().items()}
    return {**_steps(tr, spec.batches, device), "init": init}


def _rank_steps(rank, spec: StepSpec, world: int, model_parallel: int, url: str):
    """One rank of :func:`ddp_steps` or :func:`tp_steps` (a spawned
    process)."""
    import torch.distributed as dist

    from semseg_torch.parallel.dist import grid, grid_groups, init_process_group

    device = _device(spec)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    group = init_process_group(url, "gloo", rank, world)
    try:
        g = grid(world, model_parallel)
        tp_group, data_group = grid_groups(g, rank) if model_parallel > 1 else (None, group)
        tr = _trainer(spec, device, process_group=data_group, tp_group=tp_group)
        out = _steps(tr, spec.batches, device, g.data_index(rank), g.data_world)
        out["shard_rows"] = {k: v.shape[0] for k, v in tr.module.state_dict().items()
                             if tr.tp is not None and k in tr.tp.plan}
        if rank:
            del out["state"]  # the same on every rank (under TP, gathered on each)
        out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                           if device.type == "cuda" else None)
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def tp_steps(spec: StepSpec, world: int, model_parallel: int, timeout_s: float = 600) -> list:
    """The steps as ``world`` ranks in fresh processes over gloo, a grid of
    ``world / model_parallel`` data ranks by ``model_parallel`` TP peers
    (``parallel/dist.py::grid``): each TP group on its contiguous data
    slice of every global batch, the head sharded over it. One result a
    rank as :func:`one_process_steps`' (the full, gathered ``state`` on
    rank 0 only), plus ``peak_gib`` (CUDA) and ``shard_rows``: the rank's
    output channels of each sharded entry."""
    from semseg_torch.parallel.dist import grid, spawn
    from semseg_torch.utils.misc import find_free_port

    grid(world, model_parallel)
    return spawn(_rank_steps, world,
                 (spec, world, model_parallel, f"tcp://127.0.0.1:{find_free_port()}"),
                 timeout_s=timeout_s)


def ddp_steps(spec: StepSpec, world: int, timeout_s: float = 600) -> list:
    """:func:`tp_steps` at ``model_parallel`` 1: ``world`` DDP ranks, rank
    r on the r-th contiguous slice of every global batch."""
    return tp_steps(spec, world, 1, timeout_s)


def relative_distances(got: dict, want: dict, init: dict) -> dict:
    """Per floating state entry: the L2 distance of ``got`` to ``want``
    over the L2 change ``want`` made from ``init``."""
    out = {}
    for k, w in want.items():
        if not np.issubdtype(w.dtype, np.floating):
            continue
        change = np.linalg.norm((w - init[k]).astype(np.float64))
        out[k] = float(np.linalg.norm((got[k] - w).astype(np.float64)) / max(change, 1e-30))
    return out
