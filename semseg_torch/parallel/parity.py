"""The data-parallel train step held to one process: a few train steps on
the same global batches, as ``world`` DDP ranks (each on its contiguous
slice, :func:`ddp_steps`) or in one process with ``Trainer(num_replicas=
world)`` (:func:`one_process_steps`), from the same seeded weights. The two
compute the same function, ``make_train_step(num_replicas=world)``, in
another order of their sums; :func:`relative_distances` measures how far
apart they end. The tests run it on the CPU over gloo, ``chip_smoke.py``
on the card.
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


def _trainer(spec: StepSpec, device, num_replicas=1, process_group=None):
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import COMPUTE_DTYPES, build_model
    from semseg_torch.models.layers import Dropout2d

    model = build_model(spec.cfg, dtype=COMPUTE_DTYPES[spec.dtype], device=device,
                        seed=SEED, train=True, replicas=num_replicas,
                        process_group=process_group)
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
    out["state"] = {k: v.detach().cpu().numpy() for k, v in tr.module.state_dict().items()}
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


def _rank_steps(local_rank, spec: StepSpec, world: int, url: str):
    """One DDP rank of :func:`ddp_steps` (a spawned process)."""
    import torch.distributed as dist

    from semseg_torch.parallel.dist import init_process_group

    device = _device(spec)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    group = init_process_group(url, "gloo", local_rank, world)
    try:
        out = _steps(_trainer(spec, device, process_group=group), spec.batches, device,
                     local_rank, world)
        if local_rank:
            del out["state"]  # equal on every rank after DDP's averaged step
        out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                           if device.type == "cuda" else None)
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def ddp_steps(spec: StepSpec, world: int, timeout_s: float = 600) -> list:
    """The steps as ``world`` DDP ranks in fresh processes, rank r on the
    r-th contiguous slice of every global batch: one result a rank as
    :func:`one_process_steps`' (the ``state`` on rank 0 only), plus
    ``peak_gib`` (CUDA)."""
    from semseg_torch.parallel.dist import free_port, spawn

    return spawn(_rank_steps, world, (spec, world, f"tcp://127.0.0.1:{free_port()}"),
                 timeout_s=timeout_s)


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
