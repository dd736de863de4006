"""Process groups, rank devices, batch shards, small collectives and the
process launcher of the port's data-parallel training.

The counterpart of ``semseg_tpu/parallel/mesh.py``: where the JAX package
shards a global batch over a ``data`` mesh axis and lets XLA compile the
collectives, the port runs one process per device (the reference's
``mp.spawn``, ``tool/train.py:102-119``) with ``DistributedDataParallel``
over a ``torch.distributed`` process group. The configs' ``Distributed``
keys (``config/cityscapes/cityscapes_psanet50.yaml:44-49``) say how:

- ``train_gpu``: the devices of one node, one process each;
- ``world_size``: the number of nodes, ``rank``: this node's index; the
  global rank of local process ``l`` is ``rank * len(train_gpu) + l``
  (reference ``tool/train.py:105,117-118``);
- ``dist_url``: the rendezvous; on one node a free localhost port is
  picked instead (reference ``tool/train.py:103-104``);
- ``dist_backend``: ``nccl`` or ``gloo``; the configs' ``xla`` means
  ``nccl`` on CUDA. A missing NCCL raises; nothing switches to gloo unless
  the config names it. NCCL needs a device per rank; gloo lets ranks share
  one (its collectives take CPU and CUDA tensors, staged through the
  host).

``model_parallel: M`` lays the ``W`` ranks out as JAX's ``(data, model)``
mesh does (``semseg_tpu/parallel/mesh.py:27-35``), data-major
(:func:`grid`): global rank ``r`` has data index ``r // M`` and model index
``r % M``, so the ``M`` peers of a tensor-parallel group are neighbouring
ranks, on one node when ``M`` divides ``len(train_gpu)``.
:func:`grid_groups` makes the two families of subgroups: the TP groups
(one data index, ``parallel/tensor.py`` shards the head over them) and the
data groups (one model index: DDP, BatchNorm moments, the metrics).
Nothing here runs at import time.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import signal
import time
from typing import Optional

import torch
import torch.distributed as dist

from semseg_torch.utils.misc import find_free_port

# A collective that waits longer than this raises on every rank still in
# it, so a rank that died fails the run instead of hanging it.
TIMEOUT_S = 900


def backend_name(cfg, device_type: str) -> str:
    """The process group backend for ranks on ``device_type``: the
    config's ``dist_backend`` (``xla`` reads as ``nccl``). NCCL on the CPU,
    or without NCCL in this build of PyTorch, raises."""
    name = str(getattr(cfg, "dist_backend", None) or "nccl").lower()
    if name == "xla":
        name = "nccl"
    if name not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend must be nccl, gloo or xla, got {name!r}")
    if name == "nccl":
        if device_type != "cuda":
            raise ValueError("dist_backend nccl needs CUDA devices; name gloo to train "
                             "on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("dist_backend nccl, but this PyTorch has no NCCL; name "
                               "dist_backend gloo explicitly to use gloo")
    return name


def local_processes(cfg) -> int:
    """Processes on this node: one per ``train_gpu`` entry."""
    return len(getattr(cfg, "train_gpu", None) or [0])


def world_size(cfg) -> int:
    """Ranks over all nodes: ``world_size`` nodes of ``len(train_gpu)``."""
    return int(getattr(cfg, "world_size", None) or 1) * local_processes(cfg)


def global_rank(cfg, local_rank: int) -> int:
    return int(getattr(cfg, "rank", None) or 0) * local_processes(cfg) + local_rank


def rank_device(cfg, local_rank: int) -> torch.device:
    """``cuda:{train_gpu[local_rank]}``; an ordinal the machine lacks
    raises."""
    gpus = getattr(cfg, "train_gpu", None) or [0]
    ordinal = int(gpus[local_rank])
    count = torch.cuda.device_count()
    if not 0 <= ordinal < count:
        raise ValueError(f"train_gpu[{local_rank}] = {ordinal}, but this machine shows "
                         f"{count} CUDA device(s)")
    return torch.device("cuda", ordinal)


def check_devices(cfg, backend: str, device_type: str) -> None:
    """Every ``train_gpu`` ordinal exists (on CUDA), and NCCL gets a device
    per rank."""
    gpus = [int(g) for g in (getattr(cfg, "train_gpu", None) or [0])]
    if device_type == "cuda":
        for local in range(len(gpus)):
            rank_device(cfg, local)
        if backend == "nccl" and len(set(gpus)) < len(gpus):
            raise ValueError(f"train_gpu {gpus} lists a device twice: NCCL needs a device "
                             "per rank (name dist_backend gloo to share one)")


def rendezvous_url(cfg) -> str:
    """``dist_url``, or on one node a free localhost port."""
    if int(getattr(cfg, "world_size", None) or 1) == 1:
        return f"tcp://127.0.0.1:{find_free_port()}"
    return cfg.dist_url


def init_process_group(url: str, backend: str, rank: int, world: int,
                       timeout_s: float = TIMEOUT_S):
    """Join the default process group; returns it."""
    dist.init_process_group(backend, init_method=url, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def control_group(group):
    """A gloo group over the ranks of ``group`` for host-side decisions
    (preemption, the resume path, barriers): ``group`` itself when it is
    gloo, else a new one. Every rank must call this, in the same order."""
    if dist.get_backend(group) == "gloo":
        return group
    return dist.new_group(backend="gloo")


@dataclasses.dataclass(frozen=True)
class Grid:
    """``world`` ranks as ``data_world x model_parallel``, data-major."""

    world: int
    model_parallel: int

    @property
    def data_world(self) -> int:
        return self.world // self.model_parallel

    def data_index(self, rank: int) -> int:
        return rank // self.model_parallel

    def model_index(self, rank: int) -> int:
        return rank % self.model_parallel

    def tp_ranks(self, data_index: int) -> list:
        """The global ranks of one TP group: one data index, every model
        index, in model order."""
        m = self.model_parallel
        return list(range(data_index * m, (data_index + 1) * m))

    def data_ranks(self, model_index: int) -> list:
        """The global ranks of one data group: one model index."""
        return list(range(model_index, self.world, self.model_parallel))


def grid(world: int, model_parallel=1) -> Grid:
    """The ``(data, model)`` grid of ``world`` ranks; a ``model_parallel``
    that does not divide ``world`` raises with JAX's words
    (``tool/train.py:79-83``)."""
    m = int(model_parallel or 1)
    if m < 1:
        raise ValueError(f"model_parallel must be >= 1, got {m}")
    if world % m:
        raise ValueError(f"model_parallel {m} does not divide {world} devices")
    return Grid(world, m)


def grid_groups(g: Grid, rank: int):
    """``(tp_group, data_group)`` of global ``rank``, on the default group's
    backend: ``None`` for a family whose groups hold one rank (no TP at
    ``model_parallel 1``, no data parallelism at ``model_parallel ==
    world``). Every rank must call this in the same order: each creates
    every TP group, then every data group."""
    tp = data = None
    if g.model_parallel > 1:
        for d in range(g.data_world):
            group = dist.new_group(g.tp_ranks(d))
            if d == g.data_index(rank):
                tp = group
    if g.data_world > 1:
        for m in range(g.model_parallel):
            group = dist.new_group(g.data_ranks(m))
            if m == g.model_index(rank):
                data = group
    return tp, data


def shard_batch(batch, rank: int, world: int):
    """The ``rank``-th of ``world`` contiguous equal slices of a global
    batch (an array or tensor, or a tuple or list of them, batch first):
    the counterpart of ``mesh.shard_batch``'s split over the data axis."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, rank, world) for b in batch)
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"batch {n} not divisible by {world} ranks")
    per = n // world
    return batch[rank * per:(rank + 1) * per]


def all_reduce_sum(tensors, group):
    """``tensors`` summed over the ranks of ``group``, in one collective of
    float64 (exact for integer counts below 2^53); each comes back in its
    own dtype and shape."""
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_reduce_mean(tensors, group):
    """``tensors`` (floating) averaged over the ranks of ``group``."""
    world = dist.get_world_size(group)
    return [t / world for t in all_reduce_sum(tensors, group)]


def any_rank(flag: bool, group) -> bool:
    """Whether ``flag`` is set on any rank of ``group`` (a CPU group)."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def broadcast_object(obj, group, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank of ``group`` (a CPU group)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _entry(local_rank, fn, args, results):
    results.put((local_rank, pickle.dumps(fn(local_rank, *args))))


def spawn(fn, nprocs: int, args=(), timeout_s: Optional[float] = TIMEOUT_S,
          forward_signals=()):
    """Run ``fn(local_rank, *args)`` in ``nprocs`` fresh processes (the
    ``spawn`` start method) and return their results by local rank.
    ``fn`` is a module-level function and ``args`` and the results are
    picklable. A rank that raises or exits fails the call with its error
    and stops the others; so does the deadline ``timeout_s`` (None: no
    deadline). While the ranks run, the signals ``forward_signals`` that
    reach this process (from the main thread's handlers) are sent on to
    every rank instead of ending this process."""
    import threading

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(_entry, args=(fn, args, results), nprocs=nprocs, join=False,
                               start_method="spawn")

    def forward(signum, frame):
        for p in procs.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    previous = {}
    if threading.current_thread() is threading.main_thread():
        for sig in forward_signals:
            previous[sig] = signal.signal(sig, forward)
    got = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            while not results.empty():  # drain, so no rank blocks on a full pipe
                rank, payload = results.get()
                got[rank] = pickle.loads(payload)
            if procs.join(timeout=1.0):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within {timeout_s} s")
        while not results.empty():
            rank, payload = results.get()
            got[rank] = pickle.loads(payload)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
    missing = sorted(set(range(nprocs)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [got[r] for r in range(nprocs)]
