"""Rank workers of ``tests/test_torch_parallel.py``: module-level functions
that ``semseg_torch.parallel.dist.spawn`` runs in fresh processes (they
import torch and the port, never jax)."""

import numpy as np
import torch


def batchnorm_and_collectives(rank, url, x, g, scale, bias, dtype):
    """Rank ``rank`` of 2 over gloo on the CPU: the synchronised BatchNorm
    in train mode on the rank's slice of the NHWC batch ``x``, its backward
    from the same slice of the cotangent ``g``; then the collective helpers.
    Returns numpy arrays (NHWC for y and dx)."""
    import torch.distributed as dist

    from semseg_torch.models.layers import BatchNorm2d, set_batchnorm_replicas
    from semseg_torch.parallel import dist as pdist

    group = pdist.init_process_group(url, "gloo", rank, 2, timeout_s=120)
    try:
        tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
        bn = BatchNorm2d(x.shape[-1]).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        set_batchnorm_replicas(bn, process_group=group)
        xs, gs = pdist.shard_batch((x, g), rank, 2)
        xt = torch.from_numpy(xs).permute(0, 3, 1, 2).to(tdt).requires_grad_()
        y = bn(xt)
        y.float().backward(torch.from_numpy(gs).permute(0, 3, 1, 2))
        out = {"y": y.float().permute(0, 2, 3, 1), "dx": xt.grad.float().permute(0, 2, 3, 1),
               "dscale": bn.weight.grad, "dbias": bn.bias.grad, "mean": bn.running_mean,
               "var": bn.running_var, "tracked": bn.num_batches_tracked}
        out = {k: v.detach().numpy() for k, v in out.items()}
        # The helpers: a flag raised on rank 1 only, an object from rank 0,
        # a packed sum and mean of a float and an int64 tensor.
        out["any"] = pdist.any_rank(rank == 1, group)
        out["object"] = pdist.broadcast_object({"from": rank}, group)
        out["sum"] = [t.numpy() for t in pdist.all_reduce_sum(
            [torch.tensor([0.5 + rank]), torch.tensor([3, 2 ** 40 + rank])], group)]
        out["avg"] = pdist.all_reduce_mean([torch.full((2,), float(rank))], group)[0].numpy()
        out["world"] = dist.get_world_size(group)
        return out
    finally:
        dist.destroy_process_group()


def signal_after(step, target, iteration, metrics):
    """A ``step_hook`` of ``semseg_torch.train.spawn``: on global rank 1,
    after global step ``step``, SIGTERM to the launching process
    (``target="launcher"``, which passes it on to every rank) or to this
    rank alone (``"self"``); then a pause that lets a passed-on signal land
    before the step boundary."""
    import os
    import signal
    import time

    import torch.distributed as dist

    if iteration != step or dist.get_rank() != 1:
        return
    os.kill(os.getppid() if target == "launcher" else os.getpid(), signal.SIGTERM)
    if target == "launcher":
        time.sleep(2.0)


def fails_on_rank_one(rank):
    """Rank 1 raises; rank 0 would wait a long time."""
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    import time

    time.sleep(120)
    return rank


def returns_rank(rank, scale):
    return np.full(3, rank * scale)


def sleeps(rank):
    import time

    time.sleep(60)
    return rank
