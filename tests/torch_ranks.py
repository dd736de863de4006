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


def tp_psa_module(rank, url, x, cot):
    """Rank ``rank`` of 2 over gloo: a train-mode PSA module (2048 -> 512,
    bi-direction, shrink 2, a 17x17 mask: 289 attention channels, split 145
    and 144) built whole from seed 0, and its TP shard; the forward and
    backward of both on the NCHW ``x`` with the cotangent ``cot``. Returns
    the shard's output and input gradient, the whole module's, and each
    sharded parameter's gradient beside the rank's slice of the whole
    module's."""
    import copy

    import torch.distributed as dist

    from semseg_torch.models.layers import torch_default_conv_init_
    from semseg_torch.models.psanet import PSA
    from semseg_torch.parallel import dist as pdist
    from semseg_torch.parallel import tensor

    group = pdist.init_process_group(url, "gloo", rank, 2, timeout_s=120)
    try:
        holder = torch.nn.Module()
        holder.psa = PSA(2048, 512, psa_type=2, shrink_factor=2, mask_h=17, mask_w=17,
                         normalization_factor=289.0)
        gen = torch.Generator().manual_seed(0)
        for m in holder.modules():
            if isinstance(m, torch.nn.Conv2d):
                torch_default_conv_init_(m, gen)
        whole = copy.deepcopy(holder).train()
        tp = tensor.shard_model(holder, group, rank, 2)
        holder.train()
        out = {"sizes": tensor.split_sizes(tp.plan["psa.attention.3.weight"], 2)}
        for name, model in (("whole", whole), ("tp", holder)):
            xt = torch.from_numpy(x).requires_grad_()
            y = model.psa(xt)
            y.backward(torch.from_numpy(cot))
            out[name] = {"y": y.detach().numpy(), "dx": xt.grad.numpy()}
        full_grads = dict(whole.named_parameters())
        out["grads"] = {}
        for k, p in holder.named_parameters():
            want = full_grads[k].grad
            if k in tp.plan:
                want = torch.tensor_split(want, 2)[rank]
            out["grads"][k] = (p.grad.numpy(), want.numpy())
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def remat_arms(rank, url, world, grids, specs):
    """Rank ``rank`` of ``world`` gloo ranks on the CPU, in one process
    group: for each ``model_parallel`` of ``grids``, the
    ``world / model_parallel x model_parallel`` grid and each
    ``parity.StepSpec`` of ``specs`` in turn through ``parity``'s own
    trainer and steps. By ``model_parallel``, per spec the reduced losses,
    and on rank 0 the state (gathered under TP)."""
    import torch.distributed as dist

    from semseg_torch.parallel import parity
    from semseg_torch.parallel.dist import grid, grid_groups, init_process_group

    group = init_process_group(url, "gloo", rank, world, timeout_s=120)
    try:
        out = {}
        for model_parallel in grids:
            g = grid(world, model_parallel)
            tp_group, data_group = (grid_groups(g, rank) if model_parallel > 1
                                    else (None, group))
            out[model_parallel] = []
            for spec in specs:
                tr = parity._trainer(spec, torch.device("cpu"), process_group=data_group,
                                     tp_group=tp_group)
                res = parity._steps(tr, spec.batches, "cpu", g.data_index(rank), g.data_world)
                out[model_parallel].append({"losses": res["losses"],
                                            "state": res["state"] if rank == 0 else None})
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()
