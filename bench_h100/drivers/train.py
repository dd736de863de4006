"""Training driver: ``semseg_torch.engine.trainer.Trainer.step`` under
``deterministic_cudnn()``, as ``semseg_torch.train.run`` runs every step,
on a pool of seeded batches resident on the device (the host loader is out
of the window). The losses are read every ``print_freq`` steps, as
``run`` logs them, and nowhere else.

Set-up builds the one trainer, drives it through its first three steps
(batches 0-2: every row distinct) and hands that same trainer to the
window. The reference follows those three steps from the same weights,
batches and dropout masks (``compare.train_numbers``).

End to end: ``train_images_per_s`` (every step of the window, batch rows
over the window's seconds), ``peak_mem_gib``, ``setup_s``.
"""

from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import torch

from bench_h100.harness import compare, traffic, weights, work
from bench_h100.harness.trace import span
from bench_h100.reference import float32_exact, models, quant
from bench_h100.reference import train as ref_train

MEAN, STD = traffic.MEAN, traffic.STD
CHECKED_STEPS = 3


def build_trainer(config, mix, dev, state, rng_seed):
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model

    m, r = config["model"], config["recipe"]
    dtype = work.DTYPES[mix["dtype"]]
    model = build_model(SimpleNamespace(**m), dtype=dtype, device=dev, seed=0, train=True)
    model.load_state_dict(state, strict=True)
    opt = make_sgd(model, r["base_lr"], r["momentum"], r["weight_decay"])
    return Trainer(model, opt, classes=m["classes"], ignore_label=r["ignore_label"],
                   aux_weight=r["aux_weight"], base_lr=r["base_lr"], max_iter=r["max_iter"],
                   power=r["power"], zoom_factor=m["zoom_factor"], rng_seed=rng_seed,
                   normalize=(MEAN, STD))


def checked_steps(trainer, batches):
    """The first three steps: their losses, and by name the norms of the
    first gradient as the optimizer took it (its momentum buffer after one
    step) and of the change of every float state entry."""
    names = {p: n for n, p in trainer.module.named_parameters()}
    start = {k: v.detach().clone().float() for k, v in trainer.module.state_dict().items()
             if v.is_floating_point()}
    losses, first_grad, first_bn = [], None, None
    for images, labels in batches[:CHECKED_STEPS]:
        with span("bench.step"):
            metrics = trainer.step(images, labels)
        losses.append(metrics["loss"].detach().float())
        if first_grad is None:
            first_grad = {names[p]: s["momentum_buffer"].detach().float().clone()
                          for p, s in trainer.optimizer.state.items()}
            first_bn = compare.norms(compare.statistics_change(trainer.module, start))
    change = {k: v.detach().float() - start[k]
              for k, v in trainer.module.state_dict().items() if k in start}
    return ([float(v) for v in losses], compare.norms(first_grad), compare.norms(change),
            first_bn)


def run(ctx):
    from semseg_torch.utils.misc import deterministic_cudnn

    config, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    m, r = config["model"], config["recipe"]
    crop, b = m["train_h"], mix["batch"]
    ref_meta = models.build(config, "meta")
    weight_seed = traffic.seeds(ctx.seed, traffic.WEIGHTS, 1)[0]
    rng_seed = traffic.seeds(ctx.seed, traffic.DROPOUT, 1)[0]
    state = weights.make(ref_meta, weight_seed, dev)
    trainer = build_trainer(config, mix, dev, state, rng_seed)
    del state
    batches = [(torch.from_numpy(i).to(dev), torch.from_numpy(lab).to(dev))
               for i, lab in traffic.training_batches(ctx.seed, mix, crop)]

    with deterministic_cudnn():
        prog = checked_steps(trainer, batches)
        ctx.setup_done()
        steps, losses = 0, []
        with ctx.window() as win:
            t0 = time.perf_counter()
            t_end = t0 + ctx.seconds
            while time.perf_counter() < t_end:
                images, labels = batches[(CHECKED_STEPS + steps) % len(batches)]
                with span("bench.step"):
                    metrics = trainer.step(images, labels)
                losses.append(metrics["loss"])
                steps += 1
                if steps % r["print_freq"] == 0:
                    with span("bench.log"):
                        metrics["loss"].item()
            ctx.sync()
            window_s = time.perf_counter() - t0
    ctx.read_peak()
    finite = int(torch.isfinite(torch.stack(losses)).sum()) if losses else 0
    del trainer, metrics, losses
    gc.collect()
    ctx.free()

    e2e = {"train_images_per_s": steps * b / window_s}
    fwd_dtype = work.DTYPES[mix["dtype"]]
    hw = ((crop - 1) // (8 * m["shrink_factor"]) + 1) ** 2 if m["arch"] == "psa" else None
    psa_ms = None
    if hw is not None and ctx.cuda:  # on the CPU the port runs the kernels' plain versions
        psa_ms = 2 * sum(f(b, 512, hw, fwd_dtype)[0] for f in (
            work.psa_fwd_bound, work.psa_dx_bound, work.psa_da_bound))
    work_done = {"unit": "step", "units": steps, "dtype": fwd_dtype,
                 "flops_per_unit": work.train_step_flops(config, b, crop),
                 "psa_bound_ms_per_unit": psa_ms}

    ref = reference_steps(ctx, ref_meta, weight_seed, rng_seed, batches, None)
    numbers = compare.train_numbers(prog, ref)
    control = None
    if ctx.control:
        low = reference_steps(ctx, ref_meta, weight_seed, rng_seed, batches, ctx.control)
        control = {k: v for k, (v, _) in compare.train_numbers(low, ref).items()}
    return dict(e2e=e2e, attempted=steps, failed=steps - finite, numbers=numbers,
                control=control, work=work_done, trace=win.trace)


def reference_steps(ctx, ref_meta, weight_seed, rng_seed, batches, lower):
    """The reference's three steps from the same weights (made again from
    the seed), batches and dropout stream; ``lower``: the control's
    precision. Losses and norms, on the host."""
    config, dev = ctx.cell.config, ctx.device
    ref = models.build(config, dev)
    ref.load_state_dict(weights.make(ref_meta, weight_seed, dev), strict=True)
    with float32_exact(), quant.lowered(lower) if lower else contextlib.nullcontext():
        out = ref_train.run_steps(ref, batches[:CHECKED_STEPS], recipe=config["recipe"],
                                  rng_seed=rng_seed, mean=MEAN, std=STD)
    losses, first_grad, change, first_bn = out
    out = ([float(v) for v in losses], compare.norms(first_grad), compare.norms(change),
           compare.norms(first_bn))
    del ref, first_grad, change
    gc.collect()
    ctx.free()
    return out
