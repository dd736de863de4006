"""Serving driver: ``SlidingWindowEvaluator.predict_async`` in a closed
loop with ``in_flight`` requests queued, as ``semseg_torch/test.py`` keeps
them; each request is one uint8 street image from a seeded pool, its class
map read back to the host in order.

End to end: ``serve_images_per_s`` (every request completed over the
window, drain included), ``peak_mem_gib``, ``setup_s``. Correct: every
completed request of the sampled pool images against the plain pipeline
(``compare.MapStats``).

The served weights are the published initialisation with BatchNorm at its
initial statistics, so the features reaching the classifier carry a large
mean of their own. On some seeds that mean alone picks one class at every
pixel by a wide margin, and no precision moves a pixel of such a map. So
set-up centres the classifier: its bias less its weights times the mean of
its input over the first pool image's windows (scale 1, flips), taken by
the reference in float32. The maps then follow the features' variation on
every seed.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_h100.harness import compare, traffic, weights, work
from bench_h100.harness.trace import span
from bench_h100.reference import float32_exact, models, pipeline, quant

MEAN, STD = traffic.MEAN, traffic.STD


@dataclasses.dataclass
class Served:
    done: list            # (request index, pool index, class map)
    window_s: float
    submitted: int


def closed_loop(ev, pool, in_flight, *, seconds=None, requests=None, sync=lambda: None):
    """Submit while fewer than ``in_flight`` are queued, read the oldest
    back; stop submitting after ``seconds`` (or ``requests``), drain."""
    done, pending = [], collections.deque()
    i = 0
    t0 = time.perf_counter()
    t_end = t0 + (seconds if seconds is not None else float("inf"))
    while True:
        while len(pending) < in_flight and (
                (requests is None and time.perf_counter() < t_end)
                or (requests is not None and i < requests)):
            with span("bench.submit"):
                out = ev.predict_async(pool[i % len(pool)])
            pending.append((i, out))
            i += 1
        if not pending:
            break
        j, out = pending.popleft()
        with span("bench.readback"):
            cls_map = out.cpu().numpy()
        done.append((j, j % len(pool), cls_map))
    sync()
    return Served(done, time.perf_counter() - t0, i)


def per_image_work(config, mix):
    """FLOPs of one request (real windows x 2 for the mirror, the padding
    slots of a last chunk left out) and the fused stitch's least time an
    image (one launch a chunk, padding slots included: the kernel reads
    them)."""
    m = config["model"]
    crop = m["test_h"]
    wb = max(2, mix["window_batch"]) // 2
    windows, launches = 0, []
    for s in mix["scales"]:
        nh, nw = pipeline.scaled_size(mix["image_h"], mix["image_w"], s, m["base_size"])
        n = len(pipeline.grid(max(nh, crop), max(nw, crop), crop, 2 / 3))
        per = min(wb, n)
        windows += n
        launches += [per] * -(-n // per)
    feat = (crop - 1) // 8 + 1
    return {"flops": 2 * windows * work.forward_flops(config, 1, crop, train=False),
            "windows": windows, "chunks": len(launches),
            "stitch_ms": sum(work.stitch_bound(p, m["classes"], feat, crop)[0]
                             for p in launches)}


def centre_classifier(config, state, image, dev):
    """Subtract from the classifier's bias (in ``state``) its weights times
    the mean of its input over ``image``'s windows at scale 1 with their
    mirrors, through the reference in float32. One window and its mirror a
    forward, so that the pass stays far under the program's own memory
    peak (eight a forward raised ``peak_mem_gib`` by 2.2 GiB)."""
    m = config["model"]
    ref = models.build(config, dev)
    ref.load_state_dict(state, strict=True)
    ref.eval()
    last = ref.cls[-1]
    sums = []
    hook = last.register_forward_pre_hook(
        lambda _mod, args: sums.append((args[0].double().sum((0, 2, 3)),
                                        args[0][:, 0].numel())))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with float32_exact():
            pipeline.mean_probs(ref, image, crop=m["test_h"], base_size=m["base_size"],
                                scales=[1.0], mean=MEAN, std=STD, batch=1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        hook.remove()
    mean = sum(s for s, _ in sums) / sum(n for _, n in sums)
    name = f"cls.{len(ref.cls) - 1}"
    w = state[f"{name}.weight"].double().flatten(1)
    state[f"{name}.bias"] = (state[f"{name}.bias"].double() - w @ mean).float()
    del ref, sums
    gc.collect()


def run(ctx):
    config, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    m = config["model"]
    dtype = work.DTYPES[mix["dtype"]]
    ref_meta = models.build(config, "meta")
    weight_seed = traffic.seeds(ctx.seed, traffic.WEIGHTS, 1)[0]

    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.models.build import build_model

    pool = traffic.serving_pool(ctx.seed, mix)
    state = weights.make(ref_meta, weight_seed, dev)
    centre_classifier(config, state, pool[0], dev)
    model = build_model(SimpleNamespace(**m), dtype=dtype, device=dev, seed=0)
    model.load_state_dict(state, strict=True)
    ev = SlidingWindowEvaluator(
        model, classes=m["classes"], crop_h=m["test_h"], crop_w=m["test_w"], mean=MEAN,
        std=STD, base_size=m["base_size"], scales=mix["scales"], flip=True,
        window_batch=mix["window_batch"], mode="device", device=dev)
    closed_loop(ev, pool, mix["in_flight"], requests=mix["warmup_requests"], sync=ctx.sync)
    ctx.setup_done()

    with ctx.window() as win:
        served = closed_loop(ev, pool, mix["in_flight"], seconds=ctx.seconds, sync=ctx.sync)
    ctx.read_peak()
    fused = bool(ev.fused_stitch)
    del ev, model
    gc.collect()
    ctx.free()

    n = len(served.done)
    e2e = {"serve_images_per_s": n / served.window_s}
    per_image = per_image_work(config, mix)
    work_done = {"unit": "image", "units": n, "dtype": dtype,
                 "flops_per_unit": per_image["flops"],
                 "stitch_bound_ms_per_unit": per_image["stitch_ms"] if fused else None}

    numbers, control = check(ctx, served, pool, state)
    return dict(e2e=e2e, attempted=served.submitted, failed=served.submitted - n,
                numbers=numbers, control=control, work=work_done, trace=win.trace)


def check(ctx, served, pool, state):
    """The sampled pool images' reference maps against every completed
    request of those images; with ``ctx.control``, the control's class maps
    (the reference in a lower precision) against the same maps."""
    config, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    m = config["model"]
    used = sorted({d[1] for d in served.done})
    rs = np.random.RandomState(traffic.seeds(ctx.seed, traffic.SAMPLE, 1)[0])
    picked = rs.choice(used, size=min(mix["check_images"], len(used)), replace=False)
    ref = models.build(config, dev)
    ref.load_state_dict(state, strict=True)
    ref.eval()
    kw = dict(crop=m["test_h"], base_size=m["base_size"], scales=mix["scales"], mean=MEAN,
              std=STD)
    plain = copy.deepcopy(ref).to(torch.bfloat16)
    served_stats, plain_stats, control_stats = (compare.MapStats() for _ in range(3))
    requests = 0
    with float32_exact():
        for k in picked:
            probs = pipeline.mean_probs(ref, pool[k], **kw)
            for _, idx, cls_map in served.done:
                if idx == k:
                    served_stats.add(probs, torch.from_numpy(cls_map).to(dev))
                    requests += 1
            low = pipeline.mean_probs(plain, pool[k], dtype=torch.bfloat16, **kw)
            plain_stats.add(probs, low.argmax(0))
            if ctx.control:
                with quant.lowered(ctx.control):
                    low = pipeline.mean_probs(ref, pool[k], **kw)
                control_stats.add(probs, low.argmax(0))
                del low
            del probs
    at = f"{requests} requests of {len(picked)} pool images"
    numbers = {k: (v, at) for k, v in served_stats.numbers(plain_stats).items()}
    control = control_stats.numbers(plain_stats) if ctx.control else None
    return numbers, control
