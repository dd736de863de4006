"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's serving paths and its training path once at full width,
with seeded random weights, on Cityscapes-size 1024x2048 images: serving
(single scale and the six scales of the reference's multi-scale protocol,
flip TTA, bf16, ``window_batch`` 8) with PSPNet50 on 713x713 windows and
PSANet50 (bi-direction, shrink 2, 89x89 mask) on 705x705 windows; PSANet50
training (``config/cityscapes/cityscapes_psanet50.yaml``,
bf16, batch 16, 705x705 crops) through ``semseg_torch.train.run`` on a
seeded synthetic list-file dataset written under ``build/``; and the
user's workflow through the drivers: train with validation, a preemption
snapshot, resume, the test driver and the demo (phase 20); two DDP ranks
sharing the card (phase 21); the serving export of both models (phase
22); and the evaluator's window and spatial partitions over two entries of
the card and its host pipeline (phase 23); tensor-parallel ranks (phase
24); the bf16-vs-f32 convergence license and the launch scripts (phase
25); the 101-layer Cityscapes recipes with and without ``remat``
(phase 26); and reproducible float32 training through the driver on the
ADE20K PSPNet50 and Cityscapes PSANet50 recipes, the evaluator's bounded
per-shape caches, ADE20K and VOC2012 serving (phase 27). The CUDA
kernels are built from ``semseg_torch/csrc`` on first use. Phases, one line
each (12 runs after 4):

1. device: the card's name and power limit; TF32 off;
2. build: compile the kernel libraries in parallel (one nvcc each), print
   the seconds and each kernel's registers and spills;
3. stitch kernel vs plain on the card at the Cityscapes and ADE20K shapes
   (max abs diff and row sums within 2e-2), with both times (CUDA events,
   median of 20);
4. PSA forward vs plain: the resident and the flash entry points against
   the plain softmax + bmm at (N, C, hw) = (8, 512, 900), (8, 512, 2025),
   (16, 512, 2025) and (1, 512, 7921), bf16 and f32 operands, A = randn *
   3. Both run the tensor-core forward of the dtype. f32 operands run it as
   3xTF32: within 1e-4 * max|plain| + 1e-5 and element by element within
   the JAX package's f32 bar, rtol = atol = 1e-5, against a float64 plain
   version (``elementwise_f64``). bf16 operands run it in one bf16 pass:
   element by element within 2^-8 (|x| @ p) / norm + 1e-6 (``fwd_bars``)
   and within rtol = atol = 1e-2. Two resident calls give bit-identical
   results, and the flash entry point's ``out``, ``m`` and ``l`` are bit
   for bit the resident's; ``m`` exact and ``l`` within 1e-5 relative;
   resident, flash and plain times and the bound;
12. PSA backward kernels vs plain at the same extents: da, dx and the
   flash backward's route (the same tensor-core dx and da from the flash
   forward's statistics) against the plain backward from the same
   statistics; f32 within 1e-4 * max|plain| + 1e-5, the 3xTF32 dx element
   by element within the JAX package's f32 VJP bar (rtol 1e-4, atol 1e-5)
   against a float64 plain version (``elementwise_f64``), and the 3xTF32 da
   element by element within that bar plus f32's cancellation term in
   dP - delta (``da_f32_ratios``; its ratio to JAX's bar alone printed);
   bf16 da and dx on the tensor cores element by element within p 2^-8
   (|x|^T |g|) / norm and 2^-7 (|g| @ p^T) / norm, each plus one bf16 ulp
   of |plain| (``da_bars``, ``dx_bars``); the tensor-core da and dx give
   bit-identical results in two calls; kernel, plain and plain-autograd
   times and the bounds;
5. PSPNet slice: ``build_evaluator`` answers requests; each must launch the
   stitch kernel exactly twice (two chunks) and no PSA kernel; images/s;
6. PSPNet fused vs plain stitch: argmax agreement >= 0.995, probabilities
   within 2e-2 (share of near-tied pixels printed beside);
7. PSPNet f32: one 713x713 window's logits on the card and on the CPU,
   max relative error <= 1e-3 (catches TF32);
8. PSANet slice: each request must launch the tensor-core resident
   forward exactly 4 times (2 chunks x 2 directions), the stitch kernel
   twice and no other kernel; images/s;
9. PSANet kernel vs plain attention: one image with ``fused_attention``
   off (both sides use the fused stitch): agreement >= 0.995,
   probabilities within 2e-2;
10. PSANet shrink 1 (f32, mask 177x177, hw 7921): one 705x705 window and
   its flip call the flash forward exactly twice, which launches the
   3xTF32 forward twice; logits within 1e-3 relative of the plain
   attention;
11. PSANet f32: one 705x705 window through the 3xTF32 resident kernel on
   the card against the plain version on the CPU, 1e-3 relative;
13. PSANet50 training slice: 48 street-like 1024x2048 images with label
   PNGs, ``run`` with ``compute_dtype bfloat16``, ``batch_size 16`` (12 or
   8 if 16 does not fit), ``epochs 1``: every step launches the
   tensor-core forward, da and dx twice each and nothing else; finite
   losses;
14. the train step alone on a device-resident batch (2 warm-up, 5 timed
   steps, the same launches per step): seconds per step, images/s, peak
   memory; the loader's images/s; a ``torch.profiler`` window of 2 steps
   (device busy, idle share, the PSA kernels' device time, top kernels in
   ``build/chip_smoke/``);
15. PSPNet50 bf16, 3 train steps through the same Trainer: no PSA launch;
16. PSANet50 f32 train step, batch 2: the 3xTF32 forward, dx and da
   twice each, against plain attention: losses within 1e-5
   relative and every parameter gradient within the relative bar of
   ``GRAD_REL``; then the f32 step timed at batch 8 on a device-resident
   batch (2 warm-up, 5 timed steps, the same launches per step): images/s,
   peak memory, and the PSA kernels' share of a profiler window of 2 steps;
17. the same at shrink 1 (hw 7921): the flash forward's route and the
   flash backward's route (their own counts, and the 3xTF32 forward, dx
   and da they launch) twice each; gradients against
   plain attention; seconds per step over 3 more steps;
18. the PSA module at full width (2048 -> 512, 89x89 input, batch 2),
   f32, eval-mode BN: output and input gradient on the card against the
   CPU within 1e-3 relative, parameter gradients within ``PARAM_REL``; the
   same with TF32 on must fail those bars (else the check is blind to TF32);
19. multi-scale serving, scales 0.5, 0.75, 1.0, 1.25, 1.5, 1.75 (the
   reference's protocol, named in the configs' TEST section), bf16, flip,
   ``window_batch`` 8: PSPNet50 (81 windows, 22 chunks a 1024x2048 image)
   and PSANet50 (84 windows, 23 chunks), one warm-up and 2 timed requests
   each. Each request must launch the stitch kernel once a chunk and, for
   PSANet50, the bf16 tensor-core forward twice a chunk (two directions),
   nothing else; ``predict`` equals the argmax of ``predict_probs`` (but on
   exact ties of the mean); PSANet50 with ``fused_attention`` off against
   on: agreement >= 0.995, probabilities within 2e-2; images/s with the
   card's name and power limit; a ``torch.profiler`` window of one request
   (idle share, top kernels in ``build/chip_smoke/``);
20. drivers, the user's workflow on the 1024x2048 street data of phase 13:
   ``semseg_torch.train.run`` of ``cityscapes_psanet50.yaml`` (bf16, batch
   8, 705 crops, 16 training images: 2 steps an epoch, 2 epochs,
   ``evaluate True`` on 4 images, ``profile_dir`` set: the first epoch's
   Chrome trace must name the bf16 PSA kernels), uninterrupted, then stopped by the
   preemption hook after step 3 and resumed with ``resume auto``: the
   snapshot after step 3 and gone after the resumed epoch save, two epoch
   files (keep-2), the resumed state equal to the uninterrupted run's bit
   for bit, or else within twice the spread of a second uninterrupted run
   that differs from the first; every train step launches the bf16 forward, da and
   dx twice each, every validation batch the bf16 forward twice; finite
   validation mIoU; checkpoint save, async save and restore seconds. Then
   ``semseg_torch.test.run`` with the trained ``.pth`` over the 4 images
   (f32, single scale, flip): gray and color PNGs, ``cal_acc``'s mIoU, the
   3xTF32 forward 4 times an image, images/s beside ``predict`` alone; the
   demo on one image, its gray PNG equal to the test driver's; the Python
   and the native host loaders' images/s;
21. data-parallel training as two ranks sharing the card over gloo
   (named in the config: NCCL needs a device per rank): one f32 PSANet50
   step at 705x705, global batch 4, as 2 DDP ranks against the
   one-process ``Trainer(num_replicas=2)``, the state within ``DDP_K``
   times the one-ulp floor measured here and the losses within 1e-5,
   each rank launching the 3xTF32 forward, da and dx twice; then the bf16
   driver through ``semseg_torch.train.spawn`` (``train_gpu [0, 0]``,
   global batch 16, 3 steps): each rank's launches exact, one checkpoint
   written and logged by rank 0 alone, peak memory a rank, images/s
   beside phase 14's (not a scaling number);
22. serving export (``semseg_torch/engine/export.py``), float32 as the
   export driver builds: the CUDA-targeted PSANet50 crop artifact (705),
   traced (after one eager call, its only launches), saved and reloaded in
   a fresh process (TF32 on
   there until the artifact's contract turns it off): within 1e-6 of the
   in-framework module at batch 1 and 3, exactly 2 3xTF32 forwards a call
   through the operator ``semseg::psa_softmax_bmm``, ms a call; the
   CUDA-targeted PSANet50 and the portable PSPNet50 full-scope artifacts
   at 1024x2048 (single scale, flip, ``window_batch`` 8): byte for byte
   ``predict`` on 2 images, exactly 4 3xTF32 forwards an image (PSANet50)
   and no kernel (PSPNet50), images/s beside ``predict``'s; trace, save
   and load seconds and artifact sizes;
23. the evaluator over ``devices=[cuda:0, cuda:0]`` (two entries sharing
   one replica on the card): ``partition="window"``, bf16, 2 images of
   each model, the stitch kernel on each entry's pairs (4 an image) and
   PSANet50's bf16 forward twice an entry a chunk (8 an image); bit for
   bit (so within 2e-2, agreement >= 0.995) the single-device evaluator
   that runs each entry's forward batch (``window_batch`` 4), and beside
   it, not gated, the bf16 forward's own spread against ``window_batch``
   8. ``"window"`` and ``"spatial"``, f32, 1 image of each model (spatial:
   rows split over the entries, PSANet50's PSA module whole on the
   primary, the 3xTF32 forward 4 times; window: 8 times); within 1e-4 of
   one device, agreement >= 0.999. ``"spatial"``, bf16, 1 image of each
   model: the stitch once a chunk on the primary on the gathered logits (2
   an image), PSANet50's bf16 forward twice a chunk (4 an image); its
   spread from one device within 1.5x that of one device at
   ``window_batch`` 4 against 8, and its distance to the f32 result within
   1.25x one device's (``bf16_spatial_gate``). ``mode="host"``, PSPNet50
   f32, 1 image,
   against device mode at JAX's bar (atol 2e-2, rtol 1e-2, agreement >
   0.995). images/s of each path, two entries on one card, not a scaling
   number;
24. tensor parallelism (``model_parallel 2``) as ranks sharing the card
   over gloo: the PSA kernels at a rank's C = 256 against plain with the
   bars of phases 4 and 12, one f32 PSANet50 step as 1 x 2 and 2 x 2
   (data x model) against one process, the bf16 driver through ``spawn``;
25. the bf16-vs-f32 convergence license (``semseg_torch/convergence.py``,
   97x97 crops, batch 8, 6 classes): the PSA forward, da and dx at (8,
   512, 49), less than one tile, against plain with the bars of phases 4
   and 12; then ``convergence.run`` for PSPNet50 and PSANet50, the f32 arm
   then the bf16 arm from one f32 init (seed 0, 400 steps): initial states
   bit for bit the init, TF32 off in the f32 arm, finite losses, exact
   launches (PSANet50: 2 forwards, 2 da and 2 dx of the dtype a step, 2
   forwards a validation batch; PSPNet50: none), every final val mIoU >=
   0.5 and |gap| < 10 points (the JAX tool's 1-point verdict printed
   beside); beside the arms, in processes of its own,
   ``semseg_torch/tool/train.sh`` on a PSANet50 config in
   ``build/chip_smoke/launch/``: exit 0, the snapshot, the timestamped
   train and test logs, the checkpoint, the PNGs, and the kernels built
   under the snapshot's own ``build/``;
26. the 101-layer Cityscapes recipes and ``remat`` (each residual block of
   layer1..layer4 recomputed in the backward pass): PSANet101 f32 at
   705x705, batch 8, 2 steps from the same weights and batch with and
   without ``remat`` (``cudnn.deterministic`` on): losses, parameters,
   momentum buffers and running statistics bit for bit,
   ``num_batches_tracked`` 2 in both, the 3xTF32 forward, da and dx twice a
   step; seconds a step and peak memory each; PSANet101 f32 at the
   recipe's batch 16 with ``remat``: seconds a step, images/s, peak
   memory; the bf16 PSANet101 recipe (batch 16) through
   ``semseg_torch.train.run`` with ``remat True`` as a CLI override and
   without: 2 steps on phase 13's street images, the tensor-core forward,
   da and dx twice a step, peak memory, the step on a device-resident
   batch; PSPNet101 (713) and PSANet101 (705) serving, bf16, single scale,
   flip, ``window_batch`` 8, 4 timed 1024x2048 requests each, the
   BatchNorm statistics taken from train-mode windows as training leaves
   them (with the init's, eval BatchNorm grows the logits to about 1e4):
   the stitch twice and PSANet101's bf16 forward 4 times a request,
   images/s, fused against plain at the bars of phases 6 and 9;
27. reproducible float32 training through ``semseg_torch.train.run``
   (which trains under cuDNN's deterministic algorithms): the ADE20K
   PSPNet50 recipe (``config/ade20k/ade20k_pspnet50.yaml``, 150 classes,
   473x473 crops, batch 16) on 32 seeded ADE20K-like images of distinct
   sizes (long side 256-2048, labels 0-149 and 255), and the Cityscapes
   PSANet50 recipe at 705x705, batch 8, on 16 of phase 13's street images;
   each 2 epochs of 2 steps, twice uninterrupted and once stopped by the
   preemption hook after step 3 and resumed with ``resume auto``: every
   state entry (weights, BN statistics, ``num_batches_tracked``, momentum,
   the step) of the three runs bit for bit, the launches exact (PSANet50:
   the 3xTF32 forward, da and dx twice a step; PSPNet50: none); then
   ``semseg_torch.test.run`` (f32) with the first ADE20K run's checkpoint
   over 24 of those images, so the driver picks ``device_bucketed``: after
   each image the allocated memory and the per-shape caches' entries, each
   cache within ``CACHE_ENTRIES``, the memory beside the caches flat within
   ``RESIDUAL_MIB``, an evicted size and a fresh evaluator bit for bit the
   driver's PNGs; bf16 ADE20K PSANet50 serving (465x465 windows, hw 900)
   over the 24 images with the stitch kernel once a chunk and the bf16
   forward twice a chunk, fused against unfused stitch at 150 classes at
   phase 6's bars; one VOC2012 PSPNet50 request (21 classes).

Every path is driven with all launch counts set to 0 just before it and
read just after. Any failure raises (non-zero exit). The process imports
no jax and nothing of the JAX package (the port reads configs and data
through its own ``semseg_torch.config`` and ``semseg_torch.data``); that is
checked at the end. The line before the last is the kernels' JSON record
(each kernel at the shape and dtype of the path it serves, with its bound
on an H100 SXM; the flash forward's and the flash backward's rows are
their routes, the 3xTF32 forward, and the 3xTF32 dx and da, each counted
on its own); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""

import dataclasses
import json
import logging
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

TOL = 2e-2  # bf16 output rounding at two places + expf ulps
PSA_REL = 1e-4  # f32 sums over up to 7921 terms, in another order than cuBLAS
N_TIMED = 8  # timed requests per slice
PSA_EXTENTS = (("ade20k-465", 8, 512, 900), ("cityscapes-705", 8, 512, 2025),
               ("cityscapes-705-b16", 16, 512, 2025), ("shrink1-705", 1, 512, 7921))
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense bf16 and TF32
# tensor-core and f32 (outside the tensor cores) operations/s.
PEAK_BYTES, PEAK_BF16, PEAK_TF32, PEAK_F32 = 3.35e12, 989e12, 495e12, 67e12
# Phases 16-17: relative L2 distance of each parameter gradient, kernels
# against plain attention (f32 sums in another order, amplified through
# 50+ train-mode BN layers from a random init).
GRAD_REL = 1e-2  # measured at most 3.9e-3 (H100 80GB HBM3, 700 W)
# Phase 18: each PSA parameter gradient, GPU against CPU (the f32 noise
# floor behind the softmax VJP of a near-uniform attention, see there):
# at most 1.42e-2 with TF32 off and 5.57e-2 with it on, the same in each of
# three runs (H100 80GB HBM3, 700 W). The TF32-on run must fail the bar.
PARAM_REL = 3e-2
# Phase 12: the f32 da's cancellation term, in units of 2^-24 (|x|^T |g| /
# norm + sum_c |g out|) p (see ``da_f32_ratios``).
DA_F32_K = 2.0
OUT_DIR = Path("build") / "chip_smoke"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the current stream (CUDA events).
    Before each timed call the device spins for about a millisecond, so it
    is still busy while the host enqueues ``fn``'s launches: the events then
    time the device's work, not the wrapper's Python."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernels():
    """The launch-counting wrappers of every kernel, by name: the stitch
    kernel, the ``_wgmma`` bf16 tensor-core kernels and the ``_tf32x3``
    3xTF32 kernels, which the PSA entry points launch for bf16 and f32
    operands; ``psa_softmax_bmm_flash`` and ``psa_softmax_bmm_flash_bwd``
    count the flash forward's and backward's routes (their calls on CUDA
    tensors), which launch those kernels."""
    from semseg_torch.ops import psa
    from semseg_torch.ops.stitch import upsample_softmax_flip

    return {"upsample_softmax_flip": upsample_softmax_flip,
            "psa_softmax_bmm_wgmma": psa.psa_softmax_bmm_wgmma,
            "psa_softmax_bmm_tf32x3": psa.psa_softmax_bmm_tf32x3,
            "psa_softmax_bmm_flash": psa.psa_softmax_bmm_flash,
            "psa_softmax_bmm_bwd_da_wgmma": psa.psa_softmax_bmm_bwd_da_wgmma,
            "psa_softmax_bmm_bwd_da_tf32x3": psa.psa_softmax_bmm_bwd_da_tf32x3,
            "psa_softmax_bmm_bwd_dx_wgmma": psa.psa_softmax_bmm_bwd_dx_wgmma,
            "psa_softmax_bmm_bwd_dx_tf32x3": psa.psa_softmax_bmm_bwd_dx_tf32x3,
            "psa_softmax_bmm_flash_bwd": psa.psa_softmax_bmm_flash_bwd}


def bound(nbytes, flops, dtype, products=True):
    """``(ms, "bytes" or "operations")``: the least time for a function
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``flops`` operations of ``dtype``, on an H100 SXM. Matrix
    products (``products``) run on the tensor cores: bf16 at the bf16 rate,
    f32 at HIGHEST precision as 3xTF32, three TF32 passes (the cheapest
    route within the f32 bars); other f32 operations outside them."""
    byte_ms = nbytes / PEAK_BYTES * 1e3
    if not products:
        op_ms = flops / PEAK_F32 * 1e3
    elif dtype == torch.bfloat16:
        op_ms = flops / PEAK_BF16 * 1e3
    else:
        op_ms = 3 * flops / PEAK_TF32 * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def psa_fwd_bound(n, c, hw, dtype):
    """The PSA forward: reads x and A, writes f32 out; 2 N C hw^2 FLOP."""
    esz = 2 if dtype == torch.bfloat16 else 4
    return bound(n * hw * hw * esz + n * c * hw * (esz + 4), 2 * n * c * hw * hw, dtype)


def psa_dx_bound(n, c, hw, dtype):
    """dx: reads A, f32 g, m and l, writes dx in x's dtype; 2 N C hw^2."""
    esz = 2 if dtype == torch.bfloat16 else 4
    return bound(n * hw * hw * esz + n * c * hw * (4 + esz) + 2 * n * hw * 4,
                 2 * n * c * hw * hw, dtype)


def psa_da_bound(n, c, hw, dtype):
    """da: reads x, A, f32 g and out, m and l, writes da; 2 N C hw^2."""
    esz = 2 if dtype == torch.bfloat16 else 4
    return bound(2 * n * hw * hw * esz + n * c * hw * (esz + 8) + 2 * n * hw * 4,
                 2 * n * c * hw * hw, dtype)


def fwd_bars(x, a, norm=1.0):
    """The tensor-core forward's bar, element by element: one bf16 rounding
    of p (2^-9 relative) with a factor 2 for the order of the f32 sums,
    2^-8 (|x| @ p) / norm + 1e-6."""
    p = torch.softmax(a.float(), dim=1)
    return 2.0 ** -8 * torch.bmm(x.float().abs(), p) / norm + 1e-6


def dx_bars(a, g, m, l, dx32, norm=1.0):
    """The tensor-core dx's bar: g and p each rounded to bf16, 2^-7 (|g| @
    p^T) / norm, plus one bf16 ulp of |plain| for the bf16 output."""
    from semseg_torch.ops.psa import _probs

    p = _probs(a, m, l)
    ulp = 2.0 ** (torch.floor(torch.log2(dx32.abs().clamp_min(1e-30))) - 7)
    return 2.0 ** -7 * torch.bmm(g.abs(), p.transpose(1, 2)) / norm + ulp


def da_bars(x, a, g, m, l, da32, norm=1.0):
    """The tensor-core da's bar: g rounded to bf16 (x is bf16 already),
    p 2^-8 (|x|^T |g|) / norm, plus one bf16 ulp of |plain| for the bf16
    output (derivation at ``tests/test_torch_cuda.py::_da_bars``)."""
    from semseg_torch.ops.psa import _probs

    p = _probs(a, m, l)
    ulp = 2.0 ** (torch.floor(torch.log2(da32.abs().clamp_min(1e-30))) - 7)
    return p * 2.0 ** -8 * torch.bmm(x.float().abs().transpose(1, 2), g.abs()) / norm + ulp


def elementwise_f64(got, x, p, norm=1.0, rtol=1e-5, atol=1e-5):
    """``(ratio, want64)``: the largest |got - x @ p / norm| / (atol + rtol
    |x @ p / norm|) with the product in float64 on the card. It holds an f32
    kernel to a JAX package's element-wise f32 bar against f32 arithmetic's
    exact result: at hw 2025 the plain f32 version's own rounding (f32 sums
    over hw terms) takes up to 0.64 of JAX's 1e-5 bar, and at hw 7921 more
    than all of it (H100 80GB HBM3, ``chip_probes/psa_tf32x3_check.py``)."""
    want64 = torch.bmm(x.double(), p.double()) / norm
    return ((got.double() - want64).abs() / (atol + rtol * want64.abs())).max().item()


def da_f32_ratios(da, x, a, g, m, l, out, norm=1.0):
    """``(jax, derived)``: the largest |da - want64| over JAX's f32 VJP bar,
    1e-5 + 1e-4 |want64|, and over the derived bar

        1e-4 |want64| + 1e-5 + DA_F32_K p 2^-24 (|x|^T |g| / norm + sum_c |g out|),

    with want64 = p (x^T g / norm - delta) in float64 on the card: p from
    the same m and l, delta = sum_c g out from the same f32 forward output.
    JAX's bar sits at f32's own floor for da: where p is near 1 and dP ~
    delta, |da| ~ 0 and the atol alone is left, while dP and delta are f32
    sums of C terms whose roundings are each up to 2^-24 times the sum of
    the magnitudes, |x|^T |g| / norm and sum_c |g out|. The f32 plain da
    takes up to 2.372 of JAX's bar at (8, 512, 2025) (H100 80GB HBM3, 700 W,
    ``chip_smoke.py``); the derived bar adds DA_F32_K such roundings of
    each, scaled by p. A single TF32 pass (2^-11 per operand) fails it
    (``tests/test_torch_cuda.py::test_f32_da_runs_the_tf32x3_kernel``)."""
    p64 = torch.exp(a.double() - m.double()[:, None]) / l.double()[:, None]
    d64 = (g.double() * out.double()).sum(1)
    want64 = p64 * (torch.bmm(x.double().transpose(1, 2), g.double()) / norm - d64[:, None])
    err = (da.double() - want64).abs()
    jax = (err / (1e-5 + 1e-4 * want64.abs())).max().item()
    mag = (torch.bmm(x.double().abs().transpose(1, 2), g.double().abs()) / norm
           + (g.double() * out.double()).abs().sum(1)[:, None])
    bar = 1e-4 * want64.abs() + 1e-5 + DA_F32_K * 2.0 ** -24 * p64 * mag
    return jax, (err / bar).max().item()


def launches(**nonzero):
    """Expected counts: every kernel 0 but the ones named."""
    return {name: nonzero.get(name, 0) for name in kernels()}


def reset_counts():
    for fn in kernels().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernels().items()}


def check_counts(label, got, want):
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected {want}")


def street_sample(seed, h=1024, w=2048):
    """A seeded street-like uint8 RGB image (sky band, buildings of random
    widths and colours, road with lane marks, pixel noise) and its
    Cityscapes label map (road 0, building 2, wall 3, vegetation 8, sky 10,
    ignore 255 on the bottom rows, where the ego vehicle would be)."""
    rs = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.float32)
    label = np.full((h, w), 10, np.uint8)
    yy = np.arange(h, dtype=np.float32)[:, None]
    horizon, road = int(h * rs.uniform(0.3, 0.4)), int(h * rs.uniform(0.6, 0.7))
    img[:horizon] = np.array([120, 170, 230]) + (yy[:horizon, :, None] / h) * 40
    x, k = 0, 0
    while x < w:
        bw = rs.randint(60, 300)
        img[horizon:road, x:x + bw] = rs.randint(40, 200, 3)
        label[horizon:road, x:x + bw] = (2, 8, 3)[k % 3]
        x, k = x + bw, k + 1
    img[road:] = [85, 85, 90]
    label[road:] = 0
    for lane in range(rs.randint(2, 5)):
        x0 = rs.randint(0, w - 40)
        img[road + 20:, x0:x0 + 12] = [230, 230, 230]
    img += rs.randint(-8, 9, img.shape)
    label[h - h // 16:] = 255
    return np.clip(img, 0, 255).astype(np.uint8), label


def street_image(seed, h=1024, w=2048):
    return street_sample(seed, h, w)[0]


def street_batch(dev, batch, crop, seed0):
    """``batch`` seeded street samples' top-left ``crop`` x ``crop`` pixels
    and labels, uint8 on the device (the Trainer normalises)."""
    pairs = [street_sample(seed0 + s) for s in range(batch)]
    images = torch.from_numpy(np.stack([p[0][:crop, :crop] for p in pairs])).to(dev)
    labels = torch.from_numpy(np.stack([p[1][:crop, :crop] for p in pairs])).to(dev)
    return images, labels


def phase_device():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = "nvidia-smi: absent"
    if shutil.which("nvidia-smi"):
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        smi = res.stdout.strip().splitlines()[0]
    log(smi)
    return name, smi


def ptxas_summary(build_log):
    """``kernel<dtype>: R regs, S/L B spilled`` for each entry function of
    an nvcc ``-Xptxas -v`` log."""
    out, cur = [], None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            k = re.search(r"\d((?:psa|upsample)_[a-z0-9_]*_kernel)", mangled)
            tags = [tag for pat, tag in (("13__nv_bfloat16", "bf16"), ("kernelIf", "f32"),
                                         ("Lb0E", "fwd"), ("Lb1E", "dx")) if pat in mangled]
            mt = re.search(r"_kernelILi(\d)E", mangled)
            if mt:
                tags.insert(0, f"mt{mt.group(1)}")
            cur = {"name": (k.group(1) if k else mangled) + f"<{','.join(tags)}>"}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill"] = f"{m.group(1)}/{m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["regs"] = f"{m.group(1)} regs"
    return [f"{k['name']}: {k.get('regs', '?')}, {k.get('spill', '?')}" for k in out]


def phase_build():
    from semseg_torch.ops._build import build_library

    names = ("stitch", "psa")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build_library, names))
    wall = time.perf_counter() - t0
    for name, b in zip(names, builds):
        log(f"[2 build] {b.path.name}: {b.seconds:.2f} s (built={b.built}) "
            f"{ptxas_summary(b.log)}")
    log(f"[2 build] wall {wall:.2f} s for {len(names)} libraries in parallel")


def phase_stitch_kernel(dev):
    from semseg_torch.ops.stitch import (
        upsample_softmax_flip,
        upsample_softmax_flip_reference,
    )

    results = {}
    for label, (p, c, hs, out) in (("cityscapes", (4, 19, 90, 713)),
                                   ("ade20k", (4, 150, 60, 473)),
                                   ("psanet-cityscapes", (4, 19, 89, 705))):
        g = torch.Generator(device=dev).manual_seed(0)
        lp = (torch.randn(p, 2, c, hs, hs, generator=g, device=dev) * 3).to(torch.bfloat16)
        got = upsample_softmax_flip(lp, (out, out))
        torch.cuda.synchronize()
        want = upsample_softmax_flip_reference(lp, (out, out))
        err = (got.float() - want.float()).abs().max().item()
        rows = (got.float().sum(1) - 1).abs().max().item()
        if not (err <= TOL and rows <= TOL):
            raise AssertionError(f"{label}: kernel vs plain {err}, row sums off by {rows}")
        ms = cuda_ms(lambda: upsample_softmax_flip(lp, (out, out)))
        plain_ms = cuda_ms(lambda: upsample_softmax_flip_reference(lp, (out, out)))
        out_gb = p * c * out * out * 2 / 1e9
        log(f"[3 stitch kernel] {label} [{p},2,{c},{hs},{hs}]->{out}^2 bf16: "
            f"max_abs_err {err:.3e}, row_sum_err {rows:.3e}, kernel {ms:.4f} ms "
            f"({out_gb / ms * 1e3:.1f} GB/s written), plain {plain_ms:.4f} ms")
        results[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del lp, got, want
    return results


def phase_psa_kernels(dev, extents=PSA_EXTENTS, tag="4 psa kernels"):
    """The PSA forward entry points against the plain version at the recipe
    extents (phase 4; phase 24 at a TP rank's channels); both run the tensor-core forward of the dtype. f32
    operands (3xTF32): within ``PSA_REL`` and element by element within the
    JAX package's f32 bar (rtol = atol = 1e-5) against the product in
    float64 (``elementwise_f64``; against the f32 plain version it is
    printed). bf16 operands: within ``fwd_bars``, element by element, and
    within the JAX package's bf16 license (rtol = atol = 1e-2). ``m`` exact
    and ``l`` within 1e-5 relative; two resident calls bit-identical, and
    the flash entry point's ``out``, ``m`` and ``l`` bit for bit the
    resident's (one kernel serves both)."""
    from semseg_torch.ops import psa

    results = {}
    for label, n, c, hw in extents:
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn(n, c, hw, generator=g, device=dev).to(dt)
            a = (torch.randn(n, hw, hw, generator=g, device=dev) * 3).to(dt)
            bf16 = dt == torch.bfloat16
            with torch.inference_mode():
                want = psa.psa_softmax_bmm_reference(x, a)
                m_ref, l_ref = psa.psa_softmax_stats(a)
                res, rm, rl = psa.psa_softmax_bmm(x, a, return_stats=True)
                fl, m, l = psa.psa_softmax_bmm_flash(x, a, return_stats=True)
                torch.cuda.synchronize()
                bar = PSA_REL * want.abs().max().item() + 1e-5
                err_r = (res - want).abs().max().item()
                err_f = (fl - want).abs().max().item()
                stats_ok = torch.equal(rm, m_ref) and ((rl - l_ref).abs() / l_ref).max().item() <= 1e-5
                l_rel = ((rl - l_ref).abs() / l_ref).max().item()
                lic = 1e-2 if bf16 else 1e-5  # JAX's element-wise rtol = atol
                elem32 = elem = ((res - want).abs() / (lic + lic * want.abs())).max().item()
                if not bf16:
                    elem = elementwise_f64(res, x, torch.softmax(a.double(), dim=1))
                ratio = ((res - want).abs() / fwd_bars(x, a)).max().item() if bf16 else err_r / bar
                same = torch.equal(res, psa.psa_softmax_bmm(x, a))
                flash_same = torch.equal(fl, res) and torch.equal(m, rm) and torch.equal(l, rl)
                if not (ratio <= 1.0 and elem <= 1.0 and same and flash_same and stats_ok):
                    raise AssertionError(
                        f"psa {label} {dt}: resident err {err_r} (of its bar {ratio}, of JAX's "
                        f"element-wise {elem}, bit-identical {same}), flash err {err_f} "
                        f"(bit for bit the resident's {flash_same}), stats ok {stats_ok}")
                ms_r = cuda_ms(lambda: psa.psa_softmax_bmm(x, a))
                ms_f = cuda_ms(lambda: psa.psa_softmax_bmm_flash(x, a))
                plain_ms = cuda_ms(lambda: psa.psa_softmax_bmm_reference(x, a))
            gflop = 2 * n * c * hw * hw / 1e9
            bound_ms, bound_by = psa_fwd_bound(n, c, hw, dt)
            dname = "bf16" if bf16 else "f32"
            kind = "tensor-core" if bf16 else "3xTF32"
            log(f"[{tag}] {label} (N,C,hw)=({n},{c},{hw}) {dname}: resident ({kind}) "
                f"err {err_r:.3e} ({ratio:.3f} of its bar, {elem:.3f} of JAX's {lic:g} "
                f"element-wise" + ("" if bf16 else f" against f64, {elem32:.3f} against the f32 "
                                   "plain") + f") {ms_r:.4f} ms "
                f"({gflop / ms_r:.1f} TFLOP/s; bound {bound_ms:.4f} ms by {bound_by})"
                f"; flash route ({kind}, out, m and l bit for bit the resident's) {ms_f:.4f} ms "
                f"({gflop / ms_f:.1f} TFLOP/s), m exact, l rel {l_rel:.2e}; plain "
                f"{plain_ms:.4f} ms")
            results[(label, dname)] = dict(err_r=err_r, err_f=err_f, ratio=ratio, elem=elem,
                                           ms_r=ms_r, ms_f=ms_f, plain_ms=plain_ms,
                                           bound=(bound_ms, bound_by))
            del x, a, want, res, rm, rl, fl, m, l, m_ref, l_ref
            torch.cuda.empty_cache()
    return results


def pspnet_cfg():
    return SimpleNamespace(
        arch="psp", layers=50, classes=19, zoom_factor=8,
        train_h=713, train_w=713, test_h=713, test_w=713,
        base_size=2048, scales=[1.0], model_path="",
        allow_random_weights=True, window_batch=8, eval_pipeline="device",
    )


def psanet_cfg(**kw):
    """``config/cityscapes/cityscapes_psanet50.yaml``'s model and TEST keys."""
    return SimpleNamespace(**{
        **vars(pspnet_cfg()), "arch": "psa", "train_h": 705, "train_w": 705,
        "test_h": 705, "test_w": 705, "psa_type": 2, "compact": 0,
        "shrink_factor": 2, "mask_h": None, "mask_w": None,
        "normalization_factor": 1.0, "psa_softmax": 1, **kw})


def phase_slice(tag, label, cfg, dev, images, per_image, prepare=None):
    """``build_evaluator`` (bf16, seed 0), ``prepare(model)`` if given, 2
    warm-up requests, then ``images`` timed, each launching ``per_image``."""
    from semseg_torch.serve import build_evaluator
    from semseg_torch.utils.misc import get_logger

    ev = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=dev, seed=0)
    if not ev.fused_stitch:
        raise AssertionError("the bf16 CUDA evaluator did not pick the fused kernel")
    if prepare is not None:
        prepare(ev.model)
    for img in images[:2]:  # warm-up (cuDNN heuristics, allocator)
        ev.predict(img)
    torch.cuda.synchronize()

    image_hw = images[0].shape[:2]
    reset_counts()
    t0 = time.perf_counter()
    preds = [ev.predict(img) for img in images]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()

    for pred in preds:
        if pred.shape != image_hw or pred.dtype != np.uint8:
            raise AssertionError(f"bad class map {pred.shape} {pred.dtype}")
        if pred.max() >= cfg.classes:
            raise AssertionError(f"class id {pred.max()} out of range")
    check_counts(label, counts, {k: v * len(images) for k, v in per_image.items()})
    hist = np.bincount(np.concatenate([p.ravel() for p in preds]), minlength=cfg.classes)
    rate = len(images) / seconds
    log(f"[{tag} slice] {label} bf16 1024x2048, 8 windows x flip, window_batch 8: "
        f"{len(images)} requests in {seconds:.3f} s = {rate:.3f} images/s; "
        f"launches {counts}; classes used {int((hist > 0).sum())}")
    return ev, counts, rate


def agreement(tag, label, pf, pp):
    """The fused-vs-plain bars on two probability maps; prints the share
    of near-tied pixels beside them."""
    if not (np.isfinite(pf).all() and np.isfinite(pp).all()):
        raise AssertionError(f"{label}: non-finite probabilities")
    sums = np.abs(pf.sum(-1) - 1).max()
    err = np.abs(pf - pp).max()
    agree = (pf.argmax(-1) == pp.argmax(-1)).mean()
    if not (err <= TOL and agree >= 0.995 and sums <= TOL):
        raise AssertionError(f"{label}: max abs {err}, agreement {agree}, "
                             f"row sums off by {sums}")
    top2 = np.partition(pp, -2, axis=-1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) < 2 * TOL).mean()
    log(f"[{tag} {label}] max abs diff {err:.3e}, argmax agreement {agree:.6f}, "
        f"row sums within {sums:.3e}; pixels with a top-2 margin under {2 * TOL} "
        f"(where a flip is allowed): {near_tie:.4f}")


def phase_stitch_vs_plain(dev, ev, image, cfg=None, tag=6, label="PSPNet"):
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    cfg = cfg or pspnet_cfg()
    plain = SlidingWindowEvaluator(
        ev.model, classes=cfg.classes, crop_h=cfg.test_h, crop_w=cfg.test_w,
        mean=IMAGENET_MEAN, std=IMAGENET_STD, base_size=cfg.base_size,
        scales=cfg.scales, window_batch=cfg.window_batch, fused_stitch=False,
        device=dev)
    pf = ev.predict_probs(image)
    pp = plain.predict_probs(image)
    if (ev.predict(image) != pf.argmax(-1)).any():
        raise AssertionError("predict and predict_probs disagree")
    agreement(tag, f"{label} fused vs plain stitch", pf, pp)


def phase_psa_vs_plain(ev, image, tag=9, label="PSANet"):
    """The same weights and the fused stitch on both sides; only the
    attention differs (kernel vs plain softmax + bmm)."""
    pf = ev.predict_probs(image)
    ev.model.psa.fused_attention = False
    try:
        reset_counts()
        pp = ev.predict_probs(image)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        ev.model.psa.fused_attention = None
    check_counts("plain attention", counts, launches(upsample_softmax_flip=2))
    agreement(tag, f"{label} kernel vs plain attention", pf, pp)


def normalized_window(image, crop, dev):
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    win = torch.from_numpy(image[:crop, :crop].copy()).permute(2, 0, 1)[None].float()
    win = (win - torch.tensor(IMAGENET_MEAN).view(3, 1, 1)) / torch.tensor(
        IMAGENET_STD).view(3, 1, 1)
    return win.to(dev)


def phase_f32(tag, label, cfg, dev, ev, image, per_window):
    """One window's float32 logits on the card and on the CPU."""
    from semseg_torch.models.build import build_model

    model = build_model(cfg, dtype=torch.float32, device=dev)
    model.load_state_dict(ev.model.state_dict(), strict=True)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for a float32 model")
    win = normalized_window(image, cfg.test_h, dev)
    with torch.inference_mode():
        reset_counts()
        gpu = model(win).cpu()
        check_counts(label, read_counts(), per_window)
        model_cpu = model.to("cpu")
        t0 = time.perf_counter()
        cpu = model_cpu(win.cpu())
        cpu_s = time.perf_counter() - t0
    rel = ((gpu - cpu).abs().max() / cpu.abs().max()).item()
    if not rel <= 1e-3:
        raise AssertionError(f"{label}: f32 GPU vs CPU max relative error {rel}")
    log(f"[{tag} f32] {label} {cfg.test_h}x{cfg.test_w} window logits GPU vs CPU: "
        f"max|diff|/max|cpu| = {rel:.3e} (CPU forward {cpu_s:.1f} s)")


def phase_shrink1(dev, image):
    """PSANet50 f32 at shrink 1 (mask 177x177, hw 7921): one window and its
    flip through the flash forward's route (the 3xTF32 forward), against
    the plain attention."""
    from semseg_torch.models.build import build_model

    model = build_model(psanet_cfg(shrink_factor=1), dtype=torch.float32,
                        device=dev, seed=0)
    if (model.psa.mask_h, model.psa.mask_w) != (177, 177):
        raise AssertionError(f"shrink-1 mask {model.psa.mask_h}x{model.psa.mask_w}")
    win = normalized_window(image, 705, dev)
    batch = torch.cat([win, win.flip(-1)])
    with torch.inference_mode():
        reset_counts()
        t0 = time.perf_counter()
        got = model(batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        check_counts("shrink-1 window", counts,
                     launches(psa_softmax_bmm_flash=2, psa_softmax_bmm_tf32x3=2))
        model.psa.fused_attention = False
        want = model(batch)
    if not torch.isfinite(got).all() or tuple(got.shape) != (2, 19, 705, 705):
        raise AssertionError(f"shrink-1 logits {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not rel <= 1e-3:
        raise AssertionError(f"shrink-1 flash vs plain attention: relative error {rel}")
    log(f"[10 shrink-1] PSANet50 f32 mask 177x177 hw 7921, window + flip: "
        f"launches {counts}; logits vs plain attention max|diff|/max = {rel:.3e}; "
        f"forward {seconds:.3f} s (first call)")
    return counts


def phase_psa_backward(dev, extents=PSA_EXTENTS, tag="12 psa backward"):
    """The backward kernels against the plain backward at the recipe
    extents, from the kernels' own forward statistics (phase 12; phase 24
    at a TP rank's channels). The
    flash backward's route (``psa_softmax_bmm_flash_bwd``: the tensor-core
    dx and da of the dtype, from the flash forward's m, l and output) is
    held to the bars of those kernels against the plain backward from the
    same statistics. f32: da and dx (3xTF32) and the route within
    ``PSA_REL``; the 3xTF32 dx element by element within the JAX
    package's f32 VJP bar (rtol 1e-4, atol 1e-5) against float64
    (``elementwise_f64``), the 3xTF32 da within that bar plus f32's
    cancellation term (``da_f32_ratios``; its ratio to JAX's bar alone, and
    the f32 plain da's to both, printed beside), two calls bit-identical.
    bf16: da and dx on the tensor cores, and the route, within ``da_bars``
    and ``dx_bars`` against the f32 plain da and dx, element by element, and
    two calls of each bit-identical. Printed beside, not a gate: the
    largest |err| / (1e-2 + 1e-2 |plain|) of the bf16 dx kernel and of the
    TPU kernel's own rounding on the same inputs
    (``psa_softmax_bmm_bwd_dx_bf16_reference``: p and g rounded to bf16, f32
    sums, a bf16 result), the JAX package's bf16 license
    (``tests/test_psa_pallas.py``), which its tests apply at A = randn and
    small hw; here A = randn * 3 makes |dx| larger, and the TPU's own
    roundings exceed the license at this scale too
    (``chip_probes/bf16_dx_license.py``)."""
    from semseg_torch.ops import psa

    results = {}
    for label, n, c, hw in extents:
        for dt in (torch.bfloat16, torch.float32):
            bf16 = dt == torch.bfloat16
            g0 = torch.Generator(device=dev).manual_seed(1)
            x = torch.randn(n, c, hw, generator=g0, device=dev).to(dt)
            a = (torch.randn(n, hw, hw, generator=g0, device=dev) * 3).to(dt)
            g = torch.randn(n, c, hw, generator=g0, device=dev)
            with torch.no_grad():
                out, m, l = psa.psa_softmax_bmm(x, a, return_stats=True)
                fout, fm, fl = psa.psa_softmax_bmm_flash(x, a, return_stats=True)
                da = psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out)
                dx = psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l)
                fdx, fda = psa.psa_softmax_bmm_flash_bwd(x, a, g, fm, fl, fout)
                torch.cuda.synchronize()
                dx32, da32 = psa.psa_softmax_bmm_bwd_reference(x.float(), a.float(), g, m, l, out)
                fdx32, fda32 = psa.psa_softmax_bmm_bwd_reference(x.float(), a.float(), g, fm, fl,
                                                                 fout)
                if not bf16:
                    bar_dx = PSA_REL * dx32.abs().max().item() + 1e-5
                    bar_da = PSA_REL * da32.abs().max().item() + 1e-5
                    dx_ratio = (dx - dx32).abs().max().item() / bar_dx
                    da_ratio = (da - da32).abs().max().item() / bar_da
                    route_ratio = max((fdx - fdx32).abs().max().item() / bar_dx,
                                      (fda - fda32).abs().max().item() / bar_da)
                    dx_elem32 = ((dx - dx32).abs() / (1e-5 + 1e-4 * dx32.abs())).max().item()
                    da_elem32 = ((da - da32).abs() / (1e-5 + 1e-4 * da32.abs())).max().item()
                    p64 = torch.exp(a.double() - m.double()[:, None]) / l.double()[:, None]
                    dx_elem = elementwise_f64(dx, g, p64.transpose(1, 2), rtol=1e-4)
                    del p64
                    da_elem, da_derived = da_f32_ratios(da, x, a, g, m, l, out)
                    plain_elem, plain_derived = da_f32_ratios(da32, x, a, g, m, l, out)
                    if not (dx_elem <= 1.0 and da_derived <= 1.0 and
                            torch.equal(dx, psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l)) and
                            torch.equal(da, psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out))):
                        raise AssertionError(f"3xTF32 {label}: dx {dx_elem} of JAX's element-wise "
                                             f"bar, da {da_derived} of its derived bar, or two "
                                             "calls differ")
                else:
                    dx_ratio = ((dx.float() - dx32).abs() / dx_bars(a, g, m, l, dx32)).max().item()
                    da_ratio = ((da.float() - da32).abs()
                                / da_bars(x, a, g, m, l, da32)).max().item()
                    route_ratio = max(
                        ((fdx.float() - fdx32).abs() / dx_bars(a, g, fm, fl, fdx32)).max().item(),
                        ((fda.float() - fda32).abs() / da_bars(x, a, g, fm, fl, fda32)).max().item())
                    if not (dx_ratio <= 1.0 and da_ratio <= 1.0):
                        raise AssertionError(f"tensor-core {label}: dx at {dx_ratio}, da at "
                                             f"{da_ratio} of their bars")
                    tpu = psa.psa_softmax_bmm_bwd_dx_bf16_reference(x, a, g, m, l)
                    lic = {k: ((v.float() - dx32).abs() / (1e-2 + 1e-2 * dx32.abs())).max().item()
                           for k, v in (("tensor-core", dx), ("TPU model", tpu))}
                    del tpu
                    if not (torch.equal(dx, psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l)) and
                            torch.equal(da, psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out))):
                        raise AssertionError(f"tensor-core {label}: two calls differ")
                errs = {"da": (da.float() - da32).abs().max().item(),
                        "dx": (dx.float() - dx32).abs().max().item(),
                        "route_da": (fda.float() - fda32).abs().max().item(),
                        "route_dx": (fdx.float() - fdx32).abs().max().item()}
                del dx32, da32, fdx32, fda32
                if max(dx_ratio, da_ratio, route_ratio) > 1.0:
                    raise AssertionError(f"psa backward {label} {dt}: errors {errs}, da at "
                                         f"{da_ratio}, dx at {dx_ratio}, route at {route_ratio} "
                                         "of their bars")
                if not all(t.dtype == dt for t in (da, dx, fda, fdx)):
                    raise AssertionError("backward kernels did not return the primal dtypes")
                ms_da = cuda_ms(lambda: psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out))
                ms_dx = cuda_ms(lambda: psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l))
                ms_f = cuda_ms(lambda: psa.psa_softmax_bmm_flash_bwd(x, a, g, fm, fl, fout))
                plain_da = cuda_ms(lambda: psa.psa_softmax_bmm_bwd_da_reference(x, a, g, m, l, out))
                plain_dx = cuda_ms(lambda: psa.psa_softmax_bmm_bwd_dx_reference(x, a, g, m, l))
                del da, dx, fda, fdx
            xr, ar = x.detach().requires_grad_(), a.detach().requires_grad_()
            o = psa.psa_softmax_bmm_reference(xr, ar)
            autograd_ms = cuda_ms(lambda: torch.autograd.grad(o, (xr, ar), g, retain_graph=True))
            del o, xr, ar
            gflop = 2 * n * c * hw * hw / 1e9
            dname = "bf16" if bf16 else "f32"
            kind = "tensor-core" if bf16 else "3xTF32"
            dx_bound, dx_by = psa_dx_bound(n, c, hw, dt)
            da_bound, da_by = psa_da_bound(n, c, hw, dt)
            log(f"[{tag}] {label} (N,C,hw)=({n},{c},{hw}) {dname}: errors "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (da at {da_ratio:.3f}, dx at {dx_ratio:.3f}, the flash route at "
                f"{route_ratio:.3f} of their bars"
                + (f"; 1e-2 license ratio tensor-core dx {lic['tensor-core']:.3f}, the TPU "
                   f"kernel's rounding {lic['TPU model']:.3f}" if bf16
                   else f"; 3xTF32 dx at {dx_elem:.3f} and da at {da_elem:.3f} of JAX's 1e-4/1e-5 "
                   f"element-wise against f64, {dx_elem32:.3f} and {da_elem32:.3f} against the "
                   f"f32 plain; da at {da_derived:.3f} of its derived bar (gated), the f32 plain "
                   f"da at {plain_elem:.3f} of JAX's and {plain_derived:.3f} of the derived") + "); "
                f"da ({kind}) {ms_da:.4f} ms "
                f"({gflop / ms_da:.1f} TFLOP/s; bound {da_bound:.4f} by {da_by})"
                + f", dx ({kind}) {ms_dx:.4f} ms "
                f"({gflop / ms_dx:.1f}; bound {dx_bound:.4f} by {dx_by})"
                + f", flash bwd route ({kind} dx + da) {ms_f:.4f} ms ({2 * gflop / ms_f:.1f}); "
                f"plain da "
                f"{plain_da:.4f}, dx {plain_dx:.4f}, da+dx {plain_da + plain_dx:.4f} ms; autograd "
                f"of the plain forward {autograd_ms:.4f} ms")
            results[(label, dname)] = dict(errs=errs, ms_da=ms_da, ms_dx=ms_dx,
                                           da_ratio=da_ratio, ms_f=ms_f, plain_da=plain_da, plain_dx=plain_dx,
                                           autograd_ms=autograd_ms, dx_bound=(dx_bound, dx_by),
                                           da_bound=(da_bound, da_by))
            del x, a, g, out, m, l, fout, fm, fl
            torch.cuda.empty_cache()
    return results


def write_dataset(root, n=48):
    """``n`` seeded street samples as PNGs plus a train list file."""
    import cv2

    root = Path(root)
    (root / "img").mkdir(parents=True, exist_ok=True)

    def write(k):
        img, label = street_sample(100 + k)
        cv2.imwrite(str(root / "img" / f"{k}.png"), img[:, :, ::-1],
                    [cv2.IMWRITE_PNG_COMPRESSION, 1])
        cv2.imwrite(str(root / "img" / f"{k}_label.png"), label,
                    [cv2.IMWRITE_PNG_COMPRESSION, 1])
        return f"img/{k}.png img/{k}_label.png"

    with ThreadPoolExecutor(8) as pool:
        lines = list(pool.map(write, range(n)))
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return root


def train_cfg(root, batch_size):
    """``config/cityscapes/cityscapes_psanet50.yaml`` through the training
    entry point's own parser, on the synthetic dataset, one GPU,
    ``compute_dtype bfloat16``, ``epochs 1``."""
    from semseg_torch.train import parse_args

    root = Path(root)
    return parse_args([
        "--config", "config/cityscapes/cityscapes_psanet50.yaml",
        "data_root", str(root), "train_list", str(root / "train.txt"),
        "save_path", str(root / "exp"), "train_gpu", "[0]", "batch_size", str(batch_size),
        "epochs", "1", "print_freq", "1", "compute_dtype", "bfloat16"])


# Per train step, two directions: bf16 runs the tensor-core forward, da and
# dx, f32 the 3xTF32 forward, da and dx; f32 at shrink 1 the flash forward's
# and the flash backward's routes, which launch the 3xTF32 forward, and the
# 3xTF32 dx and da.
TRAIN_STEP = dict(psa_softmax_bmm_wgmma=2, psa_softmax_bmm_bwd_da_wgmma=2,
                  psa_softmax_bmm_bwd_dx_wgmma=2)
F32_TRAIN_STEP = dict(psa_softmax_bmm_tf32x3=2, psa_softmax_bmm_bwd_da_tf32x3=2,
                      psa_softmax_bmm_bwd_dx_tf32x3=2)
SHRINK1_TRAIN_STEP = dict(psa_softmax_bmm_flash=2, psa_softmax_bmm_tf32x3=2,
                          psa_softmax_bmm_flash_bwd=2, psa_softmax_bmm_bwd_da_tf32x3=2,
                          psa_softmax_bmm_bwd_dx_tf32x3=2)


def phase_train_slice(dev):
    """PSANet50 training through ``semseg_torch.train.run`` (phase 13)."""
    from semseg_torch.train import run
    from semseg_torch.utils.misc import get_logger

    t0 = time.perf_counter()
    root = write_dataset(Path("build") / "chip_smoke_data")
    log(f"[13 train slice] wrote 48 street-like 1024x2048 images + labels in "
        f"{time.perf_counter() - t0:.1f} s")
    per_step = []
    by_path = launches()

    def hook(it, metrics):
        counts = read_counts()
        check_counts(f"train step {it}", counts, launches(**TRAIN_STEP))
        for k, v in counts.items():
            by_path[k] += v
        loss = metrics["loss"].item()
        if not np.isfinite(loss):
            raise AssertionError(f"train step {it}: loss {loss}")
        per_step.append((it, loss, metrics["main_loss"].item(), metrics["aux_loss"].item(),
                         metrics["lr"]))
        reset_counts()

    notes = []
    for batch in (16, 12, 8):
        cfg = train_cfg(root, batch)
        per_step.clear()
        by_path.update(launches())
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            t0 = time.perf_counter()
            res = run(cfg, dev, logger=get_logger(), step_hook=hook)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            break
        except torch.cuda.OutOfMemoryError as exc:
            notes.append(f"batch {batch} did not fit: {str(exc).splitlines()[0]}")
            log(f"[13 train slice] {notes[-1]}")
            res = None
            torch.cuda.empty_cache()
    if res is None:
        raise AssertionError("PSANet50 training fit at none of batch 16, 12, 8")
    steps = len(per_step)
    if steps != 48 // batch or not res["checkpoints"]:
        raise AssertionError(f"{steps} steps, checkpoints {res['checkpoints']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[13 train slice] PSANet50 bf16 {cfg.train_h}x{cfg.train_w} batch {batch}: {steps} steps through "
        f"run() in {seconds:.2f} s (first step included), peak {peak:.2f} GiB; per step "
        f"(iter, loss, main, aux, lr) {per_step}; launches over the run {by_path}")
    return cfg, res, by_path, batch, notes


def device_profile(fn, path):
    """``torch.profiler`` over ``fn()``: device busy ms (union of kernel
    intervals), span ms, idle share; the table of kernels by device time
    goes to ``path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    try:
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    except (AttributeError, KeyError, ValueError):
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(table)
    psa_rows = {}
    for ev in prof.key_averages():
        if "psa_" in ev.key:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            name = re.search(r"psa_[a-z0-9_]+", ev.key).group(0)
            ms, count = psa_rows.get(name, (0.0, 0))
            psa_rows[name] = (ms + dev_us / 1e3, count + ev.count)
    return busy / 1e3, span / 1e3, 1.0 - busy / span, table, psa_rows


def phase_train_timing(cfg, res, dev, batch):
    """The train step alone on a device-resident batch, the loader alone,
    and a profiler window (phase 14)."""
    from semseg_torch.train import build_train_loader

    loader, _ = build_train_loader(cfg)
    loader.set_epoch(0)
    t0 = time.perf_counter()
    batches = [b for b in loader]
    loader_s = time.perf_counter() - t0
    loader_rate = len(batches) * batch / loader_s
    images = torch.from_numpy(batches[0][0]).to(dev)
    labels = torch.from_numpy(batches[0][1].astype(np.uint8)).to(dev)
    del batches

    tr = res["trainer"]
    tr.max_iter = tr.step_count + 100  # a longer run's schedule: lr > 0
    for _ in range(2):
        tr.step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for i in range(5):
        reset_counts()
        m = tr.step(images, labels)
        check_counts(f"timed step {i}", read_counts(), launches(**TRAIN_STEP))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [v.item() for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"timed steps: losses {losses}")

    def two_steps():
        for _ in range(2):
            tr.step(images, labels)

    busy, span, idle, table, psa_rows = device_profile(two_steps, OUT_DIR / "train_profile.txt")
    top = [ln for ln in table.splitlines()[3:11]]
    log(f"[14 train step] PSANet50 bf16 batch {batch} on a device-resident batch: "
        f"{step_s:.4f} s/step = {batch / step_s:.3f} images/s, peak {peak:.2f} GiB, "
        f"losses {[round(v, 4) for v in losses]}; loader alone {loader_rate:.3f} images/s "
        f"({loader_s:.2f} s for {len(loader) * batch} images, {cfg.workers} threads); "
        f"profile of 2 steps: device busy {busy:.2f} ms of {span:.2f} ms, idle share "
        f"{idle:.4f} (table in {OUT_DIR / 'train_profile.txt'})")
    for ln in top:
        log(f"[14 train step]   {ln.strip()[:150]}")
    psa_ms = sum(ms for ms, _ in psa_rows.values())
    log(f"[14 train step] PSA kernels over the 2 profiled steps: {psa_ms:.3f} ms of {busy:.2f} "
        f"ms device time ({psa_ms / busy:.4f}): " + ", ".join(
            f"{k} {ms:.3f} ms / {cnt} launches = {ms / max(cnt, 1):.4f} ms each"
            for k, (ms, cnt) in sorted(psa_rows.items())))
    return dict(step_s=step_s, images_per_s=batch / step_s, peak_gib=peak,
                loader_images_per_s=loader_rate, idle=idle)


def phase_pspnet_train(dev):
    """PSPNet50 bf16, 3 steps through the same Trainer: no PSA kernel
    (phase 15)."""
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    cfg = pspnet_cfg()
    model = build_model(cfg, dtype=torch.bfloat16, device=dev, seed=0, train=True)
    tr = Trainer(model, make_sgd(model, 0.01), classes=19, ignore_label=255, aux_weight=0.4,
                 base_lr=0.01, max_iter=3, power=0.9, zoom_factor=8,
                 normalize=(IMAGENET_MEAN, IMAGENET_STD))
    images, labels = street_batch(dev, 8, 713, 0)
    reset_counts()
    t0 = time.perf_counter()
    losses = [tr.step(images, labels)["loss"] for _ in range(3)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_counts("PSPNet50 train", counts, launches())
    losses = [v.item() for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"PSPNet50 train losses {losses}")
    log(f"[15 pspnet train] PSPNet50 bf16 713x713 batch 8: 3 steps in {seconds:.2f} s "
        f"(first included), losses {[round(v, 4) for v in losses]}, launches {counts}")
    del tr, model
    torch.cuda.empty_cache()
    return counts


def train_grads(model, images, labels, seed=0):
    """Loss and parameter gradients of one f32 train step (no update);
    dropout drawn from a generator seeded the same for every call."""
    from semseg_torch.engine.trainer import replica_mean_ce
    from semseg_torch.models.layers import Dropout2d

    gen = torch.Generator(device=images.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.generator = gen
    model.train()
    model.zero_grad(set_to_none=True)
    logits, aux = model(images)
    loss = (replica_mean_ce(logits, labels, 1, 255)
            + 0.4 * replica_mean_ce(aux, labels, 1, 255))
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def phase_grad_vs_plain(tag, dev, shrink, per_step, timed=0):
    """PSANet50 f32 train step at batch 2: the kernels against plain
    attention, losses and every parameter gradient (phases 16-17); then,
    with ``timed``, the seconds per step (forward and backward, no update;
    host clock, synchronised) over that many more kernel steps, each
    launching ``per_step``."""
    from semseg_torch.models.build import build_model

    cfg = psanet_cfg(shrink_factor=shrink)
    model = build_model(cfg, dtype=torch.float32, device=dev, seed=0, train=True)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for a float32 model")
    pairs = [street_sample(10 + s) for s in range(2)]
    images = torch.stack([normalized_window(p[0], 705, dev)[0] for p in pairs])
    labels = torch.from_numpy(np.stack([p[1][:705, :705] for p in pairs])).long().to(dev)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    reset_counts()
    t0 = time.perf_counter()
    loss_k, grads_k = train_grads(model, images, labels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    check_counts(f"f32 train step shrink {shrink}", counts, launches(**per_step))
    step_s = None
    if timed:
        t0 = time.perf_counter()
        for i in range(timed):
            reset_counts()
            train_grads(model, images, labels)
            check_counts(f"f32 timed step {i} shrink {shrink}", read_counts(), launches(**per_step))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / timed
    model.load_state_dict(state)
    model.psa.fused_attention = False
    reset_counts()
    loss_p, grads_p = train_grads(model, images, labels)
    check_counts("plain attention train step", read_counts(), launches())
    rel = {k: ((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm().clamp_min(1e-30)).item()
           for k in grads_p}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if not (np.isfinite(loss_k) and loss_rel <= 1e-5 and rel[worst] <= GRAD_REL):
        raise AssertionError(f"shrink {shrink}: loss {loss_k} vs {loss_p}, worst gradient "
                             f"{worst} relative {rel[worst]} (bar {GRAD_REL})")
    log(f"[{tag} f32 train step] PSANet50 shrink {shrink} (hw {model.psa.mask_h // 2 + 1}^2) "
        f"batch 2 705x705: kernels vs plain attention loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {loss_rel:.2e}); gradient relative L2 median {np.median(list(rel.values())):.2e}, "
        f"max {rel[worst]:.2e} ({worst}) over {len(rel)} tensors (bar {GRAD_REL}); launches "
        f"{counts}; kernel step {seconds:.2f} s (first call)"
        + (f", {step_s:.4f} s per step over {timed} more" if timed else ""))
    del model, grads_k, grads_p, state
    torch.cuda.empty_cache()
    return counts


def phase_f32_train_timing(dev, batch=8, per_step=F32_TRAIN_STEP,
                           profile_path=OUT_DIR / "f32_train_profile.txt"):
    """PSANet50 f32 (the recipe's default ``compute_dtype``) train step at
    ``batch``, 705x705 crops, on a device-resident batch (phase 16): 2
    warm-up and 5 timed steps (host clock, synchronised), each launching
    ``per_step`` (not counted when None, for a tree whose kernels have other
    names); images/s, peak memory; a profiler window of 2 steps with the PSA
    kernels' share of the device time."""
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    model = build_model(psanet_cfg(), dtype=torch.float32, device=dev, seed=0, train=True)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for a float32 model")
    tr = Trainer(model, make_sgd(model, 0.01), classes=19, ignore_label=255, aux_weight=0.4,
                 base_lr=0.01, max_iter=100, power=0.9, zoom_factor=8,
                 normalize=(IMAGENET_MEAN, IMAGENET_STD))
    images, labels = street_batch(dev, batch, 705, 20)
    for _ in range(2):
        tr.step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for i in range(5):
        if per_step is not None:
            reset_counts()
        losses.append(tr.step(images, labels)["loss"])
        if per_step is not None:
            check_counts(f"f32 timed step {i}", read_counts(), launches(**per_step))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [v.item() for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"f32 timed steps: losses {losses}")

    def two_steps():
        for _ in range(2):
            tr.step(images, labels)

    busy, span, idle, _, psa_rows = device_profile(two_steps, profile_path)
    psa_ms = sum(ms for ms, _ in psa_rows.values())
    log(f"[16 f32 train step] PSANet50 f32 batch {batch} 705x705 on a device-resident batch: "
        f"{step_s:.4f} s/step = {batch / step_s:.3f} images/s, peak {peak:.2f} GiB, losses "
        f"{[round(v, 4) for v in losses]}; profile of 2 steps: device busy {busy:.2f} ms of "
        f"{span:.2f} ms, idle share {idle:.4f}; PSA kernels {psa_ms:.3f} ms "
        f"({psa_ms / busy:.4f} of device time): " + ", ".join(
            f"{k} {ms:.3f} ms / {cnt} launches = {ms / max(cnt, 1):.4f} ms each"
            for k, (ms, cnt) in sorted(psa_rows.items())))
    del tr, model, images, labels
    torch.cuda.empty_cache()
    return dict(step_s=step_s, images_per_s=batch / step_s, peak_gib=peak, idle=idle,
                psa_share=psa_ms / busy)


def phase_psa_module_f32(dev):
    """The PSA module at full width, f32, on the card against the CPU
    (phase 18): output and input gradient within 1e-3 relative, each
    parameter gradient within ``PARAM_REL``; then once more on the card
    with TF32 on, which must fail those bars.

    BN runs in eval mode: at a random init the attention is near uniform,
    so each aggregation is nearly constant over positions, and train-mode
    BN divides by that tiny spread. There, perturbing the input by 1e-6
    moves the f32 gradients by 2-5 % on one device (measured on the CPU at
    49x49), far above any TF32 effect. In eval mode the same perturbation
    moves the output by 3e-6, the input gradient by 2e-5 and the parameter
    gradients behind the softmax VJP by up to 3.3e-3."""
    import copy

    from semseg_torch.models.psanet import PSA

    torch.manual_seed(0)
    mod = PSA(2048, 512, 2, False, 2, 89, 89, 1.0, True, None).eval()
    g0 = torch.Generator().manual_seed(1)
    x = torch.randn(2, 2048, 89, 89, generator=g0)
    gout = torch.randn(2, 4096, 89, 89, generator=g0)

    def grads(device):
        m = copy.deepcopy(mod).to(device)
        xd = x.detach().to(device).requires_grad_()  # a leaf on every device
        reset_counts()
        out = m(xd)
        (out * gout.to(device)).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            check_counts("PSA module", read_counts(), launches(**F32_TRAIN_STEP))
        return {"out": out.detach().cpu(), "dx": xd.grad.cpu(),
                **{k: p.grad.cpu() for k, p in m.named_parameters()}}

    def rel_errors(got, want):
        return {k: ((got[k] - want[k]).abs().max() / want[k].abs().max()).item() for k in want}

    def within_bars(rel):
        worst = max((k for k in rel if k not in ("out", "dx")), key=rel.get)
        return rel["out"] <= 1e-3 and rel["dx"] <= 1e-3 and rel[worst] <= PARAM_REL, worst

    cpu = grads(torch.device("cpu"))
    rel = rel_errors(grads(dev), cpu)
    ok, worst = within_bars(rel)
    if not ok:
        raise AssertionError(f"PSA module f32 GPU vs CPU: out {rel['out']}, dx {rel['dx']}, "
                             f"{worst} {rel[worst]} (bar {PARAM_REL})")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = rel_errors(grads(dev), cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    tf32_ok, tf32_worst = within_bars(tf32)
    if tf32_ok:  # the bars no longer tell TF32 from f32: the check is blind
        raise AssertionError(f"PSA module with TF32 on passes the f32 bars: out {tf32['out']}, "
                             f"dx {tf32['dx']}, {tf32_worst} {tf32[tf32_worst]}")
    params = [k for k in rel if k not in ("out", "dx")]
    log(f"[18 psa module f32] 2048->512, 89x89, batch 2, eval-mode BN: GPU vs CPU "
        f"max|diff|/max|cpu| out {rel['out']:.2e}, dx {rel['dx']:.2e} (bar 1e-3), "
        f"{len(params)} parameter gradients at most {rel[worst]:.2e} ({worst}; bar "
        f"{PARAM_REL}); with TF32 on, which must fail: out {tf32['out']:.2e}, dx "
        f"{tf32['dx']:.2e}, parameters at most {tf32[tf32_worst]:.2e} ({tf32_worst})")


# The reference's multi-scale protocol (tool/test.py), named in the configs'
# TEST section (``scales: [1.0]  # ... ms as [0.5, ..., 1.75]``).
MS_SCALES = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75]
# Per 1024x2048 image at MS_SCALES, from the evaluator's own _scaled_size
# and _grid_coords: PSPNet50 (713 crops) 2/6/8/15/18/32 windows in
# 1/2/2/4/5/8 chunks of 4 windows and their flips, PSANet50 (705 crops)
# 2/6/8/15/21/32 in 1/2/2/4/6/8: one stitch launch a chunk, two bf16
# tensor-core forwards a PSANet50 chunk (two directions).
MS_CHUNKS = {"PSPNet50": 22, "PSANet50": 23}


def phase_multiscale(dev, images, smi):
    """Multi-scale serving (phase 19): both models, bf16, flip, window
    batch 8, at MS_SCALES; one warm-up and 2 timed requests each."""
    from semseg_torch.serve import build_evaluator
    from semseg_torch.utils.misc import get_logger

    rates, by_model = {}, {}
    for label, cfg in (("PSPNet50", pspnet_cfg()), ("PSANet50", psanet_cfg())):
        cfg.scales = list(MS_SCALES)
        ev = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=dev, seed=0)
        if not ev.fused_stitch:
            raise AssertionError("the bf16 CUDA evaluator did not pick the fused kernel")
        h, w = images[0].shape[:2]
        chunks = sum(len(ev._geometry(h, w, s).chunks) for s in ev.scales)
        windows = sum(sum(ev._geometry(h, w, s).n_real) for s in ev.scales)
        if chunks != MS_CHUNKS[label]:
            raise AssertionError(f"{label}: {chunks} chunks an image, expected {MS_CHUNKS[label]}")
        psa_fwd = 2 * chunks if label == "PSANet50" else 0
        ev.predict(images[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        preds = [ev.predict(img) for img in images[1:3]]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        check_counts(f"{label} multi-scale", counts, {k: v * len(preds) for k, v in launches(
            upsample_softmax_flip=chunks, psa_softmax_bmm_wgmma=psa_fwd).items()})
        for pred in preds:
            if pred.shape != (h, w) or pred.dtype != np.uint8 or pred.max() >= cfg.classes:
                raise AssertionError(f"{label}: bad class map {pred.shape} {pred.dtype}")
        pf = ev.predict_probs(images[1])
        # predict is the argmax of the f32 sum, predict_probs the sum / 6:
        # the division may tie two classes that the sum told apart
        top2 = np.partition(pf, -2, axis=-1)[..., -2:]
        differ = preds[0] != pf.argmax(-1)
        if (differ & (top2[..., 1] != top2[..., 0])).any():
            raise AssertionError(f"{label}: predict and predict_probs disagree off exact ties")
        if label == "PSANet50":
            ev.model.psa.fused_attention = False
            try:
                reset_counts()
                pp = ev.predict_probs(images[1])
                torch.cuda.synchronize()
                check_counts("multi-scale plain attention", read_counts(),
                             launches(upsample_softmax_flip=chunks))
            finally:
                ev.model.psa.fused_attention = None
            agreement(19, "PSANet50 multi-scale kernel vs plain attention", pf, pp)
        rates[label], by_model[label] = len(preds) / seconds, counts
        busy, span, idle, table, psa_rows = device_profile(
            lambda: ev.predict(images[2]), OUT_DIR / f"multiscale_{label}_profile.txt")
        log(f"[19 multi-scale] {label} bf16 {h}x{w}, scales {MS_SCALES}, flip, window_batch "
            f"8: {windows} windows in {chunks} chunks an image; {len(preds)} requests in "
            f"{seconds:.3f} s = {rates[label]:.4f} images/s on {smi}; launches {counts}; "
            f"predict vs argmax of predict_probs: {int(differ.sum())} pixels differ, all on "
            f"exact ties of the mean; profile of one request: device busy {busy:.2f} ms of "
            f"{span:.2f} ms, idle share {idle:.4f}, PSA kernels "
            f"{sum(ms for ms, _ in psa_rows.values()):.3f} ms")
        for ln in table.splitlines()[3:9]:
            log(f"[19 multi-scale]   {ln.strip()[:150]}")
        del ev, pf
        torch.cuda.empty_cache()
    return rates, by_model


# Phase 20: per validation batch of the bf16 driver, one eval forward (two
# directions); per 1024x2048 image of the f32 test driver, two chunks of
# 4 windows and their flips through the 3xTF32 forward (two directions).
DRIVER_VAL_BATCH = dict(psa_softmax_bmm_wgmma=2)
# The bf16 train step's kernels, by the names the device trace gives them.
TRACE_KERNELS = ("psa_wgmma_kernel", "psa_da_wgmma_kernel")
DRIVER_TEST_IMAGE = dict(psa_softmax_bmm_tf32x3=4)


def driver_cfg(root, save, **keys):
    """``config/cityscapes/cityscapes_psanet50.yaml`` through the training
    driver's parser: 16 training images (batch 8, 2 steps an epoch), 2
    epochs, bf16, validation on 4 images, the test keys on the same 4."""
    from semseg_torch.train import parse_args

    root, save = Path(root), Path(save)
    cfg = parse_args([
        "--config", "config/cityscapes/cityscapes_psanet50.yaml",
        "data_root", str(root), "train_list", str(root / "train16.txt"),
        "val_list", str(root / "val4.txt"), "test_list", str(root / "val4.txt"),
        "save_path", str(save), "save_folder", str(save / "result"), "train_gpu", "[0]",
        "batch_size", "8", "epochs", "2", "evaluate", "True", "print_freq", "1",
        "compute_dtype", "bfloat16", "manual_seed", "0"])
    cfg.update(keys)
    return cfg


def host_state(trainer):
    from semseg_torch.engine.checkpoint import host_snapshot

    return host_snapshot(trainer.state_dict())


def state_pairs(a, b):
    """Two host states' tensors side by side: every state_dict entry
    (weights, BN statistics, ``num_batches_tracked``) and every momentum
    buffer."""
    pairs = [(a["state_dict"][k], b["state_dict"][k]) for k in a["state_dict"]]
    return pairs + [(v["momentum_buffer"], b["optimizer"]["state"][k]["momentum_buffer"])
                    for k, v in a["optimizer"]["state"].items()]


def state_spread(a, b):
    """``(equal, worst)``: whether two host states are equal bit for bit
    (weights, BN statistics, momentum, step), and the largest relative L2
    distance of one of their float tensors."""
    pairs = state_pairs(a, b)
    equal = a["step"] == b["step"] and all(torch.equal(x, y) for x, y in pairs)
    worst = max(((x.double() - y.double()).norm() / y.double().norm().clamp_min(1e-30)).item()
                for x, y in pairs if x.is_floating_point())
    return equal, worst


def phase_drivers(dev, root, smi):
    """The user's workflow through the drivers on one GPU (phase 20):
    train PSANet50 with validation (bf16, batch 8, 705 crops, 2 epochs of 2
    steps on 16 street images, validation on 4), uninterrupted; a run
    stopped by the preemption hook after step 3, then ``resume auto``, which
    must end where the uninterrupted run ends: bit for bit, or else within
    twice the spread of a second uninterrupted run (which must differ from
    the first: a nondeterministic step).
    Launches exact per train step and per validation batch; the checkpoint
    files; save, async save and restore seconds. Then the f32 test driver
    over the 4 images with the trained ``.pth`` (PNGs, mIoU, exact launches
    per image, images/s beside ``predict`` alone), the demo on one of them
    (its gray PNG equal to the test driver's), and the host loaders."""
    import cv2

    from semseg_torch import demo
    from semseg_torch import test as ttest
    from semseg_torch.data import native
    from semseg_torch.engine import checkpoint as ckpt
    from semseg_torch.train import build_train_loader, run
    from semseg_torch.utils.misc import get_logger

    root = Path(root)
    lines = (root / "train.txt").read_text().splitlines()
    (root / "train16.txt").write_text("\n".join(lines[:16]) + "\n")
    (root / "val4.txt").write_text("\n".join(lines[16:20]) + "\n")
    out = OUT_DIR / "drivers"
    shutil.rmtree(out, ignore_errors=True)
    logger = get_logger()
    spe, val_batches = 2, 1  # steps an epoch; 4 validation images at batch_size_val 8
    by_path = {"driver_train": launches(), "driver_val": launches()}

    def counted_run(cfg, count):
        """``run`` with every step's launches checked: TRAIN_STEP, plus
        one validation's when an epoch closed since the previous step."""
        prev = {"it": None}

        def hook(it, metrics):
            counts = read_counts()
            val = prev["it"] is not None and prev["it"] % spe == 0
            want = {k: TRAIN_STEP.get(k, 0) + val * val_batches * DRIVER_VAL_BATCH.get(k, 0)
                    for k in counts}
            check_counts(f"driver step {it}", counts, want)
            if count:
                for k in counts:
                    by_path["driver_train"][k] += TRAIN_STEP.get(k, 0)
                    by_path["driver_val"][k] += counts[k] - TRAIN_STEP.get(k, 0)
            if not np.isfinite(metrics["loss"].item()):
                raise AssertionError(f"driver step {it}: loss {metrics['loss'].item()}")
            prev["it"] = it
            reset_counts()

        reset_counts()
        t0 = time.perf_counter()
        res = run(cfg, dev, logger=logger, step_hook=hook)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()  # the last epoch's validation, unless preempted
        tail = launches() if res["preempt"] else launches(**{
            k: val_batches * v for k, v in DRIVER_VAL_BATCH.items()})
        check_counts("driver after the last step", counts, tail)
        if count:
            for k in counts:
                by_path["driver_val"][k] += counts[k]
        return res, seconds

    full, full_s = counted_run(driver_cfg(root, out / "full", profile_dir=str(out / "profile")),
                               True)
    vals = [v["mIoU"] for v in full["val"]]
    if len(full["val"]) != 2 or not all(np.isfinite(vals)):
        raise AssertionError(f"validation results {full['val']}")
    traces = sorted((out / "profile").glob("*.json"))
    text = traces[0].read_text() if len(traces) == 1 else ""
    named = {k: text.count(k) for k in TRACE_KERNELS}
    if not (traces == [out / "profile" / "train_epoch_1.pt.trace.json"]
            and '"traceEvents"' in text and all(named.values())):
        raise AssertionError(f"profile_dir: traces {traces}, kernel names {named}")
    trace_mb = traces[0].stat().st_size / 2 ** 20
    state_a = host_state(full["trainer"])
    del full
    pre, pre_s = counted_run(driver_cfg(root, out / "pre", _preempt_after_step=3), False)
    snap = out / "pre" / "train_preempt.pth"
    if not (pre["preempt"] == str(snap.resolve()) and snap.is_file()
            and pre["trainer"].step_count == 3):
        raise AssertionError(f"preemption: {pre['preempt']}, step {pre['trainer'].step_count}")
    del pre
    res, res_s = counted_run(driver_cfg(root, out / "pre", resume="auto"), False)
    files = sorted(p.name for p in (out / "pre").glob("*.pth"))
    if res["trainer"].step_count != 4 or snap.exists() or files != [
            "train_epoch_1.pth", "train_epoch_2.pth"]:
        raise AssertionError(f"resume: step {res['trainer'].step_count}, files {files}")
    same_ra, dist = state_spread(host_state(res["trainer"]), state_a)
    same_ab, spread = True, 0.0
    if not same_ra:  # then the spread of two uninterrupted runs is the bar
        again, _ = counted_run(driver_cfg(root, out / "again"), False)
        same_ab, spread = state_spread(host_state(again["trainer"]), state_a)
        del again
        if same_ab or dist > 2 * spread:
            raise AssertionError(f"resumed run vs uninterrupted: max relative L2 {dist} (two "
                                 f"uninterrupted runs: equal {same_ab}, {spread})")

    trainer = res["trainer"]
    state = trainer.state_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(str(out / "timing"), 1, state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_checkpoint_async(str(out / "timing"), 2, state)
    async_s = time.perf_counter() - t0
    ckpt.wait_pending()
    async_total_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.load_state_dict(ckpt.load_checkpoint(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size_mb = Path(path).stat().st_size / 2 ** 20
    log(f"[20 drivers] train PSANet50 bf16 705x705 batch 8, 2 epochs x 2 steps + validation "
        f"of 4 images each epoch: {full_s:.2f} s through run() (first step included), val mIoU "
        f"{[round(v, 4) for v in vals]}; preempted after step 3 in {pre_s:.2f} s, resumed to "
        f"step 4 in {res_s:.2f} s; files {files}, snapshot gone; resumed vs uninterrupted: "
        f"bit for bit {same_ra}, max relative L2 {dist:.3e}"
        + ("" if same_ra else f" (two uninterrupted runs: {spread:.3e})")
        + "; launches over the first run: train "
        f"{by_path['driver_train']}, validation {by_path['driver_val']}; profile_dir: the "
        f"first epoch's Chrome trace {trace_mb:.1f} MiB, kernel names in it {named}")
    log(f"[20 drivers] checkpoint {size_mb:.1f} MiB: save {save_s:.3f} s, async save returns in "
        f"{async_s:.3f} s (written after {async_total_s:.3f} s), restore {load_s:.3f} s "
        f"on {smi}")
    del res, trainer, state
    torch.cuda.empty_cache()

    test_cfg = driver_cfg(root, out / "full", model_path=str(out / "full" / "train_epoch_2.pth"))
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    keep = Keep()
    logger.addHandler(keep)
    try:
        reset_counts()
        result = ttest.run(test_cfg, device=dev, logger=logger)
        torch.cuda.synchronize()
        test_counts = read_counts()
    finally:
        logger.removeHandler(keep)
    n = result["images"]
    check_counts("test driver", test_counts,
                 {k: v * n for k, v in launches(**DRIVER_TEST_IMAGE).items()})
    names = [Path(ln.split()[0]).stem for ln in lines[16:20]]
    grays = {p.stem for p in (out / "full" / "result" / "gray").glob("*.png")}
    colors = {p.stem for p in (out / "full" / "result" / "color").glob("*.png")}
    if not (n == 4 and grays == colors == set(names) and result["metrics"] is not None
            and all(np.isfinite(result["metrics"]))
            and any(r.startswith("Eval result: mIoU") for r in records)):
        raise AssertionError(f"test driver: {n} images, gray {grays}, color {colors}, "
                             f"metrics {result['metrics']}")
    images = [cv2.cvtColor(cv2.imread(str(root / ln.split()[0])), cv2.COLOR_BGR2RGB)
              for ln in lines[16:20]]
    ev = ttest.make_evaluator(test_cfg, ttest.load_model(test_cfg, dev, logger), dev, "device")
    ev.predict(images[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for img in images:
        ev.predict(img)
    predict_s = time.perf_counter() - t0
    del ev
    torch.cuda.empty_cache()

    demo_dir = out / "demo"
    demo_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(root / lines[16].split()[0], demo_dir / f"{names[0]}.png")
    gray = demo.run(driver_cfg(root, out / "full", model_path=test_cfg.model_path,
                               image=str(demo_dir / f"{names[0]}.png")), device=dev, logger=logger)
    want = cv2.imread(str(out / "full" / "result" / "gray" / f"{names[0]}.png"),
                      cv2.IMREAD_GRAYSCALE)
    if not np.array_equal(gray, want):
        raise AssertionError(f"demo vs test driver: {int((gray != want).sum())} pixels differ")
    log(f"[20 drivers] test driver, f32 PSANet50, 4 images 1024x2048, single scale, flip: "
        f"{n / result['seconds']:.3f} images/s with its in-flight window (decode, PNG writes "
        f"and the first image included), predict alone {len(images) / predict_s:.3f} images/s; "
        f"mIoU/mAcc/allAcc {[round(v, 4) for v in result['metrics']]}; launches {test_counts}; "
        f"gray and color PNGs for {sorted(grays)}; demo gray equal to the test driver's")

    rates = {}
    for want_native in (False, True):
        loader, _ = build_train_loader(driver_cfg(root, out / "full", native_loader=want_native),
                                       logger)
        loader.set_epoch(0)
        t0 = time.perf_counter()
        count = sum(len(b[0]) for b in loader)
        rates[loader.pipeline] = count / (time.perf_counter() - t0)
    log(f"[20 drivers] host loader on the 16 training images (1024x2048, batch 8, "
        f"{test_cfg.workers} threads): "
        + ", ".join(f"{k} {v:.3f} images/s" for k, v in rates.items())
        + ("" if "native" in rates else
           f" (the native extension was not built: {str(native.build_error())[:300]})"))
    return by_path, {"driver_test": test_counts}


# Phase 21: two DDP ranks share the one card over gloo (NCCL needs a device
# per rank, and the card's machine shows one). The f32 step's bar: the
# relative L2 distance of every state entry to the one-process run (over
# that run's change), max and median over the entries, within DDP_K times
# the same distances of two one-process runs whose images differ by one
# float32 ulp (``chip_probes/ddp_floor.py`` on the CPU: DDP at 1.03-1.17
# times that floor).
DDP_RANKS, DDP_K = 2, 3.0


def ddp_driver_cfg(root, save):
    """Phase 13's training config (bf16, batch 16, 705 crops, one epoch of
    the 48 street images: 3 steps) over ``train_gpu: [0, 0]``: two ranks
    on the card over gloo, named explicitly."""
    cfg = train_cfg(root, 16)
    cfg.update(train_gpu=[0] * DDP_RANKS, dist_backend="gloo", multiprocessing_distributed=True,
               save_path=str(save))
    return cfg


def parallel_step_check(tag, label, path, world, model_parallel, batch, names):
    """One f32 PSANet50 step at 705x705 on global ``batch`` street samples
    as ``world / model_parallel x model_parallel`` ranks sharing the card
    over gloo (``parity.tp_steps``; DDP at ``model_parallel`` 1) against
    the one-process ``Trainer(num_replicas=world / model_parallel)``: the
    (gathered) state within ``DDP_K`` times the one-ulp floor measured here
    (max and median over the entries), the step-0 loss within 1e-5, the
    losses bit-identical on every rank; the one process's and each rank's
    launches exactly the 3xTF32 forward, da and dx twice, a TP rank's on
    its channel shard (``psa.reduce.0`` holds 512 / ``model_parallel``
    rows). Returns the launch counts by ``{path}_rank{r}``."""
    from semseg_torch.parallel import parity
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    pairs = [street_sample(40 + s) for s in range(batch)]
    images = ((np.stack([p[0][:705, :705] for p in pairs]).astype(np.float32)
               - np.float32(IMAGENET_MEAN)) / np.float32(IMAGENET_STD)).astype(np.float32)
    labels = np.stack([p[1][:705, :705] for p in pairs])
    spec = parity.StepSpec(cfg=psanet_cfg(), batches=[(images, labels)], base_lr=0.01,
                           device="cuda")
    data = world // model_parallel
    t0 = time.perf_counter()
    ref = parity.one_process_steps(spec, data)
    floor = parity.one_process_steps(dataclasses.replace(spec, batches=[
        (np.nextafter(images, np.float32(np.inf)), labels)]), data)
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parity.tp_steps(spec, world, model_parallel, timeout_s=400)
    ranks_s = time.perf_counter() - t0
    check_counts(f"{label}: one-process f32 step", {k: ref["launches"][0][k] for k in names},
                 launches(**F32_TRAIN_STEP))
    by_path = {}
    for r, res in enumerate(ranks):
        counts = {k: res["launches"][0][k] for k in names}
        check_counts(f"{label} f32 step, rank {r}", counts, launches(**F32_TRAIN_STEP))
        by_path[f"{path}_rank{r}"] = counts
        rows = res["shard_rows"].get("psa.reduce.0.weight")
        if model_parallel > 1 and rows != 512 // model_parallel:
            raise AssertionError(f"{label}, rank {r}: shard rows {res['shard_rows']}")
    d_floor = parity.relative_distances(floor["state"], ref["state"], ref["init"])
    d_ranks = parity.relative_distances(ranks[0]["state"], ref["state"], ref["init"])
    stats = {k: (max(d.values()), float(np.median(list(d.values()))))
             for k, d in (("floor", d_floor), ("ranks", d_ranks))}
    worst = max(d_ranks, key=d_ranks.get)
    loss_rel = abs(ranks[0]["losses"][0][0] - ref["losses"][0][0]) / abs(ref["losses"][0][0])
    ok = (all(r["losses"] == ranks[0]["losses"] for r in ranks) and loss_rel <= 1e-5
          and sorted(ranks[0]["state"]) == sorted(ref["state"])
          and all(np.isfinite(v) for v in d_ranks.values())
          and stats["ranks"][0] <= DDP_K * stats["floor"][0]
          and stats["ranks"][1] <= DDP_K * stats["floor"][1])
    log(f"[{tag}] {label}: f32 PSANet50 705x705 global batch {batch}, one step, {data} x "
        f"{model_parallel} (data x model) ranks against the one-process Trainer(num_replicas="
        f"{data}): loss {ranks[0]['losses'][0][0]:.6f} vs {ref['losses'][0][0]:.6f} (rel "
        f"{loss_rel:.2e}), equal on all {world} ranks; state distance max "
        f"{stats['ranks'][0]:.4f} ({worst}) median {stats['ranks'][1]:.4f}, one-ulp floor max "
        f"{stats['floor'][0]:.4f} median {stats['floor'][1]:.4f} (bar {DDP_K} x floor) over "
        f"{len(d_ranks)} entries; per-rank launches {by_path[path + '_rank0']} at C = "
        f"{512 // model_parallel}; seconds: two one-process runs {one_s:.2f}, the {world}-rank "
        f"spawn {ranks_s:.2f}, rank steps {[round(r_['seconds'][0], 3) for r_ in ranks]}, peak "
        f"{[round(r_['peak_gib'], 2) for r_ in ranks]} GiB a rank")
    if not ok:
        raise AssertionError(f"{label} f32 step against one process: losses "
                             f"{[r['losses'] for r in ranks]} vs {ref['losses']}, distances "
                             f"{stats}")
    del ref, floor, ranks
    torch.cuda.empty_cache()
    return by_path


def spawn_driver(cfg, save):
    """``semseg_torch.train.spawn(cfg, "cuda")`` into a fresh ``save``
    directory, the ranks' log lines in ``save/ranks.log``: ``(summaries,
    log text, seconds, log path)``."""
    from semseg_torch.train import spawn

    shutil.rmtree(save, ignore_errors=True)
    save.mkdir(parents=True)
    log_path = save / "ranks.log"
    sys.stderr.flush()
    saved_fd, fd = os.dup(2), os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)  # the ranks inherit the descriptor: their log lines go to the file
    try:
        t0 = time.perf_counter()
        summaries = spawn(cfg, "cuda", timeout_s=600)
        spawn_s = time.perf_counter() - t0
    finally:
        sys.stderr.flush()
        os.dup2(saved_fd, 2)
        os.close(fd)
        os.close(saved_fd)
    return summaries, log_path.read_text(), spawn_s, log_path


def phase_ddp(dev, root, smi, one_rank_images_per_s):
    """Data-parallel training as two ranks sharing the card (phase 21): one
    f32 PSANet50 step at 705x705, global batch 4, as 2 DDP ranks against
    the one-process ``Trainer(num_replicas=2)``, gated on the one-ulp floor
    measured here, with each rank's launches exact; then the bf16 driver
    through ``semseg_torch.train.spawn`` (phase 13's config, global batch
    16, 3 steps): launches per rank, one checkpoint written by rank 0,
    which alone logs; peak memory per rank and images/s. Returns the
    launch counts by path and rank."""
    from semseg_torch.engine import checkpoint as ckpt

    log(f"[21 ddp] {DDP_RANKS} ranks share the one card over gloo, named in the config: NCCL "
        f"needs a device per rank and this machine shows {torch.cuda.device_count()}")
    names = list(kernels())
    by_path = parallel_step_check("21 ddp", "DDP", "ddp_f32_step", DDP_RANKS, 1, 4, names)

    save = OUT_DIR / "ddp"
    cfg = ddp_driver_cfg(root, save / "exp")
    summaries, text, spawn_s, log_path = spawn_driver(cfg, save)
    steps = 48 // 16
    for res in summaries:
        counts = {k: res["launches"][k] for k in names}
        check_counts(f"DDP bf16 driver, rank {res['rank']}", counts,
                     {k: steps * v for k, v in launches(**TRAIN_STEP).items()})
        by_path[f"ddp_bf16_driver_rank{res['rank']}"] = counts
    files = sorted(p.name for p in (save / "exp").iterdir())
    payload = ckpt.load_checkpoint(str(save / "exp" / "train_epoch_1.pth"))
    if not ([r["steps"] for r in summaries] == [steps] * DDP_RANKS
            and files == ["scalars.jsonl", "train_epoch_1.pth"]
            and text.count("Saving checkpoint to") == 1 and text.count("MainLoss") == steps
            and payload["step"] == steps
            and not any(k.startswith("module.") for k in payload["state_dict"])):
        raise AssertionError(f"DDP driver: steps {[r['steps'] for r in summaries]}, files "
                             f"{files}, {text.count('Saving checkpoint to')} saves and "
                             f"{text.count('MainLoss')} step lines logged (log {log_path})")
    ends = summaries[0]["step_ends"]
    rate = (steps - 1) * 16 / (ends[-1] - ends[0])
    log(f"[21 ddp] bf16 driver, train_gpu [0, 0] over gloo, PSANet50 705x705 global batch 16 "
        f"(8 a rank), {steps} steps through spawn() in {spawn_s:.2f} s (process start, build "
        f"and loader included): {rate:.3f} images/s over steps 2-{steps} (two ranks sharing "
        f"one card, not a scaling number; one process, phase 14: "
        f"{one_rank_images_per_s or 'not measured'} images/s on a device-resident batch); peak "
        f"{[round(r['peak_gib'], 2) for r in summaries]} GiB a rank; per-rank launches "
        f"{by_path['ddp_bf16_driver_rank0']}; one checkpoint, written and logged by rank 0 "
        f"alone, files {files}; on {smi}")
    return by_path


# Phase 22: a fresh process loads the CUDA-targeted crop artifact, with TF32
# on (cuDNN's default) until the artifact's contract turns it off, runs each
# batch once (the launches) and then times it (CUDA events, median of 5).
_EXPORT_LOADER = """
import json, sys, time
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
t0 = time.perf_counter()
from semseg_torch.engine.export import load_serving
serve = load_serving(sys.argv[1])
load_s = time.perf_counter() - t0
from semseg_torch.ops import launch_counters
counters = launch_counters()
per_call, ms, out = [], {}, {}
with torch.no_grad():
    for key, x in np.load(sys.argv[2]).items():
        x = torch.from_numpy(x).cuda()
        before = {k: fn.launches for k, fn in counters.items()}
        out[key] = serve(x).cpu().numpy()
        per_call.append({k: fn.launches - before[k] for k, fn in counters.items()})
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            serve(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms[key] = float(np.median(times))
np.savez(sys.argv[3], **out)
print("EXPORT_LOADER " + json.dumps({
    "load_s": load_s, "per_call": per_call, "ms": ms,
    "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}))
"""


def export_program(label, export, path, eager, load=True):
    """Export with ``export()``, whose kernels are those of its one eager
    call, ``eager`` (the trace launches none), save to ``path`` and, with
    ``load``, load it back in this process (else the traced program
    itself); returns ``(program, {"trace_s", "save_s", "mb", "load_s",
    "ops"})``; ``trace_s`` includes the eager call."""
    from semseg_torch.engine.export import load_serving, save_serving, semseg_ops

    reset_counts()
    t0 = time.perf_counter()
    exported = export()
    trace_s = time.perf_counter() - t0
    check_counts(f"{label} export", read_counts(), eager)
    t0 = time.perf_counter()
    save_serving(str(path), exported)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = load_serving(str(path)) if load else exported.module()
    load_s = time.perf_counter() - t0 if load else None
    return program, {"trace_s": trace_s, "save_s": save_s, "load_s": load_s,
                     "mb": path.stat().st_size / 1e6, "ops": semseg_ops(exported)}


def images_per_s(fn, images):
    """Host-clock rate of ``fn`` over ``images`` after one warm-up call,
    synchronised; returns ``(rate, outputs)``."""
    fn(images[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(img) for img in images]
    torch.cuda.synchronize()
    return len(images) / (time.perf_counter() - t0), outs


def phase_export(dev, images, smi):
    """Serving export (phase 22), float32 as ``semseg_torch.export`` builds:
    the CUDA-targeted PSANet50 crop artifact (705) reloaded in a fresh
    process, within 1e-6 of the in-framework module at batch 1 and 3,
    exactly 2 3xTF32 forwards a call through ``semseg::psa_softmax_bmm``,
    TF32 off there; the CUDA-targeted PSANet50 and the portable PSPNet50
    full-scope artifacts at 1024x2048 (single scale, flip, ``window_batch``
    8), byte for byte ``predict``, exactly 4 3xTF32 forwards an image
    (PSANet50) and none (PSPNet50), images/s beside ``predict``'s. Trace,
    save and load seconds and artifact sizes. Returns the launch counts by
    path."""
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.engine.export import export_serving, export_sliding_window, make_serving_fn
    from semseg_torch.models.build import build_model
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    phase_t0 = time.perf_counter()
    out = OUT_DIR / "export"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    norm = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD)
    op = ["semseg::psa_softmax_bmm"]
    by_path = {}

    # PSANet50 crop artifact, CUDA-targeted
    model = build_model(psanet_cfg(), dtype=torch.float32, device=dev, seed=0)
    traced, crop = export_program("PSANet50 crop", lambda: export_serving(
        model, crop_h=705, crop_w=705, platforms=["cuda"], **norm), out / "psanet_crop.pt2",
        launches(psa_softmax_bmm_tf32x3=2), load=False)
    if crop["ops"] != op:
        raise AssertionError(f"the CUDA-targeted PSANet50 export holds {crop['ops']}, not {op}")
    wins = np.stack([img[:705, s:s + 705] for img, s in zip(images, (0, 600, 1300))])
    inputs = {"b1": wins[:1].astype(np.float32), "b3": wins.astype(np.float32)}
    np.savez(out / "in.npz", **inputs)
    direct = make_serving_fn(model, **norm)
    want, direct_ms, traced_ms, host_ms = {}, {}, {}, {}
    with torch.no_grad():
        for key, x in inputs.items():
            x = torch.from_numpy(x).to(dev)
            reset_counts()
            want[key] = direct(x).cpu().numpy()
            check_counts(f"in-framework crop {key}", read_counts(),
                         launches(psa_softmax_bmm_tf32x3=2))
            direct_ms[key] = cuda_ms(lambda: direct(x), reps=5, warmup=1)
            # the traced program in this process, and each one's host time
            # to enqueue a call (device kept busy by a 30 ms spin)
            traced_ms[key] = cuda_ms(lambda: traced(x), reps=5, warmup=1)
            for name, fn in (("in-framework", direct), ("traced", traced)):
                torch.cuda._sleep(60_000_000)
                t0 = time.perf_counter()
                fn(x)
                host_ms[(key, name)] = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _EXPORT_LOADER, str(out / "psanet_crop.pt2"),
         str(out / "in.npz"), str(out / "got.npz")], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(Path.cwd())))
    fresh_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the fresh process failed to serve the crop artifact:\n"
                             f"{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.split("EXPORT_LOADER ", 1)[1].splitlines()[0])
    names = list(kernels())
    for call in res["per_call"]:
        check_counts("crop artifact call", {k: call[k] for k in names},
                     launches(psa_softmax_bmm_tf32x3=2))
    if res["tf32"] != [False, False]:
        raise AssertionError(f"TF32 flags {res['tf32']} after loading a float32 artifact")
    got = np.load(out / "got.npz")
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in inputs}
    if not max(errs.values()) <= 1e-6:
        raise AssertionError(f"crop artifact vs in-framework: max abs {errs}")
    by_path["export_psanet_crop"] = {k: sum(c[k] for c in res["per_call"]) for k in names}
    log(f"[22 export] PSANet50 crop 705x705 f32 CUDA-targeted ({crop['ops']}): trace "
        f"{crop['trace_s']:.2f} s, save {crop['save_s']:.2f} s, {crop['mb']:.1f} MB; fresh "
        f"process {fresh_s:.2f} s, load {res['load_s']:.2f} s, TF32 {res['tf32']}; per call "
        f"{[c['psa_softmax_bmm_tf32x3'] for c in res['per_call']]} 3xTF32 forwards; max abs vs "
        f"in-framework {errs}; ms per call (median of 5) artifact {res['ms']}, in-framework "
        f"{direct_ms}, the traced program in this process {traced_ms}; host ms to enqueue a "
        f"call { {f'{k} {n}': round(v, 2) for (k, n), v in host_ms.items()} }; on {smi}")
    del direct, traced
    torch.cuda.empty_cache()

    # full-scope artifacts, 1024x2048, single scale, flip, window_batch 8
    full_images = images[:2]
    for tag, cfg, platforms, per_image in (
            ("PSANet50", psanet_cfg(), ["cuda"], launches(psa_softmax_bmm_tf32x3=4)),
            ("PSPNet50", pspnet_cfg(), ["cpu", "cuda"], launches())):
        if tag == "PSPNet50":
            model = build_model(cfg, dtype=torch.float32, device=dev, seed=0)
        ev = SlidingWindowEvaluator(model, classes=cfg.classes, crop_h=cfg.test_h,
                                    crop_w=cfg.test_w, base_size=cfg.base_size,
                                    scales=cfg.scales, window_batch=8, device=dev, **norm)
        program, full = export_program(f"{tag} full", lambda: export_sliding_window(
            ev, 1024, 2048, platforms=platforms), out / f"{tag.lower()}_full.pt2", per_image)
        if full["ops"] != (op if tag == "PSANet50" else []):
            raise AssertionError(f"{tag} full-scope export holds {full['ops']}")
        predict_rate, preds = images_per_s(ev.predict, full_images)

        def serve(img, program=program):
            with torch.no_grad():
                return program(torch.from_numpy(img).to(dev)).cpu().numpy()

        reset_counts()
        serve(full_images[0])
        torch.cuda.synchronize()
        check_counts(f"{tag} full artifact", read_counts(), per_image)
        by_path[f"export_{tag.lower()}_full"] = read_counts()
        rate, maps = images_per_s(serve, full_images)
        for pred, got_map in zip(preds, maps):
            if got_map.dtype != np.uint8 or not np.array_equal(got_map, pred):
                raise AssertionError(f"{tag} full artifact differs from predict on "
                                     f"{int((got_map != pred).sum())} pixels")
        log(f"[22 export] {tag} full scope 1024x2048 f32, platforms {platforms} "
            f"({full['ops'] or 'no operator'}): trace {full['trace_s']:.2f} s, save "
            f"{full['save_s']:.2f} s, {full['mb']:.1f} MB, load {full['load_s']:.2f} s; "
            f"byte for byte predict on {len(full_images)} images; launches an image "
            f"{ {k: v for k, v in by_path[f'export_{tag.lower()}_full'].items() if v} }; "
            f"artifact {rate:.4f} images/s, predict {predict_rate:.4f} images/s; on {smi}")
        del ev, program
        torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    log(f"[22 export] phase {time.perf_counter() - phase_t0:.1f} s")
    return by_path


# Phase 23: the evaluator's partitions over two entries of the one card.
# Per 1024x2048 image (8 windows, 2 chunks of 4 pairs at window_batch 8):
# under ``window`` each entry runs 2 pairs a chunk, so the stitch kernel
# twice a chunk and, for PSANet50, the bf16 forward twice an entry a chunk
# (two directions); the f32 PSANet50 the 3xTF32 forward alike (no stitch:
# f32). Under ``spatial`` the stitch runs once a chunk on the primary, on
# the gathered logits, and the PSA module whole there: its bf16 (or f32
# 3xTF32) forward twice a chunk; the f32 PSPNet50 launches no kernel.
PARTITION_ENTRIES = 2
WINDOW_IMAGE = {"PSPNet50": dict(upsample_softmax_flip=4),
                "PSANet50": dict(upsample_softmax_flip=4, psa_softmax_bmm_wgmma=8)}
SPATIAL_IMAGE = {"PSPNet50": dict(upsample_softmax_flip=2),
                 "PSANet50": dict(upsample_softmax_flip=2, psa_softmax_bmm_wgmma=4)}
SPATIAL_F32_IMAGE = {"PSPNet50": {}, "PSANet50": dict(psa_softmax_bmm_tf32x3=4)}
SPATIAL_TOL = 1e-4  # f32 sums in another order (cuDNN's choice by shape)
# The bf16 spatial partition against its two witnesses: one device at half
# the window batch (the same arithmetic on other shapes) and the f32 result.
# Measured on the H100 (chip_probes/spatial_bf16_probe.py): max abs against
# one device 0.86-1.20x the witness's, against f32 0.79-0.98x one device's,
# agreement within 4e-4 of the witness's and never below one device's.
SPATIAL_BF16_SLACK = dict(vs_witness=1.5, vs_f32=1.25, agreement=0.002)


def bf16_spatial_gate(got, single, half, f32):
    """A bf16 ``spatial`` result ``got`` against the single-device bf16
    result ``single``, ``single`` at half the window batch ``half`` and the
    f32 single-device result ``f32`` of one image. A bf16 convolution's
    rounding depends on the f32 summation order cuDNN picks for the problem
    shape, and one flip grows through the 50 layers of random weights, so
    the row slabs move the result as far as any other shape does: the
    partition is held to (a) its spread from one device within 1.5x the
    half-batch witness's and (b) its distance to f32 within 1.25x one
    device's, argmax agreement within 0.002 of each. Returns the readings;
    raises when a bar is missed."""
    def spread(a, b):
        return float(np.abs(a - b).max()), float((a.argmax(-1) == b.argmax(-1)).mean())

    r = dict(vs_single=spread(got, single), witness=spread(half, single),
             vs_f32=spread(got, f32), single_vs_f32=spread(single, f32))
    k = SPATIAL_BF16_SLACK
    ok = (np.isfinite(got).all()
          and r["vs_single"][0] <= k["vs_witness"] * r["witness"][0]
          and r["vs_single"][1] >= r["witness"][1] - k["agreement"]
          and r["vs_f32"][0] <= k["vs_f32"] * r["single_vs_f32"][0]
          and r["vs_f32"][1] >= r["single_vs_f32"][1] - k["agreement"])
    if not ok:
        raise AssertionError(f"bf16 spatial off its witnesses: {r}")
    return r


def counted(fn, images):
    """``fn`` over ``images`` with the launch counts set to 0 just before:
    (results, seconds, counts)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = [fn(img) for img in images]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def phase_partitions(dev, images, smi):
    """The evaluator over ``devices=[cuda:0, cuda:0]`` (phase 23): one card
    runs the multi-device code (a replica shared by both entries, rows and
    pairs moved between them as between two cards). f32, 1 image of each
    model: ``window`` and ``spatial`` within 1e-4 of one device, agreement
    >= 0.999, the PSA module whole on the primary under ``spatial``.
    ``window``, bf16, 2 images of each model: exact launches, the fused
    stitch on each entry's pairs; bit for bit the single-device evaluator
    that runs the same forward batch (``window_batch`` 4: 2 pairs and
    their flips, as each entry), so within the stitch license of it (2e-2,
    argmax agreement >= 0.995); beside it, not gated, the spread against
    ``window_batch`` 8, which is the bf16 forward's own at batch 4 against
    8 (cuDNN picks its algorithms by shape). ``spatial``, bf16, 1 image of
    each: exact launches (the stitch on the primary), held by
    :func:`bf16_spatial_gate` to the half-batch and f32 witnesses.
    ``host``, PSPNet50 f32, 1 image: against device mode at JAX's bar
    (``tests/test_integration.py:322-324``: atol 2e-2, rtol 1e-2,
    agreement > 0.995). images/s of each: two entries on one card, not a
    scaling number."""
    from semseg_torch.serve import build_evaluator
    from semseg_torch.utils.misc import get_logger

    phase_t0 = time.perf_counter()
    entries = [dev] * PARTITION_ENTRIES
    by_path, f32_evals = {}, {}
    for label, cfg in (("PSPNet50", pspnet_cfg()), ("PSANet50", psanet_cfg())):
        tag = label.lower()[:6]
        single = build_evaluator(cfg, get_logger(), dtype=torch.float32, device=dev, seed=0)
        want = single.predict_probs(images[0])
        for partition in ("window", "spatial"):
            ev = single.with_options(devices=entries, partition=partition)
            ev.predict(images[2])  # warm-up
            (got,), seconds, counts = counted(ev.predict_probs, images[:1])
            per_image = SPATIAL_F32_IMAGE[label] if partition == "spatial" else {
                k: 2 * v for k, v in SPATIAL_F32_IMAGE[label].items()}
            check_counts(f"{label} {partition} f32", counts, launches(**per_image))
            err = float(np.abs(got - want).max())
            agree = float((got.argmax(-1) == want.argmax(-1)).mean())
            if not (np.isfinite(got).all() and err <= SPATIAL_TOL and agree >= 0.999):
                raise AssertionError(f"{label} {partition} f32: max abs {err}, "
                                     f"agreement {agree}")
            by_path[f"{tag}_{partition}_f32"] = counts
            log(f"[23 partitions] {label} {partition}, f32, {PARTITION_ENTRIES} entries on one "
                f"card (not a scaling number): predict_probs of 1 image in {seconds:.3f} s = "
                f"{1 / seconds:.4f} images/s; vs one device: max abs diff {err:.3e} (bar "
                f"{SPATIAL_TOL}), agreement {agree:.6f}; launches {counts} on {smi}")
            del ev
            torch.cuda.empty_cache()
        f32_evals[label] = (single, want)

        single = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=dev, seed=0)
        same_batch = single.with_options(
            window_batch=single.window_batch // PARTITION_ENTRIES)
        ev = single.with_options(devices=entries, partition="window")
        if not ev.fused_stitch or len(ev.models) != PARTITION_ENTRIES:
            raise AssertionError(f"{label} window: fused {ev.fused_stitch}, "
                                 f"{len(ev.models)} entries")
        ev.predict(images[2])  # warm-up
        preds, seconds, counts = counted(ev.predict, images[:2])
        check_counts(f"{label} window", counts,
                     {k: 2 * v for k, v in launches(**WINDOW_IMAGE[label]).items()})
        spread, witness = (0.0, 1.0), None
        for img, pred in zip(images[:2], preds):
            pf, p_same = ev.predict_probs(img), same_batch.predict_probs(img)
            if (pred != pf.argmax(-1)).any() or not np.array_equal(pf, p_same):
                raise AssertionError(f"{label} window: predict and predict_probs disagree, or "
                                     f"not bit for bit window_batch {same_batch.window_batch}")
            agreement(23, f"{label} window over {PARTITION_ENTRIES} entries vs one device at "
                      f"the same forward batch", pf, p_same)
            p8 = single.predict_probs(img)
            spread = (max(spread[0], float(np.abs(pf - p8).max())),
                      min(spread[1], float((pf.argmax(-1) == p8.argmax(-1)).mean())))
            if witness is None:
                witness = (p8, p_same)  # images[0]: one device at window_batch 8 and 4
        by_path[f"{tag}_window"] = counts
        log(f"[23 partitions] {label} window, bf16, {PARTITION_ENTRIES} entries on one card "
            f"(not a scaling number): 2 images in {seconds:.3f} s = {2 / seconds:.4f} images/s "
            f"(single-device: phase {5 if label == 'PSPNet50' else 8}); bit for bit one device at "
            f"window_batch {same_batch.window_batch}; against window_batch "
            f"{single.window_batch} (the bf16 forward at batch 4 vs 8, not gated): max abs "
            f"{spread[0]:.3e}, agreement {spread[1]:.6f}; launches {counts} on {smi}")
        del ev
        torch.cuda.empty_cache()

        ev = single.with_options(devices=entries, partition="spatial")
        if not ev.fused_stitch:
            raise AssertionError(f"{label} spatial: the bf16 evaluator lost the fused stitch")
        ev.predict(images[2])  # warm-up
        (got,), seconds, counts = counted(ev.predict_probs, images[:1])
        check_counts(f"{label} spatial", counts, launches(**SPATIAL_IMAGE[label]))
        r = bf16_spatial_gate(got, *witness, f32_evals[label][1])
        by_path[f"{tag}_spatial"] = counts
        log(f"[23 partitions] {label} spatial, bf16, {PARTITION_ENTRIES} entries on one card "
            f"(not a scaling number): predict_probs of 1 image in {seconds:.3f} s = "
            f"{1 / seconds:.4f} images/s; (max abs, agreement) vs one device {r['vs_single']}, "
            f"witness one device at window_batch {same_batch.window_batch} vs "
            f"{single.window_batch} {r['witness']}; vs f32 {r['vs_f32']}, one device vs f32 "
            f"{r['single_vs_f32']}; launches {counts} on {smi}")
        del single, same_batch, ev
        torch.cuda.empty_cache()

    single, want = f32_evals["PSPNet50"]
    host = single.with_options(mode="host")
    image = images[0].astype(np.float32)
    (got,), seconds, counts = counted(host.predict_probs, [image])
    check_counts("PSPNet50 host", counts, launches())
    err = float(np.abs(got - want).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    if not (got.dtype == np.float64 and np.allclose(want, got, atol=2e-2, rtol=1e-2)
            and agree > 0.995):
        raise AssertionError(f"PSPNet50 host vs device: max abs {err}, agreement {agree}")
    by_path["pspnet_host"] = counts
    log(f"[23 partitions] PSPNet50 host (cv2/numpy stitching, float64 canvas, model f32 on the "
        f"card): 1 image in {seconds:.3f} s = {1 / seconds:.4f} images/s; vs device mode: max "
        f"abs diff {err:.3e}, agreement {agree:.6f}; launches {counts} on {smi}")
    del f32_evals, single, host
    torch.cuda.empty_cache()
    log(f"[23 partitions] phase {time.perf_counter() - phase_t0:.1f} s")
    return by_path


# Phase 24: tensor parallelism (``model_parallel``) over ranks sharing the
# card over gloo, as phase 21. A PSANet50 TP rank runs the PSA kernels on
# its channel shard: C = 512 / TP_M at the Cityscapes extent.
TP_M = 2
TP_EXTENTS = (("cityscapes-705-tp2", 8, 512 // TP_M, 2025),)
TP_DRIVER_BATCH, TP_DRIVER_STEPS = 8, 3


def tp_driver_cfg(root, save):
    """Phase 13's training config (bf16, 705 crops) at global batch
    ``TP_DRIVER_BATCH`` over ``train_gpu: [0, 0]`` with ``model_parallel
    2`` (one data rank: both ranks load every sample), gloo named, one
    epoch of the first ``TP_DRIVER_BATCH * TP_DRIVER_STEPS`` street images
    (``train_tp.txt``)."""
    root = Path(root)
    n = TP_DRIVER_BATCH * TP_DRIVER_STEPS
    lines = (root / "train.txt").read_text().splitlines()[:n]
    (root / "train_tp.txt").write_text("\n".join(lines) + "\n")
    cfg = train_cfg(root, TP_DRIVER_BATCH)
    cfg.update(train_gpu=[0] * TP_M, dist_backend="gloo", multiprocessing_distributed=True,
               model_parallel=TP_M, save_path=str(save), train_list=str(root / "train_tp.txt"))
    return cfg


def phase_tp(dev, root, smi, one_rank_images_per_s):
    """Tensor-parallel training, ranks sharing the card over gloo (phase
    24): the PSA kernels at a TP rank's channels (C = 256) against their
    plain versions with the bars of phases 4 and 12; one f32 PSANet50 step
    as 1 x 2 (data x model) and as a 2 x 2 grid against one process
    (``parallel_step_check``); the bf16 driver through ``semseg_torch.train.
    spawn`` with ``model_parallel 2`` (3 steps): launches per rank, one
    full checkpoint written by rank 0 that loads strictly into a
    one-process model, images/s and peak memory a rank. Returns the launch
    counts by path and rank, and the kernels' C = 256 readings."""
    from semseg_torch.engine import checkpoint as ckpt
    from semseg_torch.models.build import build_model

    phase_t0 = time.perf_counter()
    log(f"[24 tp] model_parallel {TP_M}: ranks share the one card over gloo, named in the "
        f"config (NCCL needs a device per rank; this machine shows "
        f"{torch.cuda.device_count()}); not a scaling number")
    fwd = phase_psa_kernels(dev, TP_EXTENTS, "24 tp kernels")
    bwd = phase_psa_backward(dev, TP_EXTENTS, "24 tp kernels")
    names = list(kernels())
    by_path = parallel_step_check("24 tp", "TP alone", "tp_f32_step", TP_M, TP_M, 2, names)
    by_path.update(parallel_step_check("24 tp", "the grid", "tp_grid", 2 * TP_M, TP_M, 4,
                                       names))

    save = OUT_DIR / "tp"
    cfg = tp_driver_cfg(root, save / "exp")
    summaries, text, spawn_s, log_path = spawn_driver(cfg, save)
    steps = TP_DRIVER_STEPS
    for res in summaries:
        counts = {k: res["launches"][k] for k in names}
        check_counts(f"TP bf16 driver, rank {res['rank']}", counts,
                     {k: steps * v for k, v in launches(**TRAIN_STEP).items()})
        by_path[f"tp_driver_rank{res['rank']}"] = counts
    files = sorted(p.name for p in (save / "exp").iterdir())
    payload = ckpt.load_checkpoint(str(save / "exp" / "train_epoch_1.pth"))
    one = build_model(cfg, device="cpu", train=True)
    one.load_state_dict(payload["state_dict"], strict=True)
    if not ([r["steps"] for r in summaries] == [steps] * TP_M
            and files == ["scalars.jsonl", "train_epoch_1.pth"]
            and text.count("Saving checkpoint to") == 1 and text.count("MainLoss") == steps
            and f"data x model = 1 x {TP_M}" in text and payload["step"] == steps
            and payload["state_dict"]["psa.attention.3.weight"].shape[0] == 89 * 89):
        raise AssertionError(f"TP driver: steps {[r['steps'] for r in summaries]}, files "
                             f"{files}, {text.count('Saving checkpoint to')} saves and "
                             f"{text.count('MainLoss')} step lines logged (log {log_path})")
    del one, payload
    ends = summaries[0]["step_ends"]
    rate = (steps - 1) * TP_DRIVER_BATCH / (ends[-1] - ends[0])
    log(f"[24 tp] bf16 driver, train_gpu [0, 0] over gloo, model_parallel {TP_M}, PSANet50 "
        f"705x705 global batch {TP_DRIVER_BATCH} (every sample on both ranks), {steps} steps "
        f"through spawn() in {spawn_s:.2f} s (process start, build and loader included): "
        f"{rate:.3f} images/s over steps 2-{steps} (two ranks sharing one card, not a scaling "
        f"number; one process, phase 14: {one_rank_images_per_s or 'not measured'} images/s "
        f"on a device-resident batch); peak {[round(r['peak_gib'], 2) for r in summaries]} GiB "
        f"a rank; per-rank launches {by_path['tp_driver_rank0']}; one full checkpoint "
        f"(psa.attention.3 {89 * 89} rows), written and logged by rank 0 alone, loads strictly "
        f"into a one-process model; files {files}; on {smi}")
    log(f"[24 tp] phase {time.perf_counter() - phase_t0:.1f} s")
    return by_path, fwd, bwd


# Phase 25: the bf16-vs-f32 convergence license (``semseg_torch/
# convergence.py``) at 97x97 crops, batch 8. PSANet50's PSA feature there is
# 7x7: the kernels run at hw 49, less than one tile.
CONV_EXTENTS = (("convergence-97", 8, 512, 49),)
CONV_STEPS = {"psp": 400, "psa": 400}
CONV_SEED = 0
# Each arm's final val mIoU: the JAX tool's arms finished at 0.741-0.750
# after 400 steps (CONVERGENCE_r03.jsonl), so a broken recipe falls far
# below this bar while seed noise does not reach it.
CONV_MIN_MIOU = 0.5
# |gap| in points, against a bf16 arm that trains but falls far behind. A
# coupled pair's gap is heavy-tailed on the H100 (NVIDIA H100 80GB HBM3,
# 700 W; chip_probes/convergence_sigma.py, 148 pairs over seeds 0-66):
# sigma_gap 1.65 (PSPNet50) and 2.05 (PSANet50) points, 13 pairs at 3
# points or more, the largest 8.65. So 3 points would fail a correct
# program after any change of one bit of the arithmetic; the bar sits
# beyond every pair measured. The JAX tool's own criterion, 1 point, is
# printed beside.
CONV_MAX_GAP = 10.0


def psa_arm_launches(dtype_name, steps, evals):
    """An arm's PSA launches: two directions a forward, so 2 forwards, 2
    da and 2 dx a train step and 2 forwards a validation batch."""
    from semseg_torch import convergence as conv

    kind = "tf32x3" if dtype_name == "float32" else "wgmma"
    fwd = 2 * steps + 2 * evals * (conv.N_VAL // conv.BATCH)
    return launches(**{f"psa_softmax_bmm_{kind}": fwd,
                       f"psa_softmax_bmm_bwd_da_{kind}": 2 * steps,
                       f"psa_softmax_bmm_bwd_dx_{kind}": 2 * steps})


def phase_convergence(dev, smi):
    """The convergence license on the card (phase 25): (a) the PSA forward,
    da and dx at (8, 512, 49), bf16 and f32, against their plain versions
    with the bars of phases 4 and 12; (b) ``convergence.run`` for PSPNet50
    and PSANet50, the f32 arm then the bf16 arm from one f32 init, seed
    ``CONV_SEED``, ``CONV_STEPS`` steps: both arms' initial states bit for
    bit the init, TF32 off in the f32 arm, every loss finite, exact
    launches (none for PSPNet50), every final val mIoU at least
    ``CONV_MIN_MIOU``, |gap| under ``CONV_MAX_GAP`` points; (c) the launch
    script ``semseg_torch/tool/train.sh`` on a PSANet50 config over phase
    13's street images (:func:`start_launch_script`), which runs in its own
    processes beside (b), after (a)'s timings. Returns the launches by
    path, the kernels' hw 49 readings and the summary lines."""
    from semseg_torch import convergence as conv

    phase_t0 = time.perf_counter()
    fwd = phase_psa_kernels(dev, CONV_EXTENTS, "25 convergence kernels")
    bwd = phase_psa_backward(dev, CONV_EXTENTS, "25 convergence kernels")

    launch = start_launch_script()
    try:
        by_path, summaries = convergence_arms(conv, dev, smi)
        finish_launch_script(launch)
    finally:
        if launch.proc.poll() is None:  # (b) failed: stop the script's processes
            os.killpg(launch.proc.pid, signal.SIGKILL)
            launch.proc.wait()
    log(f"[25 convergence] phase {time.perf_counter() - phase_t0:.1f} s on {smi}")
    return by_path, fwd, bwd, summaries


def convergence_arms(conv, dev, smi):
    """Phase 25 (b): both archs' arms with their gates; the launches by
    path and the summary lines."""
    train_set = conv.make_dataset(0, conv.N_TRAIN)
    val_set = conv.make_dataset(1, conv.N_VAL)
    by_path, summaries = {}, []
    for arch, steps in CONV_STEPS.items():
        init = conv.initial_state(arch, CONV_SEED, dev)
        for name in ("float32", "bfloat16"):
            state = conv.build_arm(name, steps, arch=arch, seed=CONV_SEED, init_state=init,
                                   device=dev).module.state_dict()
            if list(state) != list(init) or not all(
                    state[k].dtype == v.dtype and torch.equal(state[k], v)
                    for k, v in init.items()):
                raise AssertionError(f"convergence {arch} {name}: the arm's initial state is "
                                     "not the float32 init bit for bit")
        results = {}
        for name in ("float32", "bfloat16"):
            losses = []

            def hook(step, metrics):
                if step == 1 and name == "float32" and (torch.backends.cuda.matmul.allow_tf32
                                                        or torch.backends.cudnn.allow_tf32):
                    raise AssertionError("convergence: TF32 is on in the float32 arm")
                losses.append(metrics["loss"].detach())

            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            results[name] = conv.run(name, steps, train_set, val_set, arch=arch,
                                     seed=CONV_SEED, init_state=init, device=dev,
                                     step_hook=hook)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            evals = len(results[name])
            check_counts(f"convergence {arch} {name}", counts,
                         launches() if arch == "psp" else psa_arm_launches(name, steps, evals))
            by_path[f"convergence_{arch}_{'f32' if name == 'float32' else 'bf16'}"] = counts
            finite = torch.stack(losses).isfinite().all().item()
            final = results[name][-1][1]
            log(f"[25 convergence] {arch} {name}: {steps} steps and {evals} validations in "
                f"{seconds:.1f} s ({steps / seconds:.2f} steps/s with validation; the launch "
                f"script's processes share the card), final val mIoU {final:.4f}, last loss "
                f"{losses[-1].item():.4f}, losses finite {finite}")
            if not (len(losses) == steps and finite and final >= CONV_MIN_MIOU):
                raise AssertionError(f"convergence {arch} {name}: {len(losses)} steps, losses "
                                     f"finite {finite}, final val mIoU {final}")
        line = conv.summary(arch, steps, CONV_SEED, results, smi)
        summaries.append(line)
        log(json.dumps(line))
        log(f"[25 convergence] {arch}: gap {line['gap_points']} points, gated at "
            f"|gap| < {CONV_MAX_GAP}; the JAX tool's criterion |gap| < 1: "
            f"{'pass' if line['pass'] else 'FAIL'}")
        if not abs(line["gap_points"]) < CONV_MAX_GAP:
            raise AssertionError(f"convergence {arch}: gap {line['gap_points']} points")
    return by_path, summaries


def start_launch_script():
    """Phase 25 (c): start ``sh semseg_torch/tool/train.sh smoke psanet50``
    in a scratch directory (``build/chip_smoke/launch/``) holding
    ``config/smoke/smoke_psanet50.yaml`` (phase 13's street images: bf16, 1
    epoch of 2 steps at batch 8, the f32 test driver over 2 images) and the
    package linked in, its output in ``launch.out`` there, in a session of
    its own. PSANet50, since its training and its test driver launch the
    PSA kernels, which must build under the snapshot's own ``build/``."""
    import yaml

    import semseg_torch

    work = (OUT_DIR / "launch").resolve()
    shutil.rmtree(work, ignore_errors=True)
    (work / "config" / "smoke").mkdir(parents=True)
    (work / "semseg_torch").symlink_to(Path(semseg_torch.__file__).resolve().parent)
    root = (Path("build") / "chip_smoke_data").resolve()
    lines = (root / "train.txt").read_text().splitlines()
    (work / "train16.txt").write_text("\n".join(lines[:16]) + "\n")
    (work / "test2.txt").write_text("\n".join(lines[16:18]) + "\n")
    exp = Path("exp") / "smoke" / "psanet50"
    cfg = yaml.safe_load(Path("config/cityscapes/cityscapes_psanet50.yaml").read_text())
    cfg["DATA"].update(data_root=str(root), train_list=str(work / "train16.txt"),
                       val_list=str(work / "test2.txt"))
    cfg["TRAIN"].update(train_gpu=[0], batch_size=8, epochs=1, print_freq=1, workers=8,
                        manual_seed=0, compute_dtype="bfloat16", save_path=str(exp / "model"))
    cfg["TEST"].update(test_list=str(work / "test2.txt"), test_gpu=[0],
                       model_path=str(exp / "model" / "train_epoch_1.pth"),
                       save_folder=str(exp / "result" / "epoch_1" / "val" / "ss"),
                       colors_path=str(Path("data/cityscapes/cityscapes_colors.txt").resolve()),
                       names_path=str(Path("data/cityscapes/cityscapes_names.txt").resolve()))
    (work / "config" / "smoke" / "smoke_psanet50.yaml").write_text(yaml.safe_dump(cfg))
    with open(work / "launch.out", "w") as out:
        proc = subprocess.Popen(["sh", "semseg_torch/tool/train.sh", "smoke", "psanet50"],
                                cwd=work, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return SimpleNamespace(proc=proc, work=work, exp=work / exp,
                           classes=cfg["DATA"]["classes"], t0=time.perf_counter())


def finish_launch_script(launch):
    """Wait for the launch script (at most 600 s) and gate on it: exit 0,
    the snapshot, both timestamped logs each ending in its driver's last
    line (the checkpoint save, the last class's score), the checkpoint, the
    test driver's PNGs and the kernels built under the snapshot's
    ``build/``. The drivers' launch counts live in their own processes."""
    rc = launch.proc.wait(timeout=600)
    seconds = time.perf_counter() - launch.t0
    exp = launch.exp
    if rc != 0:
        raise AssertionError(f"train.sh: exit {rc}:\n"
                             f"{(launch.work / 'launch.out').read_text()[-3000:]}")
    snap = sorted(p.relative_to(exp / "semseg_torch").as_posix()
                  for p in (exp / "semseg_torch").rglob("*") if p.is_file())
    logs = sorted((exp / "model").glob("train-*.log")) + sorted(
        (exp / "result").glob("test-*.log"))

    def last(path):
        return path.read_text().rstrip().splitlines()[-1]

    out = exp / "result" / "epoch_1" / "val" / "ss"
    grays = sorted(p.name for p in (out / "gray").glob("*.png"))
    colors = sorted(p.name for p in (out / "color").glob("*.png"))
    built = sorted(p.name for p in (exp / "build" / "semseg_torch_kernels").glob("*.so"))
    ok = ({"train.py", "test.py", "convergence.py", "csrc/psa.cu", "tool/train.sh",
           "tool/test.sh", "tool/_snapshot.sh"} <= set(snap)
          and not any("__pycache__" in s for s in snap)
          and (exp / "smoke_psanet50.yaml").is_file()
          and [p.name[:5] for p in logs] == ["train", "test-"]
          and logs[0].name[6:] == logs[1].name[5:]
          and "Saving checkpoint to" in last(logs[0])
          and f"Class_{launch.classes - 1} result" in last(logs[1])
          and (exp / "model" / "train_epoch_1.pth").is_file()
          and grays == colors and len(grays) == 2 and built == ["libsemseg_psa.so"])
    log(f"[25 launch script] train.sh exit {rc} in {seconds:.1f} s (beside (b)); snapshot "
        f"of {len(snap)} files, logs {[p.name for p in logs]}, last lines "
        f"{[last(p)[-60:] for p in logs]}; PNGs {grays}; kernels built in the snapshot "
        f"{built}")
    if not ok:
        raise AssertionError(f"launch script: see the line above (work dir {launch.work})")


# Phase 26: the 101-layer Cityscapes recipes (``config/cityscapes/
# cityscapes_{psp,psa}net101.yaml``: layer3 holds 23 blocks at 89x89) and
# ``remat``, which recomputes each residual block of layer1..layer4 in the
# backward pass (``models/resnet.py``). The f32 arms run with
# ``cudnn.deterministic`` on (as ``convergence.run``): cuDNN's default f32
# algorithms are not reproducible on the card, and the arms are compared
# bit for bit.
R101_BATCH, R101_STEPS, R101_BIG_BATCH, R101_CROP = 8, 2, 16, 705
R101_SERVE = 4  # timed requests a model, after 2 warm-up ones


def psanet101_cfg(**kw):
    """``config/cityscapes/cityscapes_psanet101.yaml``'s model and TEST keys."""
    return psanet_cfg(layers=101, **kw)


def pspnet101_cfg(**kw):
    return SimpleNamespace(**{**vars(pspnet_cfg()), "layers": 101, **kw})


def f32_arm(dev, cfg, images, labels, steps, per_step, warmup=1):
    """A float32 model of ``cfg`` (seed 0, ``cfg.remat``, ``cfg.classes``)
    through the Trainer for ``steps`` steps on one device-resident batch,
    each launching ``per_step``; the losses, the seconds of each step, their
    mean after the first ``warmup``, the peak memory, the final state, the
    momentum buffers and the launches. ``chip_probes/remat_memory.py`` and
    ``chip_probes/repro_smoke.py`` run it too."""
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    remat = bool(getattr(cfg, "remat", False))
    label = f"{cfg.arch.upper()}Net{cfg.layers} f32 remat {remat}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dtype=torch.float32, device=dev, seed=0, train=True)
    if model.remat is not remat or (torch.backends.cudnn.allow_tf32
                                    or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError(f"{label}: the model's remat {model.remat}, or TF32 on")
    tr = Trainer(model, make_sgd(model, 0.01), classes=cfg.classes, ignore_label=255,
                 aux_weight=0.4,
                 base_lr=0.01, max_iter=100, power=0.9, zoom_factor=8,
                 normalize=(IMAGENET_MEAN, IMAGENET_STD))
    losses, seconds, by_path = [], [], launches()
    for i in range(steps):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.step(images, labels)["loss"])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts = read_counts()
        check_counts(f"{label} step {i}", counts, launches(**per_step))
        by_path = {k: by_path[k] + v for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # On the host: the next arm's peak holds none of this arm's tensors.
    out = dict(losses=torch.stack(losses).cpu(), seconds=seconds,
               step_s=sum(seconds[warmup:]) / len(seconds[warmup:]), peak_gib=peak,
               state={k: v.cpu() for k, v in model.state_dict().items()}, counts=by_path,
               momentum=[s["momentum_buffer"].cpu()
                         for s in tr.optimizer.state_dict()["state"].values()])
    if not torch.isfinite(out["losses"]).all():
        raise AssertionError(f"{label}: losses {out['losses'].tolist()}")
    del tr, model
    return out


def r101_train_cfg(root, remat):
    """``config/cityscapes/cityscapes_psanet101.yaml`` through the training
    entry point's parser, bf16, batch 16, one epoch of the first 32 street
    images of phase 13 (2 steps), ``remat`` as a CLI override."""
    from semseg_torch.train import parse_args

    root = Path(root)
    lines = (root / "train.txt").read_text().splitlines()[:2 * R101_BIG_BATCH]
    (root / "train32.txt").write_text("\n".join(lines) + "\n")
    return parse_args([
        "--config", "config/cityscapes/cityscapes_psanet101.yaml",
        "data_root", str(root), "train_list", str(root / "train32.txt"),
        "save_path", str(OUT_DIR / "r101" / f"remat_{remat}"), "train_gpu", "[0]",
        "batch_size", str(R101_BIG_BATCH), "epochs", "1", "print_freq", "1",
        "compute_dtype", "bfloat16", "remat", str(remat)])


def r101_driver(dev, root, remat):
    """Phase 26 (c): ``semseg_torch.train.run`` of the PSANet101 recipe,
    bf16, batch 16, 2 steps, each launching the tensor-core forward, da and
    dx twice; then the Trainer's step on a device-resident batch of the
    run's loader, 1 warm-up and 2 timed. Returns the launches, the run's
    peak memory, the seconds a step and the losses."""
    from semseg_torch.train import build_train_loader, run
    from semseg_torch.utils.misc import get_logger

    cfg = r101_train_cfg(root, remat)
    by_path, losses = launches(), []

    def hook(it, metrics):
        counts = read_counts()
        check_counts(f"PSANet101 bf16 driver remat {remat} step {it}", counts,
                     launches(**TRAIN_STEP))
        by_path.update({k: by_path[k] + v for k, v in counts.items()})
        losses.append(metrics["loss"].item())
        reset_counts()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run(cfg, dev, logger=get_logger(), step_hook=hook)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tr = res["trainer"]
    if not (len(losses) == 2 and all(np.isfinite(losses)) and tr.module.remat is remat
            and res["checkpoints"]):
        raise AssertionError(f"PSANet101 bf16 driver remat {remat}: losses {losses}, "
                             f"remat {tr.module.remat}, checkpoints {res['checkpoints']}")
    loader, _ = build_train_loader(cfg)
    loader.set_epoch(0)
    first = next(iter(loader))
    images = torch.from_numpy(first[0]).to(dev)
    labels = torch.from_numpy(first[1].astype(np.uint8)).to(dev)
    del first, loader
    tr.max_iter = tr.step_count + 100
    tr.step(images, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2):
        reset_counts()
        tr.step(images, labels)
        check_counts(f"PSANet101 bf16 timed step {i} remat {remat}", read_counts(),
                     launches(**TRAIN_STEP))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2
    del tr, res, images, labels
    shutil.rmtree(cfg.save_path, ignore_errors=True)  # the epoch checkpoint, 0.9 GB
    return dict(counts=by_path, peak_gib=peak, step_s=step_s, losses=losses, run_s=run_s)


def stitch_witness(label, model, image, crop, dev, when, bar=None):
    """The stitch kernel on a served bf16 model's own logits, held to the
    same function in float64: 4 windows across the top of ``image`` and
    their flips, feature-resolution logits rounded to bf16 as the evaluator
    hands them over, then the zoom upsample (the kernel's bf16-rounded
    weights), softmax and flip average with no rounding after the logits.
    Beside it, at the same distance: the kernel's plain version (its
    rounding points: the H pass rounded to bf16, bf16 halves) and the
    unfused path (the model's own bf16 zoom, float32 softmax, bf16
    probabilities). With ``bar``, the kernel against its plain version on
    these logits within it (phase 3 holds them so on random logits);
    the distances to float64 are printed, not gated."""
    from semseg_torch.ops.resize import interp_matrix
    from semseg_torch.ops.stitch import (
        upsample_softmax_flip,
        upsample_softmax_flip_reference,
    )

    offsets = np.linspace(0, image.shape[1] - crop, 4).astype(int)
    x = torch.cat([normalized_window(image[:, o:], crop, dev) for o in offsets])
    x = torch.cat([x, x.flip(-1)])
    n = len(offsets)
    with torch.no_grad():
        logits = model(x, zoom=False)
        pairs = torch.stack([logits[:n], logits[n:]], 1).to(torch.bfloat16).contiguous()
        fused = upsample_softmax_flip(pairs, (crop, crop)).double()
        rounded = upsample_softmax_flip_reference(pairs, (crop, crop)).double()
        probs = torch.softmax(model(x).float(), dim=1).to(torch.bfloat16).double()
        unfused = (probs[:n] + probs[n:].flip(-1)) / 2
        del probs
        hs, ws = pairs.shape[-2:]
        rh = interp_matrix(hs, crop, False, dev).to(torch.bfloat16).double()
        rw = interp_matrix(ws, crop, False, dev).to(torch.bfloat16).double()
        p = torch.softmax(rh @ pairs.double() @ rw.T, dim=2)
        exact = (p[:, 0] + p[:, 1].flip(-1)) / 2
        del p
    torch.cuda.synchronize()
    out = dict(max_logit=pairs.float().abs().max().item(),
               fused=(fused - exact).abs().max().item(),
               fused_vs_plain_kernel=(fused - rounded).abs().max().item(),
               plain_kernel=(rounded - exact).abs().max().item(),
               unfused=(unfused - exact).abs().max().item(),
               fused_vs_unfused=(fused - unfused).abs().max().item(),
               agreement=(fused.argmax(1) == exact.argmax(1)).double().mean().item())
    if not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"{label} stitch witness: {out}")
    log(f"[26 witness] {label}, {when}: max |logit| {out['max_logit']:.4g}; max abs "
        f"distance to the float64 upsample-softmax-flip of the same bf16 logits: kernel "
        f"{out['fused']:.3e}, its plain version {out['plain_kernel']:.3e}, the unfused path "
        f"{out['unfused']:.3e}; kernel vs its plain version "
        f"{out['fused_vs_plain_kernel']:.3e}, vs unfused {out['fused_vs_unfused']:.3e}; the "
        f"kernel's argmax agreement with float64 {out['agreement']:.6f}")
    del fused, rounded, unfused, exact
    if bar is not None and not out["fused_vs_plain_kernel"] <= bar:
        raise AssertionError(f"{label}: the stitch kernel against its plain version "
                             f"{out['fused_vs_plain_kernel']} > {bar} on the served logits")
    return out


def trained_statistics(label, crop, dev, images):
    """A ``prepare`` of :func:`phase_slice`: the served model's BatchNorm
    running statistics as training leaves them, the moments of its own
    activations (one train-mode forward, no grad, over a top-left window
    of each image, cumulative average), in place of the seeded init's mean
    0 and variance 1. With those, eval BatchNorm does not normalise: 101
    layers of residual sums grow the logits to about 1e4 (PSPNet50's stay
    near 10), where bf16's rounding of an interpolated logit (2^-8 of it)
    exceeds the top-2 margin of many pixels, and fused against plain then
    reads that rounding, not the kernel: :func:`stitch_witness` shows it,
    before and after. The weights stay the seeded init's; each BatchNorm
    gets its momentum back."""
    from semseg_torch.models.layers import BatchNorm2d

    def prepare(model):
        stitch_witness(label, model, images[0], crop, dev, "the init's BatchNorm statistics")
        x = torch.cat([normalized_window(img, crop, dev) for img in images])
        with torch.no_grad():
            bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
            momenta = [m.momentum for m in bns]
            for m in bns:
                m.reset_running_stats()
                m.momentum = None  # the cumulative average
            model.train()
            model(x)
            model.eval()
            for m, momentum in zip(bns, momenta):
                m.momentum = momentum
        log(f"[26 slice] {label}: BatchNorm statistics from {len(images)} train-mode windows")
        stitch_witness(label, model, images[0], crop, dev, "statistics from train-mode windows",
                       bar=TOL)

    return prepare


def phase_r101(dev, root, images, smi):
    """The 101-layer recipes and ``remat`` (phase 26): (a) PSANet101 f32 at
    705x705, batch 8, ``R101_STEPS`` steps from the same weights and batch
    with and without ``remat``, ``cudnn.deterministic`` on: losses,
    parameters, momentum buffers and running statistics bit for bit,
    ``num_batches_tracked`` the step count in both, the 3xTF32 kernels'
    launches exact; seconds a step (the last) and peak memory each; (b) the
    same with ``remat`` at batch 16, cuDNN's defaults, 1 warm-up and 2
    timed steps: seconds a step, images/s, peak memory; (c) the bf16
    PSANet101 recipe through ``semseg_torch.train.run`` with ``remat True``
    as a CLI override, and without (:func:`r101_driver`); (d) PSPNet101
    (713) and PSANet101 (705) serving, bf16, single scale, flip,
    ``window_batch`` 8, on 1024x2048 images, the BatchNorm statistics as
    training leaves them (:func:`trained_statistics`): exact launches (the
    stitch twice an image, PSANet101's bf16 forward 4 times), images/s,
    fused against plain at phases 6 and 9's bars. Returns the launches by
    path and the readings."""
    phase_t0 = time.perf_counter()
    by_path, out = {}, {}
    from semseg_torch.utils.misc import deterministic_cudnn

    batch8 = street_batch(dev, R101_BATCH, R101_CROP, 300)
    with deterministic_cudnn():
        arms = {remat: f32_arm(dev, psanet101_cfg(remat=remat), *batch8, R101_STEPS,
                               F32_TRAIN_STEP) for remat in (False, True)}
    off, on = arms[False], arms[True]
    state_diff = [k for k, v in off["state"].items() if not torch.equal(on["state"][k], v)]
    mom_diff = [i for i, (a, b) in enumerate(zip(on["momentum"], off["momentum"]))
                if not torch.equal(a, b)]
    tracked = {int(v) for arm in arms.values() for k, v in arm["state"].items()
               if k.endswith("num_batches_tracked")}
    for remat, arm in arms.items():
        by_path[f"psanet101_f32_steps{'_remat' if remat else ''}"] = arm["counts"]
        log(f"[26 r101] PSANet101 f32 {R101_CROP}x{R101_CROP} batch {R101_BATCH}, remat {remat}, "
            f"cudnn.deterministic: steps {[round(s, 4) for s in arm['seconds']]} s, "
            f"{arm['step_s']:.4f} s/step = {R101_BATCH / arm['step_s']:.3f} images/s (last "
            f"step), peak {arm['peak_gib']:.2f} GiB, losses "
            f"{[round(v, 6) for v in arm['losses'].tolist()]}; on {smi}")
    ratio = on["step_s"] / off["step_s"]
    log(f"[26 r101] remat against none at batch {R101_BATCH}: step time x{ratio:.3f}, peak "
        f"{on['peak_gib']:.2f} / {off['peak_gib']:.2f} GiB; state entries unequal "
        f"{len(state_diff)} of {len(off['state'])} {state_diff[:4]}, momentum buffers unequal "
        f"{len(mom_diff)} of {len(off['momentum'])}, losses equal "
        f"{torch.equal(on['losses'], off['losses'])}, num_batches_tracked {sorted(tracked)}")
    if state_diff or mom_diff or not torch.equal(on["losses"], off["losses"]) or (
            tracked != {R101_STEPS}):
        raise AssertionError("PSANet101 f32: remat is not the step without it bit for bit "
                             "(see the line above)")
    out["f32_b8"] = {remat: dict(step_s=a["step_s"], peak_gib=a["peak_gib"])
                     for remat, a in arms.items()}
    del arms, off, on, batch8
    torch.cuda.empty_cache()

    batch16 = street_batch(dev, R101_BIG_BATCH, R101_CROP, 400)
    big = f32_arm(dev, psanet101_cfg(remat=True), *batch16, 3, F32_TRAIN_STEP)
    by_path["psanet101_f32_b16_remat"] = big["counts"]
    log(f"[26 r101] PSANet101 f32 {R101_CROP}x{R101_CROP} batch {R101_BIG_BATCH} (the recipe's), remat, "
        f"cuDNN defaults: steps {[round(s, 4) for s in big['seconds']]} s, {big['step_s']:.4f} "
        f"s/step = {R101_BIG_BATCH / big['step_s']:.3f} images/s over steps 2-3, peak "
        f"{big['peak_gib']:.2f} GiB; on {smi}")
    out["f32_b16_remat"] = dict(step_s=big["step_s"], peak_gib=big["peak_gib"])
    del big, batch16
    torch.cuda.empty_cache()

    for remat in (True, False):
        res = r101_driver(dev, root, remat)
        out[f"bf16_b16_remat_{remat}"] = {k: res[k] for k in ("peak_gib", "step_s")}
        by_path[f"psanet101_driver{'_remat' if remat else ''}"] = res["counts"]
        log(f"[26 r101] bf16 PSANet101 recipe through run(), remat {remat}, batch "
            f"{R101_BIG_BATCH}: 2 steps in {res['run_s']:.2f} s (build and loader included), "
            f"losses {[round(v, 4) for v in res['losses']]}, peak {res['peak_gib']:.2f} GiB; "
            f"device-resident step {res['step_s']:.4f} s = "
            f"{R101_BIG_BATCH / res['step_s']:.3f} images/s; launches {res['counts']}; on {smi}")
    torch.cuda.empty_cache()

    for label, cfg, per_image in (
            ("PSPNet101", pspnet101_cfg(), launches(upsample_softmax_flip=2)),
            ("PSANet101", psanet101_cfg(),
             launches(upsample_softmax_flip=2, psa_softmax_bmm_wgmma=4))):
        ev, counts, rate = phase_slice(
            26, label, cfg, dev, images[:R101_SERVE], per_image,
            trained_statistics(label, cfg.test_h, dev, images[:R101_SERVE]))
        by_path[f"{label.lower()}_slice"] = counts
        out[f"{label}_images_per_s"] = rate
        if cfg.arch == "psp":
            phase_stitch_vs_plain(dev, ev, images[0], cfg, 26, label)
        else:
            phase_psa_vs_plain(ev, images[0], 26, label)
        del ev
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - phase_t0
    log(f"[26 r101] phase {out['seconds']:.1f} s on {smi}")
    return by_path, out


# Phase 27: the training driver reproducible in float32 (ROADMAP §3), on
# the ADE20K PSPNet50 recipe (``config/ade20k/ade20k_pspnet50.yaml``: 150
# classes, 473x473 crops, batch 16) and the Cityscapes PSANet50 recipe
# (705x705, batch 8, the 3xTF32 kernels); the evaluator's per-shape caches
# over ADE20K-like image sizes; ADE20K PSANet50 and VOC2012 PSPNet50 serving.
ADE_TRAIN, ADE_EVAL = 32, 24  # training images (2 steps of 16), evaluated ones
ADE_ROOT = Path("build") / "chip_smoke_ade"
# The allocated device memory beside the caches and the pending class maps
# (each counted as the allocator's block that holds it) may move by this
# much over the evaluated images: nothing else is kept per image shape.
RESIDUAL_MIB = 1


def ade_sizes(n, seed=7):
    """``n`` distinct ``(h, w)``, ADE20K-like: the long side uniform in
    256-2048, the short side 0.5-1 of it, landscape 7 times in 10."""
    rs = np.random.RandomState(seed)
    sizes = []
    while len(sizes) < n:
        long = int(rs.randint(256, 2049))
        short = int(round(long * rs.uniform(0.5, 1.0)))
        hw = (short, long) if rs.rand() < 0.7 else (long, short)
        if hw not in sizes:
            sizes.append(hw)
    return sizes


def ade_sample(seed, h, w):
    """A seeded indoor-like uint8 RGB image and its ADE20K label map: a
    background class and 6-13 rectangles of other classes (0-149), each
    class one colour of a fixed palette, pixel noise; 255 (unlabelled) on a
    band along the left edge and on one patch."""
    rs = np.random.RandomState(seed)
    label = np.full((h, w), rs.randint(150), np.uint8)
    for _ in range(rs.randint(6, 14)):
        bh, bw = rs.randint(h // 8, h // 2 + 1), rs.randint(w // 8, w // 2 + 1)
        y, x = rs.randint(0, h - bh + 1), rs.randint(0, w - bw + 1)
        label[y:y + bh, x:x + bw] = rs.randint(150)
    palette = np.random.RandomState(150).randint(0, 256, (150, 3)).astype(np.int16)
    img = palette[label] + rs.randint(-10, 11, (h, w, 3)).astype(np.int16)
    label[:, :max(1, w // 32)] = 255
    y, x = rs.randint(0, h - h // 8), rs.randint(0, w - w // 8)
    label[y:y + h // 8, x:x + w // 8] = 255
    return np.clip(img, 0, 255).astype(np.uint8), label


def write_ade_dataset(root=ADE_ROOT):
    """``ADE_TRAIN`` ADE20K-like samples of distinct sizes as PNGs,
    ``train.txt`` listing them and ``eval.txt`` the first ``ADE_EVAL``."""
    import cv2

    root = Path(root)
    (root / "img").mkdir(parents=True, exist_ok=True)
    sizes = ade_sizes(ADE_TRAIN)

    def write(k):
        img, label = ade_sample(500 + k, *sizes[k])
        cv2.imwrite(str(root / "img" / f"ade_{k}.png"), img[:, :, ::-1],
                    [cv2.IMWRITE_PNG_COMPRESSION, 1])
        cv2.imwrite(str(root / "img" / f"ade_{k}_label.png"), label,
                    [cv2.IMWRITE_PNG_COMPRESSION, 1])
        return f"img/ade_{k}.png img/ade_{k}_label.png"

    with ThreadPoolExecutor(8) as pool:
        lines = list(pool.map(write, range(ADE_TRAIN)))
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "eval.txt").write_text("\n".join(lines[:ADE_EVAL]) + "\n")
    return root


def recipe_cfg(config, root, train_list, save, batch, **keys):
    """``config`` through the training driver's parser: float32, one GPU,
    2 epochs at ``batch``, no validation, seed 0; ``keys`` set on it."""
    from semseg_torch.train import parse_args

    cfg = parse_args([
        "--config", config, "data_root", str(root), "train_list", str(train_list),
        "save_path", str(save), "train_gpu", "[0]", "batch_size", str(batch), "epochs", "2",
        "evaluate", "False", "print_freq", "1", "compute_dtype", "float32",
        "manual_seed", "0"])
    cfg.update(keys)
    return cfg


def state_diff(a, b):
    """``(differ, total, max_abs)``: how many entries of two host states
    differ (:func:`state_pairs` and the step), of how many, and the largest
    absolute difference."""
    pairs = state_pairs(a, b) + [(torch.tensor(a["step"]), torch.tensor(b["step"]))]
    gaps = [(x.double() - y.double()).abs().max().item() for x, y in pairs
            if not torch.equal(x, y)]
    return len(gaps), len(pairs), max(gaps, default=0.0)


def repro_runs(label, make_cfg, per_step, dev, out):
    """A recipe through ``semseg_torch.train.run`` in float32: twice
    uninterrupted (2 epochs of 2 steps), then stopped by the preemption
    hook after step 3 and resumed with ``resume auto``; every step launches
    ``per_step``. Returns the second run and the resumed one against the
    first (:func:`state_diff`), the runs' seconds, the first run's launches
    and peak memory, and cuDNN's (deterministic, benchmark) flags seen
    inside the runs."""
    from semseg_torch.train import run
    from semseg_torch.utils.misc import get_logger

    first, flags, counting = launches(), set(), [True]

    def hook(it, metrics):
        counts = read_counts()
        check_counts(f"{label} f32 driver step {it}", counts, launches(**per_step))
        if counting[0]:
            first.update({k: first[k] + v for k, v in counts.items()})
        flags.add((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark))
        if not np.isfinite(metrics["loss"].item()):
            raise AssertionError(f"{label} step {it}: loss {metrics['loss'].item()}")
        reset_counts()

    states, seconds, peak = {}, {}, None
    snap = out / "pre" / "train_preempt.pth"
    for name, save, keys, steps in (("a", "a", {}, 4), ("b", "b", {}, 4),
                                    ("pre", "pre", dict(_preempt_after_step=3), 3),
                                    ("resumed", "pre", dict(resume="auto"), 4)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = run(make_cfg(out / save, **keys), dev, logger=get_logger(), step_hook=hook)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        counting[0] = False
        peak = peak or torch.cuda.max_memory_allocated() / 2 ** 30
        if res["trainer"].step_count != steps or (name == "pre") != bool(res["preempt"]) or (
                name == "resumed" and snap.exists()):
            raise AssertionError(f"{label} run {name}: step {res['trainer'].step_count}, "
                                 f"preempt {res['preempt']}, snapshot {snap.exists()}")
        if name != "pre":
            states[name] = host_state(res["trainer"])
        del res
    return dict(ab=state_diff(states["a"], states["b"]),
                ra=state_diff(states["resumed"], states["a"]),
                seconds=seconds, counts=first, peak_gib=peak, flags=sorted(flags))


def allocator_blocks():
    """Address -> size of every block the caching allocator has handed out:
    what ``memory_allocated`` counts (a free block reused whole may be up
    to a MiB larger than the tensor put in it)."""
    return {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] == "active_allocated"}


def held_bytes(tensors, blocks):
    """The allocator's bytes behind ``tensors`` (each in a block of its own)."""
    return sum(blocks.get(t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
               for t in tensors)


def cache_state(ev, blocks=None):
    """The per-shape caches behind ``ev``: the entries of each (the
    evaluator's geometries, the two numpy resize matrices' ``lru_cache``,
    the tensor caches), and the device bytes of the blocks the tensor caches
    hold (``blocks``: :func:`allocator_blocks`)."""
    from semseg_torch.engine import evaluator
    from semseg_torch.ops import resize, stitch
    from semseg_torch.parallel import spatial

    fns = {"interp_matrix": resize.interp_matrix, "coverage": evaluator._coverage,
           "stitch_taps": stitch._taps, "stitch_tap_records": stitch._tap_records,
           "pool_matrix": spatial._pool_matrix}
    entries = {"geometries": len(ev._geometries),
               "numpy_half_pixel": resize._interp_matrix_half_pixel.cache_info().currsize,
               "numpy_align_corners": resize._interp_matrix.cache_info().currsize,
               **{k: len(fn.cache) for k, fn in fns.items()}}
    tensors = [t for fn in fns.values() for value in fn.cache.values()
               for t in (value if isinstance(value, tuple) else (value,)) if t.is_cuda]
    return entries, held_bytes(tensors, blocks or {})


def clear_caches():
    """Empty the per-shape caches of the resizes, the stitch and the
    evaluator."""
    from semseg_torch.engine import evaluator
    from semseg_torch.ops import resize, stitch
    from semseg_torch.parallel import spatial

    for fn in (resize.interp_matrix, evaluator._coverage, stitch._taps, stitch._tap_records,
               spatial._pool_matrix, resize._interp_matrix_half_pixel, resize._interp_matrix):
        fn.cache_clear()


def ade_test_driver(dev, root, model_path, smi, gate):
    """``semseg_torch.test.run`` of the ADE20K PSPNet50 recipe (float32,
    single scale, flip) with ``model_path`` over the ``ADE_EVAL`` images of
    distinct sizes, so that the driver picks ``device_bucketed``; after each
    image the allocated device memory and the caches' entries and bytes
    (:func:`cache_state`). Then the first image, its entries evicted,
    predicted again (its resize matrices rebuilt), and the last image
    through a fresh evaluator with every cache emptied, each against the
    driver's PNG. With ``gate``: every cache
    within ``CACHE_ENTRIES`` entries after every image and the resize
    matrices' cache full by the end, the memory beside the caches and the
    pending class maps within ``RESIDUAL_MIB``, both predictions bit for
    bit, no kernel launched. Returns the launches and the readings."""
    import cv2

    from semseg_torch import test as ttest
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.train import parse_args
    from semseg_torch.utils import misc

    bound = getattr(misc, "CACHE_ENTRIES", None)  # None: a checkout without the bound
    save = OUT_DIR / "repro" / "ade_test"
    cfg = parse_args(["--config", "config/ade20k/ade20k_pspnet50.yaml",
                      "data_root", str(root), "test_list", str(root / "eval.txt"),
                      "model_path", str(model_path), "save_folder", str(save),
                      "test_gpu", "[0]"])
    trace, refs, seen = [], [], {}
    original = SlidingWindowEvaluator.predict_async

    def recording(self, image):
        lazy = original(self, image)
        seen["ev"] = self
        refs.append(weakref.ref(lazy))
        blocks = allocator_blocks()
        pending = held_bytes([t for t in (r() for r in refs) if t is not None], blocks)
        entries, held = cache_state(self, blocks)
        allocated = sum(blocks.values())
        trace.append(dict(hw=tuple(image.shape[:2]), allocated=allocated, held=held,
                          residual=allocated - held - pending, entries=entries))
        return lazy

    clear_caches()
    reset_counts()
    SlidingWindowEvaluator.predict_async = recording
    try:
        t0 = time.perf_counter()
        result = ttest.run(cfg, device=dev, logger=misc.get_logger())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        SlidingWindowEvaluator.predict_async = original
    counts = read_counts()
    ev = seen["ev"]
    mib = 2 ** 20
    for k, t in enumerate(trace):
        log(f"[27 caches] image {k + 1} {t['hw'][0]}x{t['hw'][1]}: allocated "
            f"{t['allocated'] / mib:.2f} MiB, caches {t['held'] / mib:.2f} MiB, beside them "
            f"{t['residual'] / mib:.2f} MiB; entries {t['entries']}")
    lines = (root / "eval.txt").read_text().splitlines()

    def image(k):
        return cv2.cvtColor(cv2.imread(str(root / lines[k].split()[0])), cv2.COLOR_BGR2RGB)

    def gray(k):
        return cv2.imread(str(save / "gray" / f"{Path(lines[k].split()[0]).stem}.png"),
                          cv2.IMREAD_GRAYSCALE)

    from semseg_torch.engine.evaluator import _scaled_size
    from semseg_torch.ops.resize import interp_matrix

    h0, w0 = image(0).shape[:2]
    new_h, new_w = _scaled_size(h0, w0, 1.0, cfg.base_size)
    evicted = not any((a, b, True, ev.device) in interp_matrix.cache
                      for a, b in ((h0, new_h), (w0, new_w), (new_h, h0), (new_w, w0)))
    again = np.array_equal(ev.predict(image(0)), gray(0))
    clear_caches()
    fresh = ttest.make_evaluator(cfg, ev.model, dev, ev.mode)
    last = np.array_equal(fresh.predict(image(ADE_EVAL - 1)), gray(ADE_EVAL - 1))
    residuals = [t["residual"] for t in trace]
    spread = (max(residuals) - min(residuals)) / mib
    most = {k: max(t["entries"][k] for t in trace) for k in trace[0]["entries"]}
    full_at = next((k + 1 for k, t in enumerate(trace)
                    if bound and t["entries"]["interp_matrix"] >= bound), None)
    log(f"[27 caches] test driver, ADE20K PSPNet50 f32, {result['images']} images of distinct "
        f"sizes, mode {ev.mode}: {seconds:.2f} s, mIoU/mAcc/allAcc "
        f"{[round(v, 4) for v in result['metrics']]}; allocated {trace[0]['allocated'] / mib:.2f}"
        f" -> {trace[-1]['allocated'] / mib:.2f} MiB, caches {trace[0]['held'] / mib:.2f} -> "
        f"{trace[-1]['held'] / mib:.2f} MiB (most {max(t['held'] for t in trace) / mib:.2f}), "
        f"beside them within {spread:.3f} MiB; most entries {most} (bound {bound}; the resize "
        f"matrices' cache full at image {full_at}); image 1 evicted {evicted}, predicted again "
        f"bit for bit {again}; image {ADE_EVAL} through a fresh evaluator bit for bit {last}; "
        f"launches {counts}; on {smi}")
    ok = (ev.mode == "device_bucketed" and result["images"] == ADE_EVAL
          and all(np.isfinite(result["metrics"])) and again and last)
    if gate and not (ok and evicted and full_at is not None and spread <= RESIDUAL_MIB
                     and all(v <= bound for v in most.values())):
        raise AssertionError("ADE20K test driver: the caches or the predictions fail the "
                             "gates (the lines above)")
    check_counts("ADE20K f32 test driver", counts, launches())
    del ev, fresh
    torch.cuda.empty_cache()
    return counts, dict(seconds=seconds, spread_mib=spread, most=most, full_at=full_at,
                        mib=[t["allocated"] / mib for t in trace])


def served(label, config, dev, images, psa, **keys):
    """``build_evaluator`` of ``config`` (bf16, random weights of seed 0,
    ``window_batch`` 8) over ``images``, one warm-up request first: each
    request launches the stitch kernel once a chunk and, with ``psa``, the
    bf16 tensor-core forward twice a chunk, as the evaluator's geometry of
    the image gives them. Returns the evaluator, the launches, the windows
    and images/s."""
    from semseg_torch.serve import build_evaluator
    from semseg_torch.train import parse_args
    from semseg_torch.utils.misc import get_logger

    cfg = parse_args(["--config", config])
    cfg.update(dict(allow_random_weights=True, window_batch=8, model_path="", **keys))
    ev = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=dev, seed=0)
    if not ev.fused_stitch:
        raise AssertionError(f"{label}: the bf16 CUDA evaluator did not pick the fused kernel")
    ev.predict(images[0])
    torch.cuda.synchronize()
    total, windows, seconds = launches(), 0, 0.0
    for k, img in enumerate(images):
        h, w = img.shape[:2]
        chunks = sum(len(ev._geometry(h, w, s).chunks) for s in ev.scales)
        windows += sum(sum(ev._geometry(h, w, s).n_real) for s in ev.scales)
        reset_counts()
        t0 = time.perf_counter()
        pred = ev.predict(img)
        seconds += time.perf_counter() - t0
        counts = read_counts()
        check_counts(f"{label} image {k} {h}x{w}", counts, launches(
            upsample_softmax_flip=chunks, psa_softmax_bmm_wgmma=2 * chunks if psa else 0))
        if pred.shape != (h, w) or pred.dtype != np.uint8 or pred.max() >= cfg.classes:
            raise AssertionError(f"{label}: bad class map {pred.shape} {pred.dtype}")
        total = {n: total[n] + v for n, v in counts.items()}
    return ev, cfg, total, windows, len(images) / seconds


def phase_repro(dev, smi, gate=True):
    """Phase 27. (a) Float32 training through ``semseg_torch.train.run``,
    twice uninterrupted and once preempted after step 3 and resumed
    (:func:`repro_runs`): the ADE20K PSPNet50 recipe on ``ADE_TRAIN``
    ADE20K-like images of distinct sizes (no kernel launched), and the
    Cityscapes PSANet50 recipe at batch 8 on 16 of phase 13's street images
    (the 3xTF32 forward, da and dx twice a step); with ``gate``, all three
    runs bit for bit. (b) The ADE20K test driver with the first run's
    checkpoint and the per-shape caches (:func:`ade_test_driver`). (c) bf16
    ADE20K PSANet50 (465 windows, hw 900) over the same images with exact
    launches, fused against unfused stitch at 150 classes at the bars of
    phase 6; one VOC2012 PSPNet50 request (21 classes). Returns the
    launches by path and the readings. ``chip_probes/repro_smoke.py`` runs
    it ungated on another checkout."""
    import cv2

    phase_t0 = time.perf_counter()
    out = OUT_DIR / "repro"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    ade = write_ade_dataset()
    street = Path("build") / "chip_smoke_data"
    if not (street / "train.txt").is_file():
        write_dataset(street)
    lines = (street / "train.txt").read_text().splitlines()
    (street / "repro16.txt").write_text("\n".join(lines[:16]) + "\n")
    log(f"[27 repro] wrote {ADE_TRAIN} ADE20K-like images of distinct sizes, long side "
        f"256-2048, in {time.perf_counter() - t0:.1f} s")

    by_path, readings, failed = {}, {}, []
    recipes = (
        ("ADE20K PSPNet50", "ade_pspnet50_f32_driver", {}, lambda save, **k: recipe_cfg(
            "config/ade20k/ade20k_pspnet50.yaml", ade, ade / "train.txt", save, 16, **k)),
        ("Cityscapes PSANet50", "psanet50_f32_driver", F32_TRAIN_STEP, lambda save, **k:
            recipe_cfg("config/cityscapes/cityscapes_psanet50.yaml", street,
                       street / "repro16.txt", save, 8, **k)))
    for label, path, per_step, make in recipes:
        r = repro_runs(label, make, per_step, dev, out / path)
        by_path[path], readings[label] = r["counts"], r
        cfg = make(out)
        log(f"[27 repro] {label} f32 {cfg.train_h}x{cfg.train_w} batch {cfg.batch_size}, "
            f"{cfg.classes} classes, through run(), 2 epochs x 2 steps: seconds "
            f"{ {k: round(v, 2) for k, v in r['seconds'].items()} }, peak {r['peak_gib']:.2f} "
            f"GiB; (cudnn.deterministic, benchmark) inside {r['flags']}; second run vs first: "
            f"{r['ab'][0]} of {r['ab'][1]} entries differ, max abs {r['ab'][2]:.3e}; resumed vs "
            f"first: {r['ra'][0]} of {r['ra'][1]}, max abs {r['ra'][2]:.3e}; launches over the "
            f"first run {r['counts']}; on {smi}")
        if r["ab"][0] or r["ra"][0]:
            failed.append(label)
        if path != "ade_pspnet50_f32_driver":
            shutil.rmtree(out / path, ignore_errors=True)
    for name in ("b", "pre"):  # keep the first run's checkpoints for (b)
        shutil.rmtree(out / "ade_pspnet50_f32_driver" / name, ignore_errors=True)

    counts, readings["caches"] = ade_test_driver(
        dev, ade, out / "ade_pspnet50_f32_driver" / "a" / "train_epoch_2.pth", smi, gate)
    by_path["ade_pspnet50_test_driver"] = counts
    shutil.rmtree(out, ignore_errors=True)

    names = (ade / "eval.txt").read_text().splitlines()
    images = [cv2.cvtColor(cv2.imread(str(ade / ln.split()[0])), cv2.COLOR_BGR2RGB)
              for ln in names]
    ev, cfg, counts, windows, rate = served("ADE20K PSANet50", "config/ade20k/ade20k_psanet50.yaml",
                                            dev, images, True)
    by_path["ade_psanet50_serving"] = counts
    log(f"[27 serving] ADE20K PSANet50 bf16 {cfg.test_h}x{cfg.test_w} windows, base "
        f"{cfg.base_size}, 150 classes, flip: {len(images)} requests of distinct sizes, "
        f"{windows} windows, {rate:.3f} images/s; launches {counts}; on {smi}")
    phase_stitch_vs_plain(dev, ev, images[0], cfg, 27, "ADE20K PSANet50 150 classes")
    del ev
    voc = ade_sample(900, 375, 500)[0]
    ev, cfg, counts, windows, rate = served("VOC2012 PSPNet50",
                                            "config/voc2012/voc2012_pspnet50.yaml", dev, [voc],
                                            False)
    by_path["voc_pspnet50_serving"] = counts
    log(f"[27 serving] VOC2012 PSPNet50 bf16, 21 classes, one 375x500 request: {windows} "
        f"windows, launches {counts}")
    del ev
    torch.cuda.empty_cache()
    readings["seconds"] = time.perf_counter() - phase_t0
    log(f"[27 repro] phase {readings['seconds']:.1f} s on {smi}")
    if gate and failed:
        raise AssertionError(f"float32 runs through run() not bit for bit: {failed} (the lines "
                             "above)")
    return by_path, readings


def main():
    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from semseg_torch.ops import psa, stitch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    phase_build()
    stitch_k = phase_stitch_kernel(dev)
    psa_k = phase_psa_kernels(dev)
    bwd_k = phase_psa_backward(dev)
    images = [street_image(seed) for seed in range(N_TIMED)]

    ev, psp_counts, _ = phase_slice(5, "PSPNet50", pspnet_cfg(), dev, images,
                                    launches(upsample_softmax_flip=2))
    phase_stitch_vs_plain(dev, ev, images[0])
    phase_f32(7, "PSPNet50", pspnet_cfg(), dev, ev, images[1], launches())
    del ev
    torch.cuda.empty_cache()

    ev, psa_counts, _ = phase_slice(8, "PSANet50", psanet_cfg(), dev, images, launches(
        upsample_softmax_flip=2, psa_softmax_bmm_wgmma=4))
    phase_psa_vs_plain(ev, images[0])
    shrink1_counts = phase_shrink1(dev, images[2])
    phase_f32(11, "PSANet50", psanet_cfg(), dev, ev, images[1],
              launches(psa_softmax_bmm_tf32x3=2))
    del ev
    torch.cuda.empty_cache()

    cfg, res, train_counts, batch, notes = phase_train_slice(dev)
    timing = phase_train_timing(cfg, res, dev, batch)
    del res
    torch.cuda.empty_cache()
    psp_train_counts = phase_pspnet_train(dev)
    f32_counts = phase_grad_vs_plain(16, dev, 2, F32_TRAIN_STEP)
    f32_timing = phase_f32_train_timing(dev)
    shrink1_train_counts = phase_grad_vs_plain(17, dev, 1, SHRINK1_TRAIN_STEP, timed=3)
    phase_psa_module_f32(dev)
    ms_rates, ms_counts = phase_multiscale(dev, images, smi)
    train_paths, test_paths = phase_drivers(dev, Path("build") / "chip_smoke_data", smi)
    ddp_paths = phase_ddp(dev, Path("build") / "chip_smoke_data", smi, timing["images_per_s"])
    export_paths = phase_export(dev, images, smi)
    partition_paths = phase_partitions(dev, images, smi)
    tp_paths, _, _ = phase_tp(dev, Path("build") / "chip_smoke_data", smi,
                              timing["images_per_s"])
    conv_paths, _, _, conv_lines = phase_convergence(dev, smi)
    r101_paths, r101 = phase_r101(dev, Path("build") / "chip_smoke_data", images, smi)
    repro_paths, repro = phase_repro(dev, smi)

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "semseg_tpu"))
    if loaded:
        raise AssertionError(f"jax or JAX-package modules were imported: {loaded}")
    log(f"[summary] no jax and no semseg_tpu module loaded; "
        f"train {batch}: {timing['images_per_s']:.3f} images/s, {timing['peak_gib']:.2f} GiB; "
        f"f32 train 8: {f32_timing['images_per_s']:.3f} images/s, {f32_timing['peak_gib']:.2f} GiB; "
        f"multi-scale serving: PSPNet50 {ms_rates['PSPNet50']:.4f}, PSANet50 "
        f"{ms_rates['PSANet50']:.4f} images/s; convergence gaps (points, f32 - bf16) "
        + ", ".join(f"{c['arch']} {c['gap_points']}" for c in conv_lines)
        + f"; PSANet101 f32 batch 8 s/step remat / none "
        f"{r101['f32_b8'][True]['step_s']:.4f} / {r101['f32_b8'][False]['step_s']:.4f}, peak "
        f"{r101['f32_b8'][True]['peak_gib']:.2f} / {r101['f32_b8'][False]['peak_gib']:.2f} GiB; "
        f"batch 16 remat {r101['f32_b16_remat']['peak_gib']:.2f} GiB; serving PSPNet101 "
        f"{r101['PSPNet101_images_per_s']:.4f}, PSANet101 {r101['PSANet101_images_per_s']:.4f} "
        f"images/s; phase 26 {r101['seconds']:.1f} s; phase 27 {repro['seconds']:.1f} s, "
        f"ADE20K PSPNet50 f32 batch 16 peak {repro['ADE20K PSPNet50']['peak_gib']:.2f} GiB; "
        f"the script "
        f"{time.perf_counter() - script_t0:.1f} s; on {smi}"
        + (f"; {'; '.join(notes)}" if notes else ""))

    by_path = {"pspnet_slice": psp_counts, "psanet_slice": psa_counts,
               "psanet_shrink1_window": shrink1_counts, "psanet_train_slice": train_counts,
               "pspnet_train_steps": psp_train_counts, "psanet_f32_train_step": f32_counts,
               "psanet_shrink1_train_step": shrink1_train_counts,
               "pspnet_multiscale": ms_counts["PSPNet50"],
               "psanet_multiscale": ms_counts["PSANet50"], **train_paths, **test_paths,
               **ddp_paths, **export_paths, **partition_paths, **tp_paths, **conv_paths,
               **r101_paths, **repro_paths}
    city = stitch_k["psanet-cityscapes"]
    fwd16 = psa_k[("cityscapes-705", "bf16")]
    fwd32 = psa_k[("cityscapes-705", "f32")]
    flash = psa_k[("shrink1-705", "f32")]
    bwd16 = bwd_k[("cityscapes-705", "bf16")]
    bwd32 = bwd_k[("cityscapes-705", "f32")]
    fbwd = bwd_k[("shrink1-705", "f32")]
    # stitch [4,2,19,89,89] bf16 -> [4,19,705,705] bf16: bytes in and out;
    # per output about 20 f32 operations (two bilinear taps of 3 lerps, exp,
    # sums, the flip average).
    stitch_bound = bound(4 * 2 * 19 * 89 * 89 * 2 + 4 * 19 * 705 * 705 * 2,
                         20 * 4 * 19 * 705 * 705, torch.float32, products=False)
    f32 = torch.float32
    # The flash backward at (1, 512, 7921) f32: reads x, A, g, out, m, l,
    # writes da and dx; da's and dx's products, 4 N C hw^2.
    flash_bwd_bound = bound(2 * 7921 ** 2 * 4 + 4 * 512 * 7921 * 4, 4 * 512 * 7921 ** 2, f32)
    # (name, source, TPU kernel, launches on the path it serves, error, ms,
    # plain ms, bound): each at the shape and dtype of its main path. The
    # flash forward's and backward's rows are their routes, which count their
    # own calls.
    records = [
        ("upsample_softmax_flip", "semseg_torch/csrc/stitch.cu",
         "semseg_tpu/ops/stitch_pallas.py:131", psa_counts, city["max_abs_err"],
         city["ms"], city["plain_ms"], stitch_bound),
        ("psa_softmax_bmm_wgmma", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:48", psa_counts, fwd16["err_r"], fwd16["ms_r"],
         fwd16["plain_ms"], fwd16["bound"]),
        ("psa_softmax_bmm_tf32x3", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:48", f32_counts, fwd32["err_r"], fwd32["ms_r"],
         fwd32["plain_ms"], fwd32["bound"]),
        ("psa_softmax_bmm_flash", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:303", shrink1_counts, flash["err_f"],
         flash["ms_f"], flash["plain_ms"], psa_fwd_bound(1, 512, 7921, f32)),
        ("psa_softmax_bmm_bwd_da_wgmma", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:125", train_counts, bwd16["errs"]["da"],
         bwd16["ms_da"], bwd16["plain_da"], bwd16["da_bound"]),
        ("psa_softmax_bmm_bwd_da_tf32x3", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:125", f32_counts, bwd32["errs"]["da"],
         bwd32["ms_da"], bwd32["plain_da"], bwd32["da_bound"]),
        ("psa_softmax_bmm_bwd_dx_wgmma", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:140", train_counts, bwd16["errs"]["dx"],
         bwd16["ms_dx"], bwd16["plain_dx"], bwd16["dx_bound"]),
        ("psa_softmax_bmm_bwd_dx_tf32x3", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:140", f32_counts, bwd32["errs"]["dx"],
         bwd32["ms_dx"], bwd32["plain_dx"], bwd32["dx_bound"]),
        ("psa_softmax_bmm_flash_bwd", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:383", shrink1_train_counts,
         max(fbwd["errs"]["route_da"], fbwd["errs"]["route_dx"]), fbwd["ms_f"],
         fbwd["plain_da"] + fbwd["plain_dx"], flash_bwd_bound),
    ]
    missing = [k for k, *_, counts, _e, _m, _p, _b in records if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")
    # No single PyTorch call computes any of these functions (each fuses a
    # softmax, or an upsample and a softmax, with a product): library_ms null.
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": rep,
        "launches": counts[k], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
        "launches_by_path": {p: c[k] for p, c in by_path.items()},
    } for k, src, rep, counts, err, ms, plain_ms, bnd in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
