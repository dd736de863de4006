"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's serving paths and its training path once at full width,
with seeded random weights, on Cityscapes-size 1024x2048 images: serving
(single scale, flip TTA, bf16, ``window_batch`` 8) with PSPNet50 on 713x713
windows and PSANet50 (bi-direction, shrink 2, 89x89 mask) on 705x705
windows; PSANet50 training (``config/cityscapes/cityscapes_psanet50.yaml``,
bf16, batch 16, 705x705 crops) through ``semseg_torch.train.run`` on a
seeded synthetic list-file dataset written under ``build/``. The CUDA
kernels are built from ``semseg_torch/csrc`` on first use. Phases, one line
each (12 runs after 4):

1. device: the card's name and power limit; TF32 off;
2. build: compile the kernel libraries in parallel (one nvcc each), print
   the seconds and each kernel's registers and spills;
3. stitch kernel vs plain on the card at the Cityscapes and ADE20K shapes
   (max abs diff and row sums within 2e-2), with both times (CUDA events,
   median of 20);
4. PSA forward kernels vs plain: the resident and the flash kernel against
   the plain softmax + bmm at (N, C, hw) = (8, 512, 900), (8, 512, 2025)
   and (1, 512, 7921), bf16 and f32 operands, A = randn * 3: max abs diff
   <= 1e-4 * max|plain| + 1e-5; ``m`` exact and ``l`` within 1e-5
   relative for both; kernel and plain times;
12. PSA backward kernels vs plain at the same extents: da, dx and the
   flash backward against the plain backward from the same statistics;
   f32 within 1e-4 * max|plain| + 1e-5, bf16 within one bf16 ulp of
   max|plain| against the plain grads rounded to bf16; kernel, plain and
   plain-autograd times;
5. PSPNet slice: ``build_evaluator`` answers requests; each must launch the
   stitch kernel exactly twice (two chunks) and no PSA kernel; images/s;
6. PSPNet fused vs plain stitch: argmax agreement >= 0.995, probabilities
   within 2e-2 (share of near-tied pixels printed beside);
7. PSPNet f32: one 713x713 window's logits on the card and on the CPU,
   max relative error <= 1e-3 (catches TF32);
8. PSANet slice: each request must launch the resident PSA kernel exactly
   4 times (2 chunks x 2 directions), the stitch kernel twice and the
   flash kernel never; images/s;
9. PSANet kernel vs plain attention: one image with ``fused_attention``
   off (both sides use the fused stitch): agreement >= 0.995,
   probabilities within 2e-2;
10. PSANet shrink 1 (f32, mask 177x177, hw 7921): one 705x705 window and
   its flip launch the flash kernel exactly twice; logits within 1e-3
   relative of the plain attention;
11. PSANet f32: one 705x705 window through the resident kernel on the
   card against the plain version on the CPU, 1e-3 relative;
13. PSANet50 training slice: 48 street-like 1024x2048 images with label
   PNGs, ``run`` with ``compute_dtype bfloat16``, ``batch_size 16`` (12 or
   8 if 16 does not fit), ``epochs 1``: every step launches the resident
   forward, da and dx twice each and nothing else; finite losses;
14. the train step alone on a device-resident batch (2 warm-up, 5 timed
   steps, the same launches per step): seconds per step, images/s, peak
   memory; the loader's images/s; a ``torch.profiler`` window of 2 steps
   (device busy, idle share, top kernels in ``build/chip_smoke/``);
15. PSPNet50 bf16, 3 train steps through the same Trainer: no PSA launch;
16. PSANet50 f32 train step, batch 2: kernels against plain attention,
   losses within 1e-5 relative and every parameter gradient within the
   relative bar of ``GRAD_REL``;
17. the same at shrink 1 (hw 7921): the flash forward and flash backward
   twice each; gradients against plain attention;
18. the PSA module at full width (2048 -> 512, 89x89 input, batch 2),
   f32, eval-mode BN: output and input gradient on the card against the
   CPU within 1e-3 relative, parameter gradients within ``PARAM_REL``; the
   same with TF32 on must fail those bars (else the check is blind to TF32).

Every path is driven with all launch counts set to 0 just before it and
read just after. Any failure raises (non-zero exit). The process imports
no jax: the config parser and data pipeline the training entry point
shares with the JAX package (``semseg_tpu.config``, ``semseg_tpu.data``)
are yaml, numpy and cv2 only, and that is checked at the end. The line before the last is the kernels' JSON record; the last line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""

import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

TOL = 2e-2  # bf16 output rounding at two places + expf ulps
PSA_REL = 1e-4  # f32 sums over up to 7921 terms, in another order than cuBLAS
N_TIMED = 8  # timed requests per slice
PSA_EXTENTS = (("ade20k-465", 8, 512, 900), ("cityscapes-705", 8, 512, 2025),
               ("shrink1-705", 1, 512, 7921))
# Phases 16-17: relative L2 distance of each parameter gradient, kernels
# against plain attention (f32 sums in another order, amplified through
# 50+ train-mode BN layers from a random init).
GRAD_REL = 1e-2  # measured at most 3.9e-3 (H100 80GB HBM3, 700 W)
# Phase 18: each PSA parameter gradient, GPU against CPU (the f32 noise
# floor behind the softmax VJP of a near-uniform attention, see there):
# at most 1.42e-2 with TF32 off and 5.57e-2 with it on, the same in each of
# three runs (H100 80GB HBM3, 700 W). The TF32-on run must fail the bar.
PARAM_REL = 3e-2
OUT_DIR = Path("build") / "chip_smoke"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernels():
    """The launch-counting wrappers of every kernel, by name."""
    from semseg_torch.ops import psa
    from semseg_torch.ops.stitch import upsample_softmax_flip

    return {"upsample_softmax_flip": upsample_softmax_flip,
            "psa_softmax_bmm": psa.psa_softmax_bmm,
            "psa_softmax_bmm_flash": psa.psa_softmax_bmm_flash,
            "psa_softmax_bmm_bwd_da": psa.psa_softmax_bmm_bwd_da,
            "psa_softmax_bmm_bwd_dx": psa.psa_softmax_bmm_bwd_dx,
            "psa_softmax_bmm_flash_bwd": psa.psa_softmax_bmm_flash_bwd}


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


def phase_device():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    if shutil.which("nvidia-smi"):
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        log(res.stdout.strip().splitlines()[0])
    else:
        log("nvidia-smi: absent")
    return name


def ptxas_summary(build_log):
    """``kernel<dtype>: R regs, S/L B spilled`` for each entry function of
    an nvcc ``-Xptxas -v`` log."""
    out, cur = [], None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            k = re.search(r"[a-z_]+_kernel", mangled)
            tags = [tag for pat, tag in (("13__nv_bfloat16", "bf16"), ("kernelIf", "f32"),
                                         ("Lb0E", "resident"), ("Lb1E", "flash"))
                    if pat in mangled]
            cur = {"name": (k.group(0) if k else mangled) + f"<{','.join(tags)}>"}
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


def phase_psa_kernels(dev):
    """Both PSA kernels against the plain version at the recipe extents."""
    from semseg_torch.ops.psa import (
        psa_softmax_bmm,
        psa_softmax_bmm_flash,
        psa_softmax_bmm_reference,
        psa_softmax_stats,
    )

    results = {}
    for label, n, c, hw in PSA_EXTENTS:
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn(n, c, hw, generator=g, device=dev).to(dt)
            a = (torch.randn(n, hw, hw, generator=g, device=dev) * 3).to(dt)
            with torch.inference_mode():
                want = psa_softmax_bmm_reference(x, a)
                m_ref, l_ref = psa_softmax_stats(a)
                res = psa_softmax_bmm(x, a)
                fl, m, l = psa_softmax_bmm_flash(x, a, return_stats=True)
                torch.cuda.synchronize()
                bar = PSA_REL * want.abs().max().item() + 1e-5
                err_r = (res - want).abs().max().item()
                err_f = (fl - want).abs().max().item()
                m_exact = torch.equal(m, m_ref)
                l_rel = ((l - l_ref).abs() / l_ref).max().item()
                if not (err_r <= bar and err_f <= bar and m_exact and l_rel <= 1e-5):
                    raise AssertionError(
                        f"psa {label} {dt}: resident err {err_r}, flash err {err_f} "
                        f"(bar {bar}), m exact {m_exact}, l rel {l_rel}")
                ms_r = cuda_ms(lambda: psa_softmax_bmm(x, a))
                ms_f = cuda_ms(lambda: psa_softmax_bmm_flash(x, a))
                plain_ms = cuda_ms(lambda: psa_softmax_bmm_reference(x, a))
            tflops = 2 * n * c * hw * hw / 1e9
            dname = "bf16" if dt == torch.bfloat16 else "f32"
            log(f"[4 psa kernels] {label} (N,C,hw)=({n},{c},{hw}) {dname}: bar {bar:.3e}; "
                f"resident err {err_r:.3e} {ms_r:.4f} ms ({tflops / ms_r:.1f} TFLOP/s); "
                f"flash err {err_f:.3e} {ms_f:.4f} ms ({tflops / ms_f:.1f} TFLOP/s), "
                f"m exact, l rel {l_rel:.2e}; plain {plain_ms:.4f} ms")
            results[(label, dname)] = dict(err_r=err_r, err_f=err_f, ms_r=ms_r,
                                           ms_f=ms_f, plain_ms=plain_ms)
            del x, a, want, res, fl, m, l, m_ref, l_ref
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


def phase_slice(tag, label, cfg, dev, images, per_image):
    from semseg_torch.serve import build_evaluator
    from semseg_torch.utils.misc import get_logger

    ev = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=dev, seed=0)
    if not ev.fused_stitch:
        raise AssertionError("the bf16 CUDA evaluator did not pick the fused kernel")
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


def phase_stitch_vs_plain(dev, ev, image):
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    cfg = pspnet_cfg()
    plain = SlidingWindowEvaluator(
        ev.model, classes=cfg.classes, crop_h=cfg.test_h, crop_w=cfg.test_w,
        mean=IMAGENET_MEAN, std=IMAGENET_STD, base_size=cfg.base_size,
        scales=cfg.scales, window_batch=cfg.window_batch, fused_stitch=False,
        device=dev)
    pf = ev.predict_probs(image)
    pp = plain.predict_probs(image)
    if (ev.predict(image) != pf.argmax(-1)).any():
        raise AssertionError("predict and predict_probs disagree")
    agreement(6, "PSPNet fused vs plain stitch", pf, pp)


def phase_psa_vs_plain(ev, image):
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
    agreement(9, "PSANet kernel vs plain attention", pf, pp)


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
    flip through the flash kernel, against the plain attention."""
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
        check_counts("shrink-1 window", counts, launches(psa_softmax_bmm_flash=2))
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


def phase_psa_backward(dev):
    """The three backward kernels against the plain backward at the recipe
    extents, from the kernels' own forward statistics (phase 12)."""
    from semseg_torch.ops import psa

    def bf16_ulp(v):
        return 2.0 ** (np.floor(np.log2(v)) - 7)

    results = {}
    for label, n, c, hw in PSA_EXTENTS:
        for dt in (torch.bfloat16, torch.float32):
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
                if dt == torch.float32:
                    want_dx, want_da = dx32, da32
                    bar_dx = PSA_REL * dx32.abs().max().item() + 1e-5
                    bar_da = PSA_REL * da32.abs().max().item() + 1e-5
                else:  # one bf16 ulp of max|plain|, against plain rounded to bf16
                    want_dx, want_da = dx32.to(dt).float(), da32.to(dt).float()
                    bar_dx = bf16_ulp(dx32.abs().max().item())
                    bar_da = bf16_ulp(da32.abs().max().item())
                errs = {"da": (da.float() - want_da).abs().max().item(),
                        "dx": (dx.float() - want_dx).abs().max().item(),
                        "flash_da": (fda.float() - want_da).abs().max().item(),
                        "flash_dx": (fdx.float() - want_dx).abs().max().item()}
                del dx32, da32, want_dx, want_da
                bars = {"da": bar_da, "dx": bar_dx, "flash_da": bar_da, "flash_dx": bar_dx}
                if any(errs[k] > bars[k] for k in errs):
                    raise AssertionError(f"psa backward {label} {dt}: errors {errs}, bars {bars}")
                if not (da.dtype == fda.dtype == dx.dtype == fdx.dtype == dt):
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
            dname = "bf16" if dt == torch.bfloat16 else "f32"
            log(f"[12 psa backward] {label} (N,C,hw)=({n},{c},{hw}) {dname}: errors "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (bars da {bar_da:.3e}, dx {bar_dx:.3e}); da {ms_da:.4f} ms "
                f"({gflop / ms_da:.1f} TFLOP/s), dx {ms_dx:.4f} ms ({gflop / ms_dx:.1f}), "
                f"flash bwd {ms_f:.4f} ms ({2 * gflop / ms_f:.1f}); plain da {plain_da:.4f}, "
                f"dx {plain_dx:.4f}, da+dx {plain_da + plain_dx:.4f} ms; autograd of the plain "
                f"forward {autograd_ms:.4f} ms")
            results[(label, dname)] = dict(errs=errs, ms_da=ms_da, ms_dx=ms_dx, ms_f=ms_f,
                                           plain_da=plain_da, plain_dx=plain_dx,
                                           autograd_ms=autograd_ms)
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


TRAIN_STEP = dict(psa_softmax_bmm=2, psa_softmax_bmm_bwd_da=2, psa_softmax_bmm_bwd_dx=2)


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
    return busy / 1e3, span / 1e3, 1.0 - busy / span, table


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

    busy, span, idle, table = device_profile(two_steps, OUT_DIR / "train_profile.txt")
    top = [ln for ln in table.splitlines()[3:11]]
    log(f"[14 train step] PSANet50 bf16 batch {batch} on a device-resident batch: "
        f"{step_s:.4f} s/step = {batch / step_s:.3f} images/s, peak {peak:.2f} GiB, "
        f"losses {[round(v, 4) for v in losses]}; loader alone {loader_rate:.3f} images/s "
        f"({loader_s:.2f} s for {len(loader) * batch} images, {cfg.workers} threads); "
        f"profile of 2 steps: device busy {busy:.2f} ms of {span:.2f} ms, idle share "
        f"{idle:.4f} (table in {OUT_DIR / 'train_profile.txt'})")
    for ln in top:
        log(f"[14 train step]   {ln.strip()[:150]}")
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
    pairs = [street_sample(s) for s in range(8)]
    images = torch.from_numpy(np.stack([p[0][:713, :713] for p in pairs])).to(dev)
    labels = torch.from_numpy(np.stack([p[1][:713, :713] for p in pairs])).to(dev)
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


def phase_grad_vs_plain(tag, dev, shrink, per_step):
    """PSANet50 f32 train step at batch 2: the kernels against plain
    attention, losses and every parameter gradient (phases 16-17)."""
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
        f"{counts}; kernel step {seconds:.2f} s (first call)")
    del model, grads_k, grads_p, state
    torch.cuda.empty_cache()
    return counts


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
            check_counts("PSA module", read_counts(), launches(**TRAIN_STEP))
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from semseg_torch.ops import psa, stitch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda", 0)
    name = phase_device()
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
        upsample_softmax_flip=2, psa_softmax_bmm=4))
    phase_psa_vs_plain(ev, images[0])
    shrink1_counts = phase_shrink1(dev, images[2])
    phase_f32(11, "PSANet50", psanet_cfg(), dev, ev, images[1], launches(psa_softmax_bmm=2))
    del ev
    torch.cuda.empty_cache()

    cfg, res, train_counts, batch, notes = phase_train_slice(dev)
    timing = phase_train_timing(cfg, res, dev, batch)
    del res
    torch.cuda.empty_cache()
    psp_train_counts = phase_pspnet_train(dev)
    f32_counts = phase_grad_vs_plain(16, dev, 2, TRAIN_STEP)
    shrink1_train_counts = phase_grad_vs_plain(
        17, dev, 1, dict(psa_softmax_bmm_flash=2, psa_softmax_bmm_flash_bwd=2))
    phase_psa_module_f32(dev)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if loaded:
        raise AssertionError(f"jax modules were imported: {loaded}")
    shared = sorted(m for m in sys.modules if m.split(".")[0] == "semseg_tpu")
    log(f"[summary] no jax module loaded; shared host modules: {shared}; "
        f"train {batch}: {timing['images_per_s']:.3f} images/s, {timing['peak_gib']:.2f} GiB"
        + (f"; {'; '.join(notes)}" if notes else ""))

    by_path = {"pspnet_slice": psp_counts, "psanet_slice": psa_counts,
               "psanet_shrink1_window": shrink1_counts, "psanet_train_slice": train_counts,
               "pspnet_train_steps": psp_train_counts, "psanet_f32_train_step": f32_counts,
               "psanet_shrink1_train_step": shrink1_train_counts}
    city = stitch_k["psanet-cityscapes"]
    res_fwd = psa_k[("cityscapes-705", "bf16")]
    flash = psa_k[("shrink1-705", "f32")]
    bwd = bwd_k[("cityscapes-705", "bf16")]
    fbwd = bwd_k[("shrink1-705", "f32")]
    records = [
        ("upsample_softmax_flip", "semseg_torch/csrc/stitch.cu",
         "semseg_tpu/ops/stitch_pallas.py:131", psa_counts, city["max_abs_err"],
         city["ms"], city["plain_ms"]),
        ("psa_softmax_bmm", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:48", psa_counts, res_fwd["err_r"], res_fwd["ms_r"],
         res_fwd["plain_ms"]),
        ("psa_softmax_bmm_flash", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:303", shrink1_counts, flash["err_f"],
         flash["ms_f"], flash["plain_ms"]),
        ("psa_softmax_bmm_bwd_da", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:125", train_counts, bwd["errs"]["da"], bwd["ms_da"],
         bwd["plain_da"]),
        ("psa_softmax_bmm_bwd_dx", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:140", train_counts, bwd["errs"]["dx"], bwd["ms_dx"],
         bwd["plain_dx"]),
        ("psa_softmax_bmm_flash_bwd", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:383", shrink1_train_counts,
         max(fbwd["errs"]["flash_da"], fbwd["errs"]["flash_dx"]), fbwd["ms_f"],
         fbwd["plain_da"] + fbwd["plain_dx"]),
    ]
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": rep,
        "launches": counts[k], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "launches_by_path": {p: c[k] for p, c in by_path.items()},
    } for k, src, rep, counts, err, ms, plain_ms in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
