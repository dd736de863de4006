"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's serving path once at full width: PSPNet50 (19 classes,
bf16, seeded random weights) answering sliding-window requests on
Cityscapes-size 1024x2048 images, 713x713 windows with flip TTA and
``window_batch`` 8, the fused CUDA stitch kernel built from
``semseg_torch/csrc`` on first use. Phases, one line each:

1. device: the card's name and power limit; TF32 off;
2. build: compile the kernel library, print the seconds it took;
3. kernel vs plain: the stitch kernel against its plain PyTorch version
   on the card at the Cityscapes and ADE20K shapes (max abs diff and row
   sums within 2e-2), with both times (CUDA events, median of 20);
4. slice: ``semseg_torch.serve.build_evaluator`` answers requests; each
   request must launch the stitch kernel exactly twice (two chunks);
   images/s over the timed requests;
5. fused vs plain: one image through the unfused path; argmax agreement
   >= 0.995 and probabilities within 2e-2 (random weights give diffuse
   probabilities, so the share of near-tied pixels is printed beside it);
6. f32: one 713x713 window's float32 logits on the card and on the CPU
   from the same weights, max relative error <= 1e-3 (catches TF32).

Any failure raises (non-zero exit). The line before the last is the
kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""

import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

TOL = 2e-2  # bf16 output rounding at two places + expf ulps
N_TIMED = 8  # timed requests in phase 4


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


def street_image(seed, h=1024, w=2048):
    """A seeded street-like uint8 RGB image: sky band, buildings of
    random widths and colours, road with lane marks, pixel noise."""
    rs = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.float32)
    yy = np.arange(h, dtype=np.float32)[:, None]
    horizon, road = int(h * rs.uniform(0.3, 0.4)), int(h * rs.uniform(0.6, 0.7))
    img[:horizon] = np.array([120, 170, 230]) + (yy[:horizon, :, None] / h) * 40
    x = 0
    while x < w:
        bw = rs.randint(60, 300)
        img[horizon:road, x:x + bw] = rs.randint(40, 200, 3)
        x += bw
    img[road:] = [85, 85, 90]
    for lane in range(rs.randint(2, 5)):
        x0 = rs.randint(0, w - 40)
        img[road + 20:, x0:x0 + 12] = [230, 230, 230]
    img += rs.randint(-8, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


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


def phase_build():
    from semseg_torch.ops._build import build_library

    b = build_library("stitch")
    regs = [ln.strip() for ln in b.log.splitlines() if "registers" in ln]
    log(f"[2 build] {b.path.name}: {b.seconds:.2f} s (built={b.built}) {regs}")


def phase_kernel(dev):
    from semseg_torch.ops.stitch import (
        upsample_softmax_flip,
        upsample_softmax_flip_reference,
    )

    results = {}
    for label, (p, c, hs, out) in (("cityscapes", (4, 19, 90, 713)),
                                   ("ade20k", (4, 150, 60, 473))):
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
        log(f"[3 kernel] {label} [{p},2,{c},{hs},{hs}]->{out}^2 bf16: "
            f"max_abs_err {err:.3e}, row_sum_err {rows:.3e}, kernel {ms:.4f} ms "
            f"({out_gb / ms * 1e3:.1f} GB/s written), plain {plain_ms:.4f} ms")
        results[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del lp, got, want
    return results


def serving_cfg():
    return SimpleNamespace(
        arch="psp", layers=50, classes=19, zoom_factor=8,
        train_h=713, train_w=713, test_h=713, test_w=713,
        base_size=2048, scales=[1.0], model_path="",
        allow_random_weights=True, window_batch=8, eval_pipeline="device",
    )


def phase_slice(dev, images):
    from semseg_torch.ops.stitch import upsample_softmax_flip
    from semseg_torch.serve import build_evaluator
    from semseg_torch.utils.misc import get_logger

    ev = build_evaluator(serving_cfg(), get_logger(), dtype=torch.bfloat16,
                         device=dev, seed=0)
    if not ev.fused_stitch:
        raise AssertionError("the bf16 CUDA evaluator did not pick the fused kernel")
    for img in images[:2]:  # warm-up (cuDNN heuristics, allocator)
        ev.predict(img)
    torch.cuda.synchronize()

    image_hw = images[0].shape[:2]
    upsample_softmax_flip.launches = 0
    t0 = time.perf_counter()
    preds = [ev.predict(img) for img in images]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = upsample_softmax_flip.launches

    for pred in preds:
        if pred.shape != image_hw or pred.dtype != np.uint8:
            raise AssertionError(f"bad class map {pred.shape} {pred.dtype}")
        if pred.max() >= 19:
            raise AssertionError(f"class id {pred.max()} out of range")
    if launches != 2 * len(images):
        raise AssertionError(f"stitch launches {launches} != 2 x {len(images)} images")
    hist = np.bincount(np.concatenate([p.ravel() for p in preds]), minlength=19)
    log(f"[4 slice] PSPNet50 bf16 1024x2048, 8 windows x flip, window_batch 8: "
        f"{len(images)} requests in {seconds:.3f} s = {len(images) / seconds:.3f} images/s; "
        f"stitch launches {launches} (2 per image); classes used {int((hist > 0).sum())}")
    return ev, launches


def phase_fused_vs_plain(dev, ev, image):
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    cfg = serving_cfg()
    plain = SlidingWindowEvaluator(
        ev.model, classes=cfg.classes, crop_h=cfg.test_h, crop_w=cfg.test_w,
        mean=IMAGENET_MEAN, std=IMAGENET_STD, base_size=cfg.base_size,
        scales=cfg.scales, window_batch=cfg.window_batch, fused_stitch=False,
        device=dev)
    pf = ev.predict_probs(image)
    pp = plain.predict_probs(image)
    if not (np.isfinite(pf).all() and np.isfinite(pp).all()):
        raise AssertionError("non-finite probabilities")
    sums = np.abs(pf.sum(-1) - 1).max()
    err = np.abs(pf - pp).max()
    agree = (pf.argmax(-1) == pp.argmax(-1)).mean()
    same_pred = (ev.predict(image) == pf.argmax(-1)).mean()
    if not (err <= TOL and agree >= 0.995 and sums <= TOL and same_pred == 1.0):
        raise AssertionError(f"fused vs plain: max abs {err}, agreement {agree}, "
                             f"row sums off by {sums}, predict vs probs {same_pred}")
    top2 = np.partition(pp, -2, axis=-1)[..., -2:]
    near_tie = ((top2[..., 1] - top2[..., 0]) < 2 * TOL).mean()
    log(f"[5 fused vs plain] max abs diff {err:.3e}, argmax agreement {agree:.6f}, "
        f"row sums within {sums:.3e}; pixels with a top-2 margin under {2 * TOL} "
        f"(where a flip is allowed): {near_tie:.4f}")


def phase_f32(dev, ev, image):
    from semseg_torch.models.build import build_model
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    model = build_model(serving_cfg(), dtype=torch.float32, device=dev)
    model.load_state_dict(ev.model.state_dict(), strict=True)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for a float32 model")
    win = torch.from_numpy(image[:713, :713].copy()).permute(2, 0, 1)[None].float()
    win = (win - torch.tensor(IMAGENET_MEAN).view(3, 1, 1)) / torch.tensor(
        IMAGENET_STD).view(3, 1, 1)
    win = win.to(dev)
    with torch.inference_mode():
        gpu = model(win).cpu()
        model_cpu = model.to("cpu")
        t0 = time.perf_counter()
        cpu = model_cpu(win.cpu())
        cpu_s = time.perf_counter() - t0
    rel = ((gpu - cpu).abs().max() / cpu.abs().max()).item()
    if not rel <= 1e-3:
        raise AssertionError(f"f32 GPU vs CPU max relative error {rel}")
    log(f"[6 f32] 713x713 window logits GPU vs CPU: max|diff|/max|cpu| = {rel:.3e} "
        f"(CPU forward {cpu_s:.1f} s)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from semseg_torch.ops import stitch  # noqa: F401  (fails outside the repo)

    dev = torch.device("cuda", 0)
    name = phase_device()
    phase_build()
    kern = phase_kernel(dev)
    images = [street_image(seed) for seed in range(N_TIMED)]
    ev, launches = phase_slice(dev, images)
    phase_fused_vs_plain(dev, ev, images[0])
    phase_f32(dev, ev, images[1])
    city = kern["cityscapes"]
    print(json.dumps({"kernels": [{
        "name": "upsample_softmax_flip", "route": "cuda",
        "source": "semseg_torch/csrc/stitch.cu",
        "replaces": "semseg_tpu/ops/stitch_pallas.py:131",
        "launches": launches, "max_abs_err": city["max_abs_err"],
        "ms": city["ms"], "plain_ms": city["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
