"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two serving paths once at full width, with seeded random
weights, on Cityscapes-size 1024x2048 images (single scale, flip TTA,
bf16, ``window_batch`` 8): PSPNet50 on 713x713 windows and PSANet50
(bi-direction, shrink 2, 89x89 mask) on 705x705 windows. The CUDA kernels
are built from ``semseg_torch/csrc`` on first use. Phases, one line each:

1. device: the card's name and power limit; TF32 off;
2. build: compile the kernel libraries in parallel (one nvcc each), print
   the seconds and each kernel's registers and spills;
3. stitch kernel vs plain on the card at the Cityscapes and ADE20K shapes
   (max abs diff and row sums within 2e-2), with both times (CUDA events,
   median of 20);
4. PSA kernels vs plain: the resident and the flash kernel against the
   plain softmax + bmm at (N, C, hw) = (8, 512, 900), (8, 512, 2025) and
   (1, 512, 7921), bf16 and f32 operands, A = randn * 3: max abs diff <=
   1e-4 * max|plain| + 1e-5; flash ``m`` exact and ``l`` within 1e-5
   relative; kernel and plain times;
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
   card against the plain version on the CPU, 1e-3 relative.

Every path is driven with all launch counts set to 0 just before it and
read just after. Any failure raises (non-zero exit). The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""

import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

TOL = 2e-2  # bf16 output rounding at two places + expf ulps
PSA_REL = 1e-4  # f32 sums over up to 7921 terms, in another order than cuBLAS
N_TIMED = 8  # timed requests per slice
PSA_EXTENTS = (("ade20k-465", 8, 512, 900), ("cityscapes-705", 8, 512, 2025),
               ("shrink1-705", 1, 512, 7921))


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
    from semseg_torch.ops.psa import psa_softmax_bmm, psa_softmax_bmm_flash
    from semseg_torch.ops.stitch import upsample_softmax_flip

    return {"upsample_softmax_flip": upsample_softmax_flip,
            "psa_softmax_bmm": psa_softmax_bmm,
            "psa_softmax_bmm_flash": psa_softmax_bmm_flash}


def reset_counts():
    for fn in kernels().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernels().items()}


def check_counts(label, got, want):
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected {want}")


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
    check_counts("plain attention", counts, {"upsample_softmax_flip": 2,
                                             "psa_softmax_bmm": 0,
                                             "psa_softmax_bmm_flash": 0})
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
        check_counts("shrink-1 window", counts, {"upsample_softmax_flip": 0,
                                                 "psa_softmax_bmm": 0,
                                                 "psa_softmax_bmm_flash": 2})
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
    images = [street_image(seed) for seed in range(N_TIMED)]

    no_psa = {"psa_softmax_bmm": 0, "psa_softmax_bmm_flash": 0}
    ev, psp_counts, _ = phase_slice(5, "PSPNet50", pspnet_cfg(), dev, images,
                                    {"upsample_softmax_flip": 2, **no_psa})
    phase_stitch_vs_plain(dev, ev, images[0])
    phase_f32(7, "PSPNet50", pspnet_cfg(), dev, ev, images[1],
              {"upsample_softmax_flip": 0, **no_psa})
    del ev
    torch.cuda.empty_cache()

    ev, psa_counts, _ = phase_slice(8, "PSANet50", psanet_cfg(), dev, images, {
        "upsample_softmax_flip": 2, "psa_softmax_bmm": 4, "psa_softmax_bmm_flash": 0})
    phase_psa_vs_plain(ev, images[0])
    shrink1_counts = phase_shrink1(dev, images[2])
    phase_f32(11, "PSANet50", psanet_cfg(), dev, ev, images[1], {
        "upsample_softmax_flip": 0, "psa_softmax_bmm": 2, "psa_softmax_bmm_flash": 0})

    by_path = {"pspnet_slice": psp_counts, "psanet_slice": psa_counts,
               "psanet_shrink1_window": shrink1_counts}
    city = stitch_k["psanet-cityscapes"]
    res = psa_k[("cityscapes-705", "bf16")]
    flash = psa_k[("shrink1-705", "f32")]
    records = [
        ("upsample_softmax_flip", "semseg_torch/csrc/stitch.cu",
         "semseg_tpu/ops/stitch_pallas.py:131", psa_counts, city["max_abs_err"],
         city["ms"], city["plain_ms"]),
        ("psa_softmax_bmm", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:48", psa_counts, res["err_r"], res["ms_r"],
         res["plain_ms"]),
        ("psa_softmax_bmm_flash", "semseg_torch/csrc/psa.cu",
         "semseg_tpu/ops/psa_pallas.py:303", shrink1_counts, flash["err_f"],
         flash["ms_f"], flash["plain_ms"]),
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
