"""bf16-vs-f32 convergence equivalence on structured synthetic data: the
port's counterpart of ``tool/convergence.py``.

The training recipe runs in bfloat16 (``compute_dtype: bfloat16``; for
PSANet the bf16 tensor-core PSA kernels), the reference in float32. This
tool produces the accuracy license for that: it trains the SAME model
(PSPNet50, or PSANet50 with ``--arch psa``) from the SAME float32 init on
the SAME synthetic dataset under both compute dtypes for ``STEPS`` steps,
and compares the held-out validation mIoU trajectories. Pass criterion,
the JAX tool's: a final val-mIoU gap under 1 point.

The dataset is procedurally generated segmentation with learnable but
non-trivial structure: class-tied base colors occluded by random
rectangles/ellipses/stripes, with per-pixel noise and per-image global
illumination jitter (``_paint`` and ``make_dataset`` are copies of the JAX
tool's, so both packages train on identical arrays).

The arms are coupled as the JAX tool's are, so that they differ only in
their arithmetic: one float32 init, built from ``seed`` and loaded into
both models; one batch-index stream, ``RandomState(seed + 1 +
stream_offset)``; and the same dropout masks, which ``Dropout2d`` draws in
float32 whatever the activation dtype from a generator seeded per step by
``dropout_seed(stream_offset, step)``. The float32 arm runs with TF32 off
(``models/layers.py::set_precision``). Both arms run with cuDNN's
deterministic algorithms, so that a run is reproducible, as the JAX tool's
is: with cuDNN's default choice on an H100, two float32 arms from one init
differ by an ulp in some weights after one step (the bfloat16 arms do not),
and 400 steps amplify that to about a point of final mIoU
(``chip_probes/convergence_determinism.py``).

    python -m semseg_torch.convergence [STEPS] [--arch psp|psa] [--seed S]

trains on the current CUDA device and raises without one; tests call
``run(..., device="cpu")``. Prints one JSON line per eval point (every
``EVAL_EVERY`` steps and at the end) and a final summary line with the JAX
tool's keys, plus ``device`` (the card's name and power limit, as
``nvidia-smi`` gives them) and ``seed``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

from semseg_torch.engine.optim import make_sgd
from semseg_torch.engine.trainer import Trainer, eval_step
from semseg_torch.models.build import COMPUTE_DTYPES, build_model
from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD
from semseg_torch.utils.metrics import summarize
from semseg_torch.utils.misc import deterministic_cudnn, resolve_device

CLASSES = 6
CROP = 97            # (97-1) % 8 == 0
BATCH = 8
N_TRAIN, N_VAL = 256, 64
BASE_LR, MOMENTUM, WD, AUX_W = 0.01, 0.9, 1e-4, 0.4
EVAL_EVERY = 50
POWER = 0.9
ZOOM = 8
IGNORE_LABEL = 255
NORMALIZE = (IMAGENET_MEAN, IMAGENET_STD)


def _paint(rs, h, w):
    """One (image, label) pair: background + 3-6 random shapes."""
    # class-tied base colors (spread over RGB space), noisy
    palette = np.array([
        [40, 40, 40], [200, 60, 60], [60, 200, 60], [60, 60, 200],
        [200, 200, 60], [160, 60, 200],
    ], np.float32)
    label = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(rs.randint(3, 7)):
        cls = rs.randint(1, CLASSES)
        kind = rs.randint(3)
        cy, cx = rs.randint(0, h), rs.randint(0, w)
        ry, rx = rs.randint(h // 8, h // 2), rs.randint(w // 8, w // 2)
        if kind == 0:      # rectangle
            m = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        elif kind == 1:    # ellipse
            m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        else:              # diagonal stripes
            period = rs.randint(8, 24)
            m = (((yy + xx) // period) % 2 == 0) & (np.abs(yy - cy) < ry) \
                & (np.abs(xx - cx) < rx)
        label[m] = cls
    image = palette[label]
    # global illumination jitter + per-pixel noise: forces context use
    image = image * rs.uniform(0.6, 1.4) + rs.uniform(-25, 25, 3)
    image = image + rs.randn(h, w, 3) * 20.0
    return np.clip(image, 0, 255).astype(np.float32), label


def make_dataset(seed, n):
    rs = np.random.RandomState(seed)
    images = np.empty((n, CROP, CROP, 3), np.float32)
    labels = np.empty((n, CROP, CROP), np.uint8)
    for i in range(n):
        images[i], labels[i] = _paint(rs, CROP, CROP)
    return images, labels


def model_cfg(arch: str = "psp"):
    """The model of one arm, as ``build_model`` reads it: PSPNet50, or
    PSANet50 (bi-direction, not compact, shrink 2, the full relative mask
    ``2*((CROP-1)//16+1)-1 = 13`` as the train driver derives it,
    normalization 1.0, softmax on: a 7x7 PSA feature, hw 49)."""
    if arch not in ("psp", "psa"):
        raise ValueError(f"arch must be psp or psa, got {arch!r}")
    cfg = SimpleNamespace(arch=arch, layers=50, classes=CLASSES, zoom_factor=ZOOM,
                          train_h=CROP, train_w=CROP)
    if arch == "psa":
        mask = 2 * ((CROP - 1) // (8 * 2) + 1) - 1
        cfg.__dict__.update(psa_type=2, compact=False, shrink_factor=2, mask_h=mask,
                            mask_w=mask, normalization_factor=1.0, psa_softmax=True)
    return cfg


def initial_state(arch: str = "psp", seed: int = 0, device=None) -> dict:
    """The float32 init both arms start from: the ``state_dict`` of the
    model built from ``seed`` (parameters are float32 in either dtype)."""
    return build_model(model_cfg(arch), dtype=torch.float32, device=resolve_device(device),
                       seed=seed, train=True).state_dict()


def build_arm(dtype_name: str, steps: int, *, arch: str = "psp", seed: int = 0,
              init_state=None, stream_offset: int = 0, device=None) -> Trainer:
    """The :class:`Trainer` of one arm, its model loaded with
    ``init_state`` (default: :func:`initial_state` of ``seed``): SGD with
    the 10x head group, poly LR over ``steps``, dropout stream
    ``stream_offset``, raw pixels normalised on the device."""
    if dtype_name not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype_name!r}")
    device = resolve_device(device)
    if init_state is None:
        init_state = initial_state(arch, seed, device)
    model = build_model(model_cfg(arch), dtype=COMPUTE_DTYPES[dtype_name], device=device,
                        seed=seed, train=True)
    model.load_state_dict(init_state, strict=True)
    return Trainer(model, make_sgd(model, BASE_LR, MOMENTUM, WD), classes=CLASSES,
                   ignore_label=IGNORE_LABEL, aux_weight=AUX_W, base_lr=BASE_LR,
                   max_iter=steps, power=POWER, zoom_factor=ZOOM, rng_seed=stream_offset,
                   normalize=NORMALIZE, num_replicas=1)


def val_miou(model, val_set) -> float:
    """Center-crop validation mIoU over ``val_set`` in batches of
    ``BATCH``: ``eval_step``'s histograms summed on the device, then
    ``summarize`` (the JAX tool's ``val_miou``). The model's mode is put
    back after."""
    images, labels = val_set
    training = model.training
    model.eval()
    try:
        acc = None
        for s in range(0, len(images), BATCH):
            m = eval_step(model, torch.from_numpy(images[s:s + BATCH]),
                          torch.from_numpy(labels[s:s + BATCH]), classes=CLASSES,
                          ignore_label=IGNORE_LABEL, zoom_factor=ZOOM, normalize=NORMALIZE)
            hist = [m[k] for k in ("intersection", "union", "target")]
            acc = hist if acc is None else [a + b for a, b in zip(acc, hist)]
    finally:
        model.train(training)
    return summarize(*(h.cpu().numpy() for h in acc))[0]


def run(dtype_name: str, steps: int, train_set, val_set, *, arch: str = "psp",
        seed: int = 0, init_state=None, stream_offset: int = 0, device=None,
        step_hook=None):
    """One training arm (the JAX tool's ``run``): ``steps`` steps at batch
    ``BATCH`` drawn from ``train_set`` by the index stream ``RandomState(
    seed + 1 + stream_offset)``, validated on ``val_set`` every
    ``EVAL_EVERY`` steps and at the end. ``init_state`` (a port
    ``state_dict``) replaces the init of ``seed``; ``stream_offset`` shifts
    the dropout and batch-index streams while keeping the init (0 is the
    JAX tool's default). ``step_hook(step, metrics)``, if given, runs after
    every step. Prints one JSON line per eval point and returns the
    trajectory ``[(step, val_mIoU), ...]``. cuDNN's deterministic
    algorithms are on while it trains (``utils.misc.deterministic_cudnn``)."""
    trainer = build_arm(dtype_name, steps, arch=arch, seed=seed, init_state=init_state,
                        stream_offset=stream_offset, device=device)
    tr_images, tr_labels = train_set
    rs = np.random.RandomState(seed + 1 + stream_offset)
    trajectory = []
    with deterministic_cudnn():
        t0 = time.perf_counter()
        for step in range(steps):
            idx = rs.randint(0, len(tr_images), BATCH)
            metrics = trainer.step(torch.from_numpy(tr_images[idx]),
                                   torch.from_numpy(tr_labels[idx]))
            if step_hook is not None:
                step_hook(step + 1, metrics)
            if (step + 1) % EVAL_EVERY == 0 or step + 1 == steps:
                miou = val_miou(trainer.module, val_set)
                trajectory.append((step + 1, miou))
                print(json.dumps({
                    "dtype": dtype_name, "step": step + 1,
                    "val_mIoU": round(miou, 4),
                    "loss": round(metrics["loss"].item(), 4),
                    "elapsed_s": round(time.perf_counter() - t0, 1),
                }), flush=True)
    return trajectory


def summary(arch: str, steps: int, seed: int, results: dict, device: str) -> dict:
    """The JAX tool's summary line of two arms' trajectories
    (``results["float32"]``, ``results["bfloat16"]``), with ``device`` and
    ``seed``."""
    f32 = results["float32"][-1][1]
    bf16 = results["bfloat16"][-1][1]
    return {
        "metric": "bf16_vs_f32_val_mIoU_gap",
        "arch": arch,
        "steps": steps,
        "f32_final": round(f32, 4),
        "bf16_final": round(bf16, 4),
        "gap_points": round((f32 - bf16) * 100, 2),
        "pass": abs(f32 - bf16) < 0.01,
        "f32_trajectory": [[s, round(m, 4)] for s, m in results["float32"]],
        "bf16_trajectory": [[s, round(m, 4)] for s, m in results["bfloat16"]],
        "device": device,
        "seed": seed,
    }


def device_line(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    if shutil.which("nvidia-smi") is None:
        return f"{torch.cuda.get_device_name(index)}, power limit not read (no nvidia-smi)"
    res = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="bf16-vs-f32 convergence on synthetic data")
    parser.add_argument("steps", nargs="?", type=int, default=400,
                        help="training steps per arm")
    parser.add_argument("--arch", choices=("psp", "psa"), default="psp",
                        help="PSPNet50 or PSANet50")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the init and of the batch-index stream")
    return parser.parse_args(argv)


def main(argv=None):
    """The float32 arm, then the bfloat16 arm, from one init, on the
    current CUDA device; then the summary line. Without a CUDA device it
    raises; ``run(..., device="cpu")`` trains on the CPU explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "semseg_torch.convergence needs a CUDA device and torch.cuda.is_available() "
            "is false; call run(..., device='cpu') to train on the CPU")
    args = parse_args(argv)
    device = torch.device("cuda", torch.cuda.current_device())
    train_set = make_dataset(0, N_TRAIN)
    val_set = make_dataset(1, N_VAL)
    init = initial_state(args.arch, args.seed, device)
    results = {}
    for dtype_name in ("float32", "bfloat16"):
        results[dtype_name] = run(dtype_name, args.steps, train_set, val_set, arch=args.arch,
                                  seed=args.seed, init_state=init, device=device)
    print(json.dumps(summary(args.arch, args.steps, args.seed, results,
                             device_line(device.index))))


if __name__ == "__main__":
    main()
