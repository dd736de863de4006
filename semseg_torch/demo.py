"""Single-image inference demo of the port: the counterpart of
``tool/demo.py``.

    python -m semseg_torch.demo --config config/cityscapes/cityscapes_psanet50.yaml \\
        --image street.png model_path exp/.../train_epoch_200.pth [KEY VALUE ...]

runs on ``cuda:{test_gpu[0]}`` and raises without CUDA; tests call
``run(cfg, device="cpu")``. Sliding-window inference of one image at the
config's ``scales`` (averaged over all of them, as ``tool/demo.py:10-13``
does; the reference demo keeps only the last), with the float32 model of
the test driver (``semseg_torch/test.py``), writes ``<stem>_gray.png`` and
``<stem>_color.png`` next to the image. ``allow_random_weights True`` runs
seeded random weights when ``model_path`` does not exist. ``eval_devices``
and ``eval_partition`` split the windows over several devices as in the
test driver (``eval_partition spatial``: each window's rows, the layout for
one large image).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def run(cfg, device=None, logger=None):
    """Predict ``cfg.image`` and write its PNGs; returns the uint8 class
    map. ``device=None`` is the CUDA device and raises without one."""
    import cv2

    from semseg_torch.models.build import build_model, validate_arch
    from semseg_torch.test import eval_devices, load_model, make_evaluator
    from semseg_torch.utils.misc import colorize, get_logger, resolve_device

    logger = logger or get_logger()
    validate_arch(cfg)
    device = resolve_device(device)
    devices = eval_devices(cfg, device)
    if devices is not None:
        device = devices[0]
    if os.path.exists(getattr(cfg, "model_path", None) or ""):
        model = load_model(cfg, device, logger)
    elif getattr(cfg, "allow_random_weights", None):
        logger.warning("=> no checkpoint; using RANDOM weights (smoke mode)")
        model = build_model(cfg, dtype=torch.float32, device=device)
    else:
        raise RuntimeError(f"=> no checkpoint found at '{getattr(cfg, 'model_path', None)}'")
    evaluator = make_evaluator(cfg, model, device,
                               getattr(cfg, "eval_pipeline", None) or "device", devices)

    bgr = cv2.imread(cfg.image, cv2.IMREAD_COLOR)
    if bgr is None:
        raise RuntimeError(f"failed to read image {cfg.image}")
    image = np.float32(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    logger.info(">>>>>>>>>>>>>>>> Start Prediction >>>>>>>>>>>>>>>>")
    gray = evaluator.predict(image)
    logger.info("<<<<<<<<<<<<<<<<< End Prediction <<<<<<<<<<<<<<<<<")

    colors = np.loadtxt(cfg.colors_path).astype("uint8")
    stem = os.path.splitext(cfg.image)[0]
    gray_path, color_path = stem + "_gray.png", stem + "_color.png"
    cv2.imwrite(gray_path, gray)
    colorize(gray, colors).save(color_path)
    logger.info("Result saved to %s and %s", gray_path, color_path)
    return gray


def parse_args(argv=None):
    """``--config PATH [--image PATH] [KEY VALUE ...]`` into a config. The
    demo's keys (``image``, ``allow_random_weights``) are extension keys of
    the config parser, so ``image <path>`` works as well as ``--image``."""
    import argparse

    from semseg_torch.config import load_cfg, merge_cfg_from_list

    parser = argparse.ArgumentParser(description="semseg_torch demo")
    parser.add_argument("--config", type=str,
                        default="config/cityscapes/cityscapes_psanet50.yaml")
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = merge_cfg_from_list(load_cfg(args.config), args.opts or [])
    if args.image:
        cfg["image"] = args.image
    if not cfg.get("image"):
        raise SystemExit("provide an input via --image or 'image <path>'")
    return cfg


def main(argv=None):
    """Predict on ``cuda:{test_gpu[0]}``. Without a CUDA device it raises;
    ``run(cfg, device="cpu")`` predicts on the CPU explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "semseg_torch.demo needs a CUDA device and torch.cuda.is_available() is "
            "false; call run(cfg, device='cpu') to predict on the CPU")
    cfg = parse_args(argv)
    gpus = cfg.get("test_gpu") or [0]
    run(cfg, device=f"cuda:{gpus[0]}")


if __name__ == "__main__":
    main()
