"""Export a trained checkpoint as a deployment artifact: the port's
counterpart of ``tool/export.py``.

    python -m semseg_torch.export --config config/ade20k/ade20k_pspnet50.yaml \\
        model_path exp/.../train_epoch_100.pth export_path /tmp/pspnet50.pt2 \\
        [export_format torch_export|pth] [export_output probs|logits|pred] \\
        [export_platforms "['cuda']"] [export_scope crop|full export_h <H> export_w <W>]

runs on ``cuda:{test_gpu[0]}`` and raises without CUDA; tests call
``run(cfg, device="cpu")``. The weights come from a port checkpoint, a
reference or a DDP ``.pth`` (``engine/checkpoint.py::load_state_dict_any``),
into the float32 model (``tool/export.py:98``).

- ``export_format torch_export`` (default): a ``torch.export`` program
  (``.pt2``, ``engine/export.py``) with the weights in it. ``export_scope
  crop`` (default) traces the batch-polymorphic per-crop forward
  (``export_output``: ``probs``, ``logits`` or ``pred``); ``full`` traces the
  whole sliding-window program for an ``export_h`` x ``export_w`` image with
  the config's TEST crop, ``base_size``, ``scales`` and ``window_batch``
  (uint8 image -> uint8 class map).
- ``export_format pth``: ``{"epoch", "state_dict"}`` with DDP ``module.``
  keys, the reference's own format (JAX ``export_pth``).
- ``export_format stablehlo`` raises: StableHLO comes from the JAX package.

PSANet: unless the config sets ``fused_attention``, a CUDA-targeted export
(``export_platforms "['cuda']"``) keeps the PSA forward kernel as the
operator ``semseg::psa_softmax_bmm``, and any other export traces the plain
attention, portable and loadable with bare ``torch`` (``tool/export.py``'s
rule for ``['tpu']``).
"""

from __future__ import annotations

import os
import time

import torch


def _get(cfg, key, default=None):
    value = getattr(cfg, key, None)
    return default if value is None else value


def _check(cfg):
    """The export keys' rules, before any device or file is touched.
    Returns ``(format, scope, output, platforms)``."""
    from semseg_torch.engine.export import OUTPUTS, check_platforms

    fmt = _get(cfg, "export_format", "torch_export")
    if fmt == "stablehlo":
        raise ValueError(
            "export_format stablehlo is the JAX package's artifact: python tool/export.py "
            "--config ... export_format stablehlo; the port writes torch_export (.pt2) or pth")
    if fmt not in ("torch_export", "pth"):
        raise ValueError(f"unknown export_format {fmt!r} (torch_export or pth)")
    scope = _get(cfg, "export_scope", "crop")
    if scope not in ("crop", "full"):
        raise ValueError(f"unknown export_scope {scope!r} (crop or full)")
    if scope == "full" and not (_get(cfg, "export_h") and _get(cfg, "export_w")):
        raise ValueError("export_scope full requires export_h/export_w (the window grid "
                         "is static per input shape)")
    output = _get(cfg, "export_output", "probs")
    if output not in OUTPUTS:
        raise ValueError(f"export_output must be one of {OUTPUTS}, got {output!r}")
    platforms = _get(cfg, "export_platforms")
    check_platforms(platforms)
    return fmt, scope, output, platforms


def run(cfg, device=None, logger=None):
    """Export as ``cfg`` says; returns the path written. ``device=None`` is
    the CUDA device and raises without one; the CPU only as
    ``device="cpu"`` (``export_format pth`` touches no device)."""
    from semseg_torch.engine import export as ex
    from semseg_torch.engine.checkpoint import export_pth
    from semseg_torch.models.build import validate_arch
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD
    from semseg_torch.test import load_model
    from semseg_torch.utils.misc import get_logger, resolve_device

    logger = logger or get_logger()
    validate_arch(cfg)
    out_path = _get(cfg, "export_path")
    if not out_path:
        raise ValueError("export_path is required (CLI: export_path <file>)")
    fmt, scope, output, platforms = _check(cfg)
    model_path = _get(cfg, "model_path", "")
    if not os.path.isfile(model_path):
        raise RuntimeError(f"=> no checkpoint found at '{model_path}'")
    if fmt == "pth":
        export_pth(model_path, out_path)
        logger.info("=> exported reference .pth: %s", out_path)
        return out_path

    device = resolve_device(device)
    model = load_model(cfg, device, logger)
    if cfg.arch == "psa" and _get(cfg, "fused_attention") is None:
        # explicit, not device-auto: the artifact must not depend on where
        # it was traced unless it is CUDA-targeted
        model.psa.fused_attention = bool(platforms) and all(p == "cuda" for p in platforms)
    crop_h, crop_w = _get(cfg, "test_h", cfg.train_h), _get(cfg, "test_w", cfg.train_w)
    t0 = time.perf_counter()
    if scope == "full":
        from semseg_torch.engine.evaluator import SlidingWindowEvaluator

        h, w = int(cfg.export_h), int(cfg.export_w)
        evaluator = SlidingWindowEvaluator(
            model, classes=cfg.classes, crop_h=crop_h, crop_w=crop_w, mean=IMAGENET_MEAN,
            std=IMAGENET_STD, base_size=_get(cfg, "base_size", max(h, w)),
            scales=list(_get(cfg, "scales", [1.0])), window_batch=_get(cfg, "window_batch", 8),
            device=device)
        exported = ex.export_sliding_window(evaluator, h, w, platforms=platforms)
    else:
        exported = ex.export_serving(model, crop_h=crop_h, crop_w=crop_w, mean=IMAGENET_MEAN,
                                     std=IMAGENET_STD, output=output, platforms=platforms)
    trace_s = time.perf_counter() - t0
    ex.save_serving(out_path, exported)
    logger.info("=> exported %s program: %s (traced on %s in %.1f s, operators %s, %.1f MB)",
                scope, out_path, device, trace_s, ex.semseg_ops(exported) or "none",
                os.path.getsize(out_path) / 1e6)
    return out_path


def main(argv=None):
    """Export on ``cuda:{test_gpu[0]}``. Without a CUDA device it raises;
    ``run(cfg, device="cpu")`` exports on the CPU explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "semseg_torch.export needs a CUDA device and torch.cuda.is_available() is "
            "false; call run(cfg, device='cpu') to export on the CPU")
    from semseg_torch.config import parse_config_args

    cfg = parse_config_args(argv, default_config="config/ade20k/ade20k_pspnet50.yaml")
    gpus = _get(cfg, "test_gpu", None) or [0]
    run(cfg, device=f"cuda:{gpus[0]}")


if __name__ == "__main__":
    main()
