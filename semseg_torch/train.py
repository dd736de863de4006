"""Training entry point of the port: the one-GPU counterpart of
``tool/train.py::run``.

    python -m semseg_torch.train --config config/cityscapes/cityscapes_psanet50.yaml \\
        [KEY VALUE ...]

trains on ``cuda:{train_gpu[0]}`` and raises without CUDA; tests call
``run(cfg, device="cpu")``. The recipe is the reference's: random
scale/rotate/blur/flip/crop augmentation, poly LR with the 10x head group,
aux loss, ``epochs * len(loader)`` iterations, the reference's log lines
(loss, main, aux, lr every ``print_freq`` steps; mIoU/mAcc/allAcc per
epoch) and ``train_epoch_{k}.pth`` every ``save_freq`` epochs (reference
state_dict names, with the optimizer state).

The host side is the port's own: configs parse with
``semseg_torch.config`` and data comes from ``semseg_torch.data``
(``SemData``, the train transforms, ``DataLoader``), copies of the JAX
package's modules of the same names (numpy, cv2 and yaml; the port
imports nothing of ``semseg_tpu``).

Not ported yet (they raise): ``resume``, ``weight``, loading a pretrained
backbone file, ``evaluate: True`` and the native loader (ROADMAP item 9).
Training runs one replica: ``train_gpu`` beyond its first entry is logged
and left unused (multi-GPU training is item 12). Without the pretrained
file the backbone trains from its seeded init, as ``tool/train.py`` does
with a warning.
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

WIRE_DTYPES = {"float32": np.float32, "float16": np.float16, "uint8": np.uint8}


def _get(cfg, key, default=None):
    value = getattr(cfg, key, None)
    return default if value is None else value


def _unsupported(cfg, pretrained_path: str):
    """Raise on what the port's training does not do yet."""
    asked = [k for k in ("resume", "weight", "evaluate", "native_loader") if _get(cfg, k)]
    if _get(cfg, "pretrained", True) and os.path.isfile(pretrained_path):
        asked.append(f"pretrained ({pretrained_path})")
    if asked:
        raise NotImplementedError(
            f"not ported yet: {', '.join(asked)} (ROADMAP queue 1 item 9)")


def build_train_loader(cfg):
    """The reference train pipeline (``tool/train.py:178-232``) on the
    shared host modules. Images are NHWC float32, normalised on the host,
    or raw pixels for ``image_wire_dtype: uint8`` (normalised on the
    device). Returns ``(loader, normalize)``."""
    from semseg_torch.data import DataLoader, SemData, Uint8Wire, transform

    wire = _get(cfg, "image_wire_dtype", "float32")
    if wire not in WIRE_DTYPES:
        raise ValueError(f"image_wire_dtype must be float32/float16/uint8, got {wire}")
    uint8 = wire == "uint8"
    ignore = cfg.ignore_label
    train_transform = transform.Compose([
        transform.RandScale([cfg.scale_min, cfg.scale_max]),
        transform.RandRotate([cfg.rotate_min, cfg.rotate_max], padding=IMAGENET_MEAN,
                             ignore_label=ignore),
        transform.RandomGaussianBlur(),
        transform.RandomHorizontalFlip(),
        transform.Crop([cfg.train_h, cfg.train_w], crop_type="rand",
                       padding=IMAGENET_MEAN, ignore_label=ignore),
        transform.ToTensor(),
    ] + ([] if uint8 else [transform.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD)]))
    data = SemData(split="train", data_root=cfg.data_root, data_list=cfg.train_list,
                   transform=train_transform)
    if uint8:
        data = Uint8Wire(data)
    loader = DataLoader(data, batch_size=cfg.batch_size, shuffle=True,
                        num_workers=cfg.workers, drop_last=True,
                        seed=_get(cfg, "manual_seed", 0))
    return loader, ((IMAGENET_MEAN, IMAGENET_STD) if uint8 else None)


def _to_device(loader, device, wire_dtype, labels_u8: bool):
    """Yield the loader's batches as tensors on ``device``, the next one
    copied while the current one trains (pinned memory on CUDA)."""
    pin = torch.device(device).type == "cuda"

    def stage(images, labels):
        images = images.astype(wire_dtype, copy=False)  # uint8 arrives as uint8 (Uint8Wire)
        if labels_u8:
            labels = labels.astype(np.uint8)
        out = []
        for arr in (images, labels):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            out.append((t.pin_memory() if pin else t).to(device, non_blocking=True))
        return out

    pending = None
    for images, labels in loader:
        staged = stage(images, labels)
        if pending is not None:
            yield pending
        pending = staged
    if pending is not None:
        yield pending


def run(cfg, device, logger=None, step_hook=None):
    """Train as ``cfg`` says on ``device``. ``step_hook(iteration,
    metrics)``, if given, is called after every step. Returns ``{"trainer":
    the Trainer, "epochs": [per-epoch stats], "checkpoints": [paths]}``."""
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model, compute_dtype, validate_arch
    from semseg_torch.utils.misc import check_makedirs, get_logger

    logger = logger or get_logger()
    validate_arch(cfg)
    _unsupported(cfg, _get(cfg, "initmodel", os.path.join(
        "initmodel", f"resnet{cfg.layers}_v2.pth")))
    seed = _get(cfg, "manual_seed", 0)
    random.seed(seed)
    np.random.seed(seed)
    device = torch.device(device)
    gpus = _get(cfg, "train_gpu", [])
    if len(gpus) > 1:
        logger.info("train_gpu lists %d devices; the port trains on one (%s)",
                    len(gpus), device)

    dtype = compute_dtype(cfg)
    model = build_model(cfg, dtype=dtype, device=device, seed=seed, train=True)
    logger.info("=> creating model %s%d, classes %d, compute dtype %s, on %s",
                cfg.arch, cfg.layers, cfg.classes, dtype, device)
    if _get(cfg, "pretrained", True):
        logger.warning("=> no pretrained backbone: training from the seeded init")

    loader, normalize = build_train_loader(cfg)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise ValueError(f"batch_size {cfg.batch_size} exceeds the {len(loader.dataset)} "
                         "training samples")
    max_iter = cfg.epochs * steps_per_epoch
    trainer = Trainer(
        model, make_sgd(model, cfg.base_lr, cfg.momentum, cfg.weight_decay),
        classes=cfg.classes, ignore_label=cfg.ignore_label, aux_weight=cfg.aux_weight,
        base_lr=cfg.base_lr, max_iter=max_iter, power=cfg.power,
        zoom_factor=cfg.zoom_factor, rng_seed=seed, normalize=normalize)
    check_makedirs(cfg.save_path)
    wire = WIRE_DTYPES[_get(cfg, "image_wire_dtype", "float32")]
    labels_u8 = cfg.classes <= 255 and 0 <= cfg.ignore_label <= 255

    epochs, checkpoints = [], []
    for epoch in range(_get(cfg, "start_epoch", 0), cfg.epochs):
        loader.set_epoch(epoch)
        stats = _train_epoch(cfg, logger, trainer, _to_device(loader, device, wire, labels_u8),
                             epoch, steps_per_epoch, max_iter, step_hook)
        epochs.append(stats)
        if (epoch + 1) % cfg.save_freq == 0:
            path = os.path.join(cfg.save_path, f"train_epoch_{epoch + 1}.pth")
            torch.save({"epoch": epoch + 1, "state_dict": model.state_dict(),
                        "optimizer": trainer.optimizer.state_dict()}, path)
            logger.info("Saving checkpoint to: %s", path)
            checkpoints.append(path)
    return {"trainer": trainer, "epochs": epochs, "checkpoints": checkpoints}


def _train_epoch(cfg, logger, trainer, batches, epoch, steps_per_epoch, max_iter,
                 step_hook):
    from semseg_torch.utils.metrics import AverageMeter, summarize

    batch_time, data_time = AverageMeter(), AverageMeter()
    totals = {}
    steps = 0
    end = time.time()
    for i, (images, labels) in enumerate(batches):
        data_time.update(time.time() - end)
        metrics = trainer.step(images, labels)
        current_iter = epoch * steps_per_epoch + i + 1
        steps += 1
        for k in ("main_loss", "intersection", "union", "target"):
            totals[k] = totals[k] + metrics[k] if k in totals else metrics[k]
        if step_hook is not None:
            step_hook(current_iter, metrics)
        batch_time.update(time.time() - end)
        end = time.time()
        if (i + 1) % cfg.print_freq == 0:
            remain = (max_iter - current_iter) * batch_time.avg
            t_m, t_s = divmod(int(remain), 60)
            t_h, t_m = divmod(t_m, 60)
            accuracy = (metrics["intersection"].sum() / (metrics["target"].sum() + 1e-10)).item()
            logger.info(
                "Epoch: [%d/%d][%d/%d] Data %.3f (%.3f) Batch %.3f (%.3f) "
                "Remain %02d:%02d:%02d MainLoss %.4f AuxLoss %.4f Loss %.4f "
                "Accuracy %.4f lr %.6f",
                epoch + 1, cfg.epochs, i + 1, steps_per_epoch, data_time.val,
                data_time.avg, batch_time.val, batch_time.avg, t_h, t_m, t_s,
                metrics["main_loss"].item(), metrics["aux_loss"].item(),
                metrics["loss"].item(), accuracy, metrics["lr"])
    hist = {k: totals[k].cpu().numpy() for k in ("intersection", "union", "target")}
    m_iou, m_acc, all_acc = summarize(hist["intersection"], hist["union"], hist["target"])
    logger.info("Train result at epoch [%d/%d]: mIoU/mAcc/allAcc %.4f/%.4f/%.4f.",
                epoch + 1, cfg.epochs, m_iou, m_acc, all_acc)
    return {"loss": totals["main_loss"].item() / steps, "mIoU": m_iou, "mAcc": m_acc,
            "allAcc": all_acc, "steps": steps}


def parse_args(argv=None):
    """The config of ``--config PATH [KEY VALUE ...]``, by
    ``semseg_torch.config``'s parser (yaml)."""
    from semseg_torch.config import parse_config_args

    return parse_config_args(argv, default_config="config/cityscapes/cityscapes_psanet50.yaml")


def main(argv=None):
    """Train on ``cuda:{train_gpu[0]}``. Without a CUDA device it raises;
    ``run(cfg, device="cpu")`` trains on the CPU explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "semseg_torch.train needs a CUDA device and torch.cuda.is_available() "
            "is false; call run(cfg, device='cpu') to train on the CPU")
    cfg = parse_args(argv)
    gpus = _get(cfg, "train_gpu", None) or [0]
    run(cfg, device=f"cuda:{gpus[0]}")


if __name__ == "__main__":
    main()
