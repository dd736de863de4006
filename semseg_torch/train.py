"""Training entry point of the port: the counterpart of
``tool/train.py::run`` (``tool/train.py:60-152,233-488``).

    python -m semseg_torch.train --config config/cityscapes/cityscapes_psanet50.yaml \\
        [KEY VALUE ...]

trains on ``cuda:{train_gpu[0]}`` when ``train_gpu`` lists one device, and
raises without CUDA; tests call ``run(cfg, device="cpu")``. With more
devices (or ``world_size`` nodes) and ``multiprocessing_distributed``, it
starts one process per ``train_gpu`` entry (:func:`spawn`, the reference's
``mp.spawn``, ``tool/train.py:102-119``), each a ``DistributedDataParallel``
rank on ``cuda:{train_gpu[local]}`` over ``dist_backend`` (``nccl``; the
configs' ``xla`` means ``nccl``; ``gloo`` when named, which lets ranks
share a device). ``batch_size`` and ``batch_size_val`` are global: each
rank loads its shard of every epoch (``order[rank::world]``) at
``batch_size // world``, and a batch the rank count does not divide
raises. ``sync_bn`` (default True) synchronises BatchNorm over the ranks;
``False`` keeps each rank's moments, with rank 0's running statistics
(``models/build.py``). Rank 0 alone logs, writes ``scalars.jsonl`` and
writes checkpoints, which hold the model's own state_dict names; the
logged losses are the mean over the ranks and the histograms their sum. The recipe is the reference's: random
scale/rotate/blur/flip/crop augmentation, poly LR with the 10x head group,
aux loss, ``epochs * len(loader)`` iterations, the reference's log lines
(loss, main, aux, lr every ``print_freq`` steps; mIoU/mAcc/allAcc per
epoch) and ``train_epoch_{k}.pth`` every ``save_freq`` epochs (reference
state_dict names, with the optimizer state and the step; keep-2 rotation;
written on a worker thread unless ``async_save: False``).

Start-up loads, in the reference's order (``tool/train.py:262-319``): the
ImageNet backbone (``pretrained``, default on, from ``initmodel`` or
``initmodel/resnet{layers}_v2.pth``; a missing file warns and trains from
the seeded init), then ``weight`` (merged strict=False), then ``resume``
(a path, or ``auto``: the newest complete checkpoint under ``save_path``),
which restores model, optimizer, step and epoch, and fast-forwards the
loader past the batches of the epoch already consumed.

SIGTERM and SIGUSR1 ask for a preemption snapshot (``train_preempt.pth``)
at the next step boundary, after any save still in flight; then ``run``
returns. Over several ranks the request is all-reduced (max) at every step
boundary, so every rank stops at the same step, whichever rank the signal
reached; :func:`spawn` passes a signal sent to the launching process on to
its ranks. ``resume auto`` continues from it exactly: augmentation is keyed
per (seed, epoch, sample) and dropout per (seed, step). The config key
``_preempt_after_step: N`` trips the same path after global step N (a test
hook, set on the config object). ``evaluate: True`` validates on center
crops of ``val_list`` after every epoch (``batch_size_val``; a trailing
partial batch is padded with ignore labels).

The host side is the port's own: configs parse with
``semseg_torch.config`` and data comes from ``semseg_torch.data``, copies
of the JAX package's modules of the same names (numpy, cv2 and yaml; the
port imports nothing of ``semseg_tpu``). Scalars go to
``<save_path>/scalars.jsonl`` (the JAX driver's fallback writer; the
tensorboard writer is not used). ``native_loader: True`` decodes and
augments in the native pipeline (``data/native.py``), built at first use.
``profile_dir``: rank 0 traces the first epoch it trains (its validation
included) with ``torch.profiler`` (CPU and CUDA activities) and writes a
Chrome trace, ``<profile_dir>/train_epoch_<N>.pt.trace.json``
(``tool/train.py:426-485``).

``model_parallel: M`` (``tool/train.py:74-90``) lays the ``W`` ranks out
as ``W / M`` data ranks by ``M`` tensor-parallel peers
(``parallel/dist.py::grid``; ``W % M`` raises with JAX's words): each TP
group holds the head's wide layers split by output channel
(``parallel/tensor.py``) and trains on one data shard, so the loaders,
the batch split, DDP, BatchNorm's moments, the metrics and the dropout
seed go by the data rank and the data world, and the global batch must
divide by ``W / M``. Validation runs the head's collectives, so every
rank runs it. Rank 0 writes full, unsharded checkpoints (gathered over
its TP group), which load strictly into a one-process model; ``resume``
shards them again, and a one-process checkpoint resumes under TP.
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import time

import numpy as np
import torch

from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

WIRE_DTYPES = {"float32": np.float32, "float16": np.float16, "uint8": np.uint8}


def _get(cfg, key, default=None):
    value = getattr(cfg, key, None)
    return default if value is None else value


def _wire(cfg):
    wire = _get(cfg, "image_wire_dtype", "float32")
    if wire not in WIRE_DTYPES:
        raise ValueError(f"image_wire_dtype must be float32/float16/uint8, got {wire}")
    return wire


def _finish(cfg, steps):
    """The wire's tail of a transform list, and the dataset wrapper."""
    from semseg_torch.data import Uint8Wire, transform

    uint8 = _wire(cfg) == "uint8"
    tail = [transform.ToTensor()]
    if not uint8:
        tail.append(transform.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD))
    return transform.Compose(steps + tail), (Uint8Wire if uint8 else (lambda d: d))


class _EpochTrace:
    """``profile_dir``'s trace: a ``torch.profiler`` window (CPU activity,
    and CUDA on a CUDA device) from :meth:`start` to :meth:`write`, which
    exports it as a Chrome trace. Inactive without a directory."""

    def __init__(self, profile_dir, device, logger):
        self.dir, self.logger, self.prof = profile_dir, logger, None
        self.device = torch.device(device)

    def start(self):
        if not self.dir:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()

    def write(self, epoch):
        """Stop and write ``train_epoch_<epoch>.pt.trace.json``; only once."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"train_epoch_{epoch}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        self.logger.info("Profiler trace written to: %s", path)

    def close(self):
        """Stop an unfinished window without writing it (a run that raised)."""
        if self.prof is not None:
            self.prof.stop()
            self.prof = None


def per_rank_batch(batch_size: int, world: int, key: str = "batch_size",
                   model_parallel: int = 1) -> int:
    """A global batch's share of each data rank of ``world`` ranks at
    ``model_parallel`` (``world / model_parallel`` data ranks: TP peers
    share one slice); a batch the data ranks do not divide raises (JAX
    ``tool/train.py:143-152``), as does a ``model_parallel`` that does not
    divide ``world``."""
    from semseg_torch.parallel.dist import grid

    data = grid(world, model_parallel).data_world
    if batch_size % data:
        tail = f" ({world} ranks / model_parallel {model_parallel})" if model_parallel > 1 else ""
        raise ValueError(f"{key} {batch_size} not divisible by {data} ranks{tail}")
    return batch_size // data


def build_train_loader(cfg, logger=None, rank=0, world=1):
    """The reference train pipeline (``tool/train.py:178-232``) on the
    shared host modules, or on the native pipeline for ``native_loader:
    True`` (``data/native.py``; when its extension cannot be built, a
    warning and the Python pipeline, as ``tool/train.py:193-213``). Images
    are NHWC float32, normalised on the host, or raw pixels for
    ``image_wire_dtype: uint8`` (normalised on the device). Rank ``rank``
    of ``world`` loads its shard at ``batch_size // world``. Returns
    ``(loader, normalize)``; ``loader.pipeline`` is ``"native"`` or
    ``"python"``."""
    from semseg_torch.data import DataLoader, SemData, transform

    ignore = cfg.ignore_label
    uint8 = _wire(cfg) == "uint8"
    train_transform, wrap = _finish(cfg, [
        transform.RandScale([cfg.scale_min, cfg.scale_max]),
        transform.RandRotate([cfg.rotate_min, cfg.rotate_max], padding=IMAGENET_MEAN,
                             ignore_label=ignore),
        transform.RandomGaussianBlur(),
        transform.RandomHorizontalFlip(),
        transform.Crop([cfg.train_h, cfg.train_w], crop_type="rand",
                       padding=IMAGENET_MEAN, ignore_label=ignore),
    ])
    data, pipeline = None, "python"
    if _get(cfg, "native_loader"):
        from semseg_torch.data import native

        if native.available():
            data, pipeline = native.NativeSemData(
                "train", cfg.data_root, cfg.train_list, crop_h=cfg.train_h,
                crop_w=cfg.train_w, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                ignore_label=ignore, crop_type="rand", scale=(cfg.scale_min, cfg.scale_max),
                rotate=(cfg.rotate_min, cfg.rotate_max), normalize=not uint8), "native"
            if logger is not None:
                logger.info("native (C++) host data pipeline enabled")
        elif logger is not None:
            logger.warning("native_loader requested but the extension could not be built "
                           "(%s); falling back to the Python pipeline", native.build_error())
    if data is None:
        data = SemData(split="train", data_root=cfg.data_root, data_list=cfg.train_list,
                       transform=train_transform)
    loader = DataLoader(wrap(data), batch_size=per_rank_batch(cfg.batch_size, world),
                        shuffle=True, num_workers=cfg.workers, drop_last=True,
                        seed=_get(cfg, "manual_seed", 0), shard_index=rank, num_shards=world)
    loader.pipeline = pipeline
    return loader, ((IMAGENET_MEAN, IMAGENET_STD) if uint8 else None)


def build_val_loader(cfg, rank=0, world=1):
    """Center crops of ``val_list`` at the training crop size, in order,
    ``batch_size_val`` a batch, the last batch partial
    (``tool/train.py:234-254``); rank ``rank`` of ``world`` loads its shard
    at ``batch_size_val // world`` (``DistributedSampler``'s, which pads the
    list to a multiple of ``world`` by repeating its first images)."""
    from semseg_torch.data import DataLoader, SemData, transform

    val_transform, wrap = _finish(cfg, [
        transform.Crop([cfg.train_h, cfg.train_w], crop_type="center",
                       padding=IMAGENET_MEAN, ignore_label=cfg.ignore_label),
    ])
    data = wrap(SemData(split="val", data_root=cfg.data_root, data_list=cfg.val_list,
                        transform=val_transform))
    return DataLoader(data, batch_size=per_rank_batch(cfg.batch_size_val, world,
                                                      "batch_size_val"),
                      shuffle=False, num_workers=cfg.workers, shard_index=rank,
                      num_shards=world)


def _pad_batch(images, labels, full, ignore_label):
    """Pad a trailing partial batch to ``full`` samples: zero images with
    ``ignore_label`` labels, which no loss or histogram counts
    (``tool/train.py:660-677``)."""
    n = images.shape[0]
    if n == full:
        return images, labels
    images = np.concatenate([images, np.zeros((full - n,) + images.shape[1:], images.dtype)])
    labels = np.concatenate(
        [labels, np.full((full - n,) + labels.shape[1:], ignore_label, labels.dtype)])
    return images, labels


def _to_device(loader, device, wire_dtype, labels_u8: bool, stage=None):
    """Yield the loader's batches as tensors on ``device``, the next one
    copied while the current one trains (pinned memory on CUDA).
    ``stage(images, labels)``, if given, rewrites each host batch first."""
    pin = torch.device(device).type == "cuda"

    def put(images, labels):
        if stage is not None:
            images, labels = stage(images, labels)
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
        staged = put(images, labels)
        if pending is not None:
            yield pending
        pending = staged
    if pending is not None:
        yield pending


def _load_start(cfg, model, logger):
    """The ImageNet backbone, then ``weight`` (``tool/train.py:262-299``)."""
    from semseg_torch.engine.checkpoint import load_state_dict_any
    from semseg_torch.models.convert import backbone_from_imagenet_pth

    if _get(cfg, "pretrained", True):
        init_path = _get(cfg, "initmodel", os.path.join("initmodel",
                                                        f"resnet{cfg.layers}_v2.pth"))
        if os.path.isfile(init_path):
            logger.info("=> loading ImageNet-pretrained backbone '%s'", init_path)
            sd, unused = backbone_from_imagenet_pth(init_path, cfg.layers)
            _merge(model, sd, init_path, logger)
            if unused:
                logger.warning("unconverted pretrained keys: %s", unused)
        else:
            logger.warning("=> no pretrained backbone at '%s': training from the seeded "
                           "init deviates from the reference recipe (set pretrained: False "
                           "to silence)", init_path)
    weight = _get(cfg, "weight")
    if weight:
        if os.path.exists(weight):
            logger.info("=> loading weight '%s'", weight)
            _merge(model, load_state_dict_any(weight), weight, logger)
        else:
            logger.info("=> no weight found at '%s'", weight)


def _merge(model, state_dict, path, logger):
    """Load ``state_dict`` over ``model`` where its keys exist (strict=False,
    as ``tool/train.py::_merge``), logging the keys on either side that
    found no partner. Under TP the planned entries are cut to the rank's
    shard first."""
    tp = getattr(model, "tp", None)
    if tp is not None:
        from semseg_torch.parallel.tensor import shard_state_dict

        state_dict = shard_state_dict(state_dict, tp.plan, tp.rank, tp.size)
    res = model.load_state_dict(state_dict, strict=False)
    if res.missing_keys:
        logger.info("=> %d model keys not in '%s' keep their values", len(res.missing_keys),
                    path)
    if res.unexpected_keys:
        logger.warning("=> keys of '%s' the model lacks, ignored: %s", path,
                       res.unexpected_keys[:8])


def _resume(cfg, trainer, logger, rank=0, control=None):
    """``resume`` (a path or ``auto``) into ``trainer``; the start epoch.
    Over several ranks, global rank 0 resolves ``auto`` and ``control`` (a
    CPU group) carries its answer to the others."""
    from semseg_torch.engine import checkpoint as ckpt
    from semseg_torch.parallel.dist import broadcast_object

    start_epoch = _get(cfg, "start_epoch", 0)
    path = _get(cfg, "resume")
    if not path:
        return start_epoch
    if path == "auto":
        path = ckpt.latest_checkpoint(cfg.save_path) if rank == 0 else None
        if control is not None:
            path = broadcast_object(path, control)
    if path and os.path.isfile(path):
        logger.info("=> loading checkpoint '%s'", path)
        payload = ckpt.load_checkpoint(path)
        trainer.load_state_dict(payload)
        start_epoch = int(payload["epoch"])
        logger.info("=> loaded checkpoint (epoch %d, step %d)", start_epoch, trainer.step_count)
    else:
        logger.info("=> no checkpoint found at '%s'", _get(cfg, "resume"))
    return start_epoch


def run(cfg, device, logger=None, step_hook=None, process_group=None):
    """Train as ``cfg`` says on ``device``: in this process, or as one rank
    of ``process_group`` (which every rank has joined; :func:`spawn` starts
    them): a DDP rank, or under ``model_parallel`` a rank of the data x
    model grid. ``step_hook(iteration, metrics)``, if given, is called
    after every step. Returns ``{"trainer": the Trainer, "epochs":
    [per-epoch train stats], "val": [per-epoch validation stats],
    "checkpoints": [epoch saves], "preempt": the snapshot's path or
    None}``; every save has landed on disk by then, on every rank.

    The run is reproducible on the card, as JAX's step is: cuDNN's
    deterministic algorithms are on and its autotuning off from start to
    end, in both compute dtypes (``utils.misc.deterministic_cudnn``; the
    caller's flags come back however the run ends). With cuDNN's default
    choice two float32 runs, or a resumed run and the run it continues,
    part in the last bits of their weights after one step."""
    from semseg_torch.utils.misc import deterministic_cudnn

    with deterministic_cudnn():
        return _run(cfg, device, logger, step_hook, process_group)


def _run(cfg, device, logger, step_hook, process_group):
    """:func:`run`'s body, under cuDNN's deterministic algorithms."""
    from semseg_torch.engine import checkpoint as ckpt
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model, compute_dtype, validate_arch
    from semseg_torch.parallel.dist import control_group, grid, grid_groups
    from semseg_torch.utils.misc import check_makedirs, get_logger

    rank, world = 0, 1
    if process_group is not None:
        rank = torch.distributed.get_rank(process_group)
        world = torch.distributed.get_world_size(process_group)
    logger = (logger or get_logger()) if rank == 0 else _quiet_logger()
    validate_arch(cfg)
    ranks = grid(world, _get(cfg, "model_parallel", 1))
    seed = _get(cfg, "manual_seed", 0)
    random.seed(seed)
    np.random.seed(seed)
    device = torch.device(device)
    control = control_group(process_group) if process_group is not None else None
    tp_group, data_group = None, process_group
    if ranks.model_parallel > 1:
        tp_group, data_group = grid_groups(ranks, rank)
    data_rank, data_world = ranks.data_index(rank), ranks.data_world

    dtype = compute_dtype(cfg)
    model = build_model(cfg, dtype=dtype, device=device, seed=seed, train=True,
                        process_group=data_group, tp_group=tp_group)
    logger.info("=> creating model %s%d, classes %d, compute dtype %s, on %s%s%s",
                cfg.arch, cfg.layers, cfg.classes, dtype, device,
                f" and {world - 1} more ranks (sync_bn {_get(cfg, 'sync_bn', True)})"
                if world > 1 else "",
                f", data x model = {data_world} x {ranks.model_parallel}"
                if tp_group is not None else "")
    if model.remat:
        logger.info("=> remat: each residual block of layer1-layer4 is recomputed in the "
                    "backward pass")
    _load_start(cfg, model, logger)

    loader, normalize = build_train_loader(cfg, logger, data_rank, data_world)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise ValueError(f"batch_size {cfg.batch_size} exceeds the {len(loader.dataset)} "
                         "training samples")
    max_iter = cfg.epochs * steps_per_epoch
    trainer = Trainer(
        model, make_sgd(model, cfg.base_lr, cfg.momentum, cfg.weight_decay),
        classes=cfg.classes, ignore_label=cfg.ignore_label, aux_weight=cfg.aux_weight,
        base_lr=cfg.base_lr, max_iter=max_iter, power=cfg.power,
        zoom_factor=cfg.zoom_factor, rng_seed=seed, normalize=normalize,
        process_group=data_group)
    start_epoch = _resume(cfg, trainer, logger, rank, control)

    # Mid-epoch resume: the step counts the batches of the epoch in progress
    # already consumed; the loader skips them (tool/train.py:324-338).
    start_batch = 0
    consumed = trainer.step_count - start_epoch * steps_per_epoch
    if consumed >= steps_per_epoch:  # snapshot taken at an epoch's end
        start_epoch += consumed // steps_per_epoch
        consumed %= steps_per_epoch
    if consumed > 0:
        start_batch = consumed
        logger.info("=> mid-epoch resume: skipping %d consumed batches of epoch %d",
                    consumed, start_epoch + 1)

    val_loader = (build_val_loader(cfg, data_rank, data_world) if _get(cfg, "evaluate")
                  else None)
    if rank == 0:
        check_makedirs(cfg.save_path)
        writer = _JsonlWriter(os.path.join(cfg.save_path, "scalars.jsonl"))
    else:
        writer = _NullWriter()
    wire = WIRE_DTYPES[_wire(cfg)]
    labels_u8 = cfg.classes <= 255 and 0 <= cfg.ignore_label <= 255
    preempt = {"flag": False, "after": _get(cfg, "_preempt_after_step"), "control": control}

    def on_signal(signum, frame):
        preempt["flag"] = True
        logger.info("received signal %d: checkpointing at the next step boundary", signum)

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            previous[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread
            pass

    result = {"trainer": trainer, "epochs": [], "val": [], "checkpoints": [], "preempt": None}
    # Rank 0 writes; under TP its TP peers take part in gathering the state.
    gathers = data_rank == 0 if tp_group is not None else rank == 0
    trace = _EpochTrace(_get(cfg, "profile_dir") if rank == 0 else None, device, logger)

    def landed():
        """Every save on disk; over several ranks, rank 0's seen by all."""
        ckpt.wait_pending()
        if control is not None:
            torch.distributed.barrier(group=control)

    try:
        trace.start()
        for epoch in range(start_epoch, cfg.epochs):
            first = start_batch if epoch == start_epoch else 0
            loader.set_epoch(epoch, first)
            stats = _train_epoch(cfg, logger, writer, trainer,
                                 _to_device(loader, device, wire, labels_u8), epoch,
                                 steps_per_epoch, max_iter, step_hook, first, preempt)
            if stats.pop("preempted"):
                trace.write(epoch + 1)
                ckpt.wait_pending()  # a snapshot waits for the save in flight
                path = ckpt.preempt_checkpoint_path(cfg.save_path)
                state = trainer.state_dict() if gathers else None
                if rank == 0:
                    ckpt.save_preempt_checkpoint(cfg.save_path, epoch, state)
                    logger.info("Preemption checkpoint saved to: %s", path)
                landed()
                result["preempt"] = path
                return result
            result["epochs"].append(stats)
            for key in ("loss", "mIoU", "mAcc", "allAcc"):
                writer.add_scalar(f"{key}_train", stats[key], epoch + 1)
            if (epoch + 1) % cfg.save_freq == 0:
                path = ckpt.checkpoint_path(cfg.save_path, epoch + 1)
                state = trainer.state_dict() if gathers else None
                if rank == 0:
                    save = (ckpt.save_checkpoint_async if _get(cfg, "async_save", True)
                            else ckpt.save_checkpoint)
                    save(cfg.save_path, epoch + 1, state, cfg.save_freq)
                    logger.info("Saving checkpoint to: %s", path)
                result["checkpoints"].append(path)
            if val_loader is not None:
                val = _validate(cfg, logger, trainer, val_loader, device, wire, labels_u8)
                result["val"].append(val)
                for key in ("loss", "mIoU", "mAcc", "allAcc"):
                    writer.add_scalar(f"{key}_val", val[key], epoch + 1)
            trace.write(epoch + 1)
        landed()
        return result
    finally:
        trace.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        writer.close()
        ckpt.wait_pending()  # raise an async save's error before returning


def _train_epoch(cfg, logger, writer, trainer, batches, epoch, steps_per_epoch, max_iter,
                 step_hook, start_batch, preempt):
    """One epoch from batch ``start_batch``. Step metrics stay on the
    device until a ``print_freq`` boundary or the epoch's end, where they
    are fetched, summed and written as per-step scalars."""
    from semseg_torch.parallel.dist import any_rank
    from semseg_torch.utils.metrics import AverageMeter, summarize

    batch_time, data_time = AverageMeter(), AverageMeter()
    totals, pending = {}, []
    steps = 0

    def flush():
        for it, m in pending:
            host = {k: m[k].cpu().numpy() for k in ("main_loss", "intersection", "union",
                                                     "target")}
            for k, v in host.items():
                totals[k] = totals[k] + v if k in totals else v
            inter, union, target = host["intersection"], host["union"], host["target"]
            writer.add_scalar("loss_train_batch", float(host["main_loss"]), it)
            writer.add_scalar("mIoU_train_batch", float(np.mean(inter / (union + 1e-10))), it)
            writer.add_scalar("mAcc_train_batch", float(np.mean(inter / (target + 1e-10))), it)
            writer.add_scalar("allAcc_train_batch", float(inter.sum() / (target.sum() + 1e-10)),
                              it)
        pending.clear()

    preempted = False
    end = time.time()
    for i, (images, labels) in enumerate(batches):
        data_time.update(time.time() - end)
        metrics = trainer.step(images, labels)
        steps += 1
        batch_idx = start_batch + i + 1  # within the epoch
        current_iter = epoch * steps_per_epoch + batch_idx
        pending.append((current_iter, metrics))
        if step_hook is not None:
            step_hook(current_iter, metrics)
        batch_time.update(time.time() - end)
        end = time.time()
        if batch_idx % cfg.print_freq == 0:
            flush()
            remain = (max_iter - current_iter) * batch_time.avg
            t_m, t_s = divmod(int(remain), 60)
            t_h, t_m = divmod(t_m, 60)
            accuracy = (metrics["intersection"].sum() / (metrics["target"].sum() + 1e-10)).item()
            logger.info(
                "Epoch: [%d/%d][%d/%d] Data %.3f (%.3f) Batch %.3f (%.3f) "
                "Remain %02d:%02d:%02d MainLoss %.4f AuxLoss %.4f Loss %.4f "
                "Accuracy %.4f lr %.6f",
                epoch + 1, cfg.epochs, batch_idx, steps_per_epoch, data_time.val,
                data_time.avg, batch_time.val, batch_time.avg, t_h, t_m, t_s,
                metrics["main_loss"].item(), metrics["aux_loss"].item(),
                metrics["loss"].item(), accuracy, metrics["lr"])
        stop = preempt["flag"] or (preempt["after"] is not None
                                   and current_iter >= int(preempt["after"]))
        if preempt["control"] is not None:  # every rank stops at the same step
            stop = any_rank(stop, preempt["control"])
        if stop:
            preempted = True
            break
    flush()
    if not totals:
        return {"loss": 0.0, "mIoU": 0.0, "mAcc": 0.0, "allAcc": 0.0, "steps": 0,
                "preempted": preempted}
    m_iou, m_acc, all_acc = summarize(totals["intersection"], totals["union"],
                                      totals["target"])
    logger.info("Train result at epoch [%d/%d]: mIoU/mAcc/allAcc %.4f/%.4f/%.4f.",
                    epoch + 1, cfg.epochs, m_iou, m_acc, all_acc)
    return {"loss": float(totals["main_loss"]) / steps, "mIoU": m_iou, "mAcc": m_acc,
            "allAcc": all_acc, "steps": steps, "preempted": preempted}


def _validate(cfg, logger, trainer, loader, device, wire, labels_u8):
    """Center-crop validation (``tool/train.py:680-724``): the eval step
    over every batch, summed on the device (and over the ranks' shards),
    one fetch at the end; the reference's log lines."""
    from semseg_torch.parallel.dist import all_reduce_sum
    from semseg_torch.utils.metrics import summarize

    def pad(images, labels):
        return _pad_batch(images, labels, loader.batch_size, cfg.ignore_label)

    acc = None
    for images, labels in _to_device(loader, device, wire, labels_u8, stage=pad):
        m = trainer.validate_step(images, labels)
        acc = m if acc is None else {k: acc[k] + m[k] for k in acc}
    if acc is None:  # an empty list: so on every rank
        return {"loss": 0.0, "mIoU": 0.0, "mAcc": 0.0, "allAcc": 0.0}
    if trainer.group is not None:
        acc = dict(zip(acc, all_reduce_sum(list(acc.values()), trainer.group)))
    acc = {k: v.cpu().numpy() for k, v in acc.items()}
    inter, union, target = acc["intersection"], acc["union"], acc["target"]
    m_iou, m_acc, all_acc = summarize(inter, union, target)
    logger.info("Val result: mIoU/mAcc/allAcc %.4f/%.4f/%.4f.", m_iou, m_acc, all_acc)
    iou = inter / (union + 1e-10)
    accuracy = inter / (target + 1e-10)
    for c in range(cfg.classes):
        logger.info("Class_%d Result: iou/accuracy %.4f/%.4f.", c, iou[c], accuracy[c])
    return {"loss": float(acc["loss_sum"]) / max(float(acc["valid_count"]), 1.0),
            "mIoU": m_iou, "mAcc": m_acc, "allAcc": all_acc}


def _quiet_logger():
    """The logger of a rank other than 0: it prints nothing."""
    logger = logging.getLogger("semseg_torch.train.quiet")
    logger.propagate = False
    logger.setLevel(logging.CRITICAL + 1)
    return logger


class _NullWriter:
    """The scalar writer of a rank other than 0."""

    def add_scalar(self, tag, value, step):
        pass

    def close(self):
        pass


class _JsonlWriter:
    """Scalars as JSON lines (``tool/train.py:748-759``)."""

    def __init__(self, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def parse_args(argv=None):
    """The config of ``--config PATH [KEY VALUE ...]``, by
    ``semseg_torch.config``'s parser (yaml)."""
    from semseg_torch.config import parse_config_args

    return parse_config_args(argv, default_config="config/cityscapes/cityscapes_psanet50.yaml")


def _rank_main(local_rank, cfg, device_type, backend, url, step_hook=None):
    """One rank of :func:`spawn`: join the group, :func:`run` (with
    ``step_hook`` after every step, if given), and return a summary
    (``steps``, ``epochs``, ``val``, ``checkpoints``, ``preempt``, the
    kernels' ``launches`` over the run, the host clock at every step's end,
    ``seconds`` and, on CUDA, ``peak_gib``)."""
    from semseg_torch.ops import launch_counters
    from semseg_torch.parallel import dist as pdist

    device = torch.device("cpu")
    if device_type == "cuda":
        device = pdist.rank_device(cfg, local_rank)
        torch.cuda.set_device(device)
    group = pdist.init_process_group(url, backend, pdist.global_rank(cfg, local_rank),
                                     pdist.world_size(cfg))
    try:
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        ends = []
        t0 = time.perf_counter()

        def on_step(it, metrics):
            ends.append(time.perf_counter() - t0)
            if step_hook is not None:
                step_hook(it, metrics)

        res = run(cfg, device, step_hook=on_step, process_group=group)
        return {"rank": torch.distributed.get_rank(group), "device": str(device),
                "steps": res["trainer"].step_count, "epochs": res["epochs"], "val": res["val"],
                "checkpoints": res["checkpoints"], "preempt": res["preempt"],
                "step_ends": ends, "seconds": time.perf_counter() - t0,
                "launches": {k: fn.launches for k, fn in counters.items()},
                "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device_type == "cuda" else None)}
    finally:
        torch.distributed.destroy_process_group()


def spawn(cfg, device="cuda", timeout_s=None, step_hook=None):
    """Train as ``cfg`` says with one process per ``train_gpu`` entry on
    this node (``world_size`` nodes in all; each node starts its own with
    its ``rank``): DDP ranks, or the data x model grid of
    ``model_parallel``, on ``cuda:{train_gpu[local]}``, or on the CPU for
    ``device="cpu"`` (then ``dist_backend`` must name gloo). Checks the
    devices, the grid and the batch sizes, builds the CUDA kernels once (ranks would
    race ``build_library`` into one directory), then starts the ranks (the
    ``spawn`` start method) and waits for them, at most ``timeout_s``
    (None: no limit); a rank that raises fails the call. While it waits,
    SIGTERM and SIGUSR1 sent to this process are passed on to the ranks,
    which snapshot at the same step (:func:`run`). ``step_hook``, a
    picklable ``step_hook(iteration, metrics)``, runs on every rank after
    every step. Returns each local rank's summary (:func:`_rank_main`)."""
    from semseg_torch.parallel import dist as pdist

    device_type = torch.device(device).type
    backend = pdist.backend_name(cfg, device_type)
    pdist.check_devices(cfg, backend, device_type)
    world = pdist.world_size(cfg)
    model_parallel = _get(cfg, "model_parallel", 1)
    # Raise before any rank starts.
    per_rank_batch(cfg.batch_size, world, model_parallel=model_parallel)
    if _get(cfg, "evaluate"):
        per_rank_batch(cfg.batch_size_val, world, "batch_size_val", model_parallel)
    if device_type == "cuda":
        from semseg_torch.ops._build import build_library

        build_library("psa")
    return pdist.spawn(_rank_main, pdist.local_processes(cfg),
                       (cfg, device_type, backend, pdist.rendezvous_url(cfg), step_hook),
                       timeout_s=timeout_s, forward_signals=(signal.SIGTERM, signal.SIGUSR1))


def main(argv=None):
    """Train on ``cuda:{train_gpu[0]}``, or with several devices (or
    nodes) and ``multiprocessing_distributed`` one DDP rank per
    ``train_gpu`` entry (:func:`spawn`). Without a CUDA device it raises;
    ``run(cfg, device="cpu")`` trains on the CPU explicitly."""
    from semseg_torch.parallel.dist import world_size

    if not torch.cuda.is_available():
        raise RuntimeError(
            "semseg_torch.train needs a CUDA device and torch.cuda.is_available() "
            "is false; call run(cfg, device='cpu') to train on the CPU")
    cfg = parse_args(argv)
    if world_size(cfg) > 1:
        if not _get(cfg, "multiprocessing_distributed", False):
            raise ValueError(f"train_gpu {cfg.train_gpu} over {_get(cfg, 'world_size', 1)} "
                             "node(s) with multiprocessing_distributed False: the port trains "
                             "on several devices as one process each")
        spawn(cfg, "cuda")
        return
    gpus = _get(cfg, "train_gpu", None) or [0]
    run(cfg, device=f"cuda:{gpus[0]}")


if __name__ == "__main__":
    main()
