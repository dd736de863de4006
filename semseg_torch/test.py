"""Whole-image sliding-window evaluation driver of the port: the
counterpart of ``tool/test.py``.

    python -m semseg_torch.test --config config/cityscapes/cityscapes_psanet50.yaml \\
        model_path exp/.../train_epoch_200.pth [KEY VALUE ...]

runs on ``cuda:{test_gpu[0]}`` and raises without CUDA; tests call
``run(cfg, device="cpu")``. It loads a ``.pth`` (a port checkpoint, a
reference or a DDP ``module.`` file: ``engine/checkpoint.py``), builds the
model in float32 (``tool/test.py:69``) and evaluates the list file
``test_list`` from ``index_start`` (``index_step`` images, 0 = to the end)
at the config's ``scales`` with flip, ``window_batch`` windows a batch.
It keeps 3 images in flight (queued on the device, read back in order,
``tool/test.py:226-283``), writes each class map as a gray
PNG under ``<save_folder>/gray`` and a palette PNG under
``<save_folder>/color``, then scores the gray PNGs against the labels
(``cal_acc``, unless ``split`` is ``test``). ``has_prediction: True``
skips straight to the scoring.

``eval_pipeline`` unset picks ``device`` for one image shape over up to 16
probed images and ``device_bucketed`` otherwise (the probe reads PNG and
JPEG headers, EXIF aware: ``_image_shape``, ``tool/test.py:150-223``);
both are the same pipeline in the port. ``host`` is the cv2/numpy
reference pipeline, one image at a time. ``eval_devices: N`` (or ``all``)
evaluates over ``cuda:0 .. cuda:N-1`` with ``eval_partition`` ``window``
(the default) or ``spatial`` (``engine/evaluator.py``); with ``run(cfg,
device="cpu")``, over N CPU entries.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD


def _get(cfg, key, default=None):
    value = getattr(cfg, key, None)
    return default if value is None else value


def load_model(cfg, device, logger):
    """The float32 model of ``cfg`` on ``device`` with the weights of
    ``cfg.model_path``. As the reference loads (strict=False,
    ``tool/test.py:112-113``), the training-only ``aux`` head may be
    absent; any other missing or unknown key raises."""
    from semseg_torch.engine.checkpoint import load_state_dict_any
    from semseg_torch.models.build import build_model

    path = _get(cfg, "model_path", "")
    if not os.path.exists(path):
        raise RuntimeError(f"=> no checkpoint found at '{path}'")
    model = build_model(cfg, dtype=torch.float32, device=device)
    logger.info("=> loading checkpoint '%s'", path)
    res = model.load_state_dict(load_state_dict_any(path), strict=False)
    missing = [k for k in res.missing_keys if not k.startswith("aux.")]
    if missing or res.unexpected_keys:
        raise KeyError(f"'{path}' does not fit the model: missing {missing[:8]}, "
                       f"unexpected {res.unexpected_keys[:8]}")
    logger.info("=> loaded checkpoint '%s'", path)
    return model


def eval_devices(cfg, device):
    """The evaluator's devices for ``eval_devices`` (``tool/test.py:
    101-130``): None for one device; on CUDA ``cuda:0 .. cuda:N-1``
    (``all``: every CUDA device), raising when N exceeds the device count;
    on the CPU, N entries of ``device``."""
    n = _get(cfg, "eval_devices")
    if not n:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n == "all" else int(n)
        if n > count:
            raise RuntimeError(f"eval_devices={n} but only {count} CUDA devices attached")
        return [torch.device("cuda", i) for i in range(n)] if n > 1 else None
    if n == "all":
        raise ValueError("eval_devices 'all' counts CUDA devices; give a number on the CPU")
    return [device] * int(n) if int(n) > 1 else None


def make_evaluator(cfg, model, device, mode, devices=None):
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator

    return SlidingWindowEvaluator(
        model, classes=cfg.classes, crop_h=cfg.test_h, crop_w=cfg.test_w,
        mean=IMAGENET_MEAN, std=IMAGENET_STD, base_size=cfg.base_size,
        scales=cfg.scales, window_batch=_get(cfg, "window_batch", 8), mode=mode,
        device=device, devices=devices, partition=_get(cfg, "eval_partition", "window"))


def run(cfg, device=None, logger=None):
    """Evaluate as ``cfg`` says. ``device=None`` is the CUDA device and
    raises without one; the CPU only as ``device="cpu"``. Returns
    ``{"images", "seconds", "metrics"}``: the images evaluated, the
    seconds of the evaluation loop (0.0 with ``has_prediction``), and
    ``(mIoU, mAcc, allAcc)`` (None for the ``test`` split)."""
    from semseg_torch.data import SemData, transform
    from semseg_torch.models.build import validate_arch
    from semseg_torch.utils.misc import get_logger, resolve_device

    logger = logger or get_logger()
    validate_arch(cfg)
    if cfg.split not in ("train", "val", "test"):
        raise ValueError(f"bad split {cfg.split}")
    logger.info("=> creating model ... classes: %d", cfg.classes)
    gray_folder = os.path.join(cfg.save_folder, "gray")
    color_folder = os.path.join(cfg.save_folder, "color")

    test_data = SemData(split=cfg.split, data_root=cfg.data_root, data_list=cfg.test_list,
                        transform=transform.Compose([transform.ToTensor()]))
    start, step = cfg.index_start, cfg.index_step
    end = len(test_data.data_list) if step == 0 else min(start + step, len(test_data.data_list))
    test_data.data_list = test_data.data_list[start:end]
    colors = np.loadtxt(cfg.colors_path).astype("uint8")
    with open(cfg.names_path) as f:
        names = [line.rstrip("\n") for line in f]

    seconds = 0.0
    if not cfg.has_prediction:
        device = resolve_device(device)
        devices = eval_devices(cfg, device)
        if devices is not None:
            device = devices[0]
            logger.info("eval devices: %d, partition=%s", len(devices),
                        _get(cfg, "eval_partition", "window"))
        model = load_model(cfg, device, logger)
        mode = _get(cfg, "eval_pipeline")
        if not mode:
            n = len(test_data.data_list)
            probe = {_image_shape(test_data.data_list[i][0]) for i in sorted(
                {int(i) for i in np.linspace(0, max(n - 1, 0), num=min(16, n))})}
            mode = "device" if len(probe) <= 1 else "device_bucketed"
            logger.info("eval_pipeline auto-selected: %s (%d shapes)", mode, len(probe))
        evaluator = make_evaluator(cfg, model, device, mode, devices)
        seconds = test(logger, test_data, evaluator, gray_folder, color_folder, colors)
    metrics = None
    if cfg.split != "test":
        metrics = cal_acc(logger, test_data.data_list, gray_folder, cfg.classes, names)
    return {"images": len(test_data), "seconds": seconds, "metrics": metrics}


def _jpeg_exif_orientation(f):
    """EXIF orientation (1-8) from an open JPEG positioned at an APP1
    payload start, or None. cv2.imread applies this orientation when
    decoding, so the shape probe must account for it."""
    import struct

    if f.read(6) != b"Exif\x00\x00":
        return None
    tiff = f.tell()
    order = f.read(2)
    if order == b"II":
        fmt = "<"
    elif order == b"MM":
        fmt = ">"
    else:
        return None
    if struct.unpack(fmt + "H", f.read(2))[0] != 42:
        return None
    (ifd_off,) = struct.unpack(fmt + "I", f.read(4))
    f.seek(tiff + ifd_off)
    (count,) = struct.unpack(fmt + "H", f.read(2))
    for _ in range(count):
        entry = f.read(12)
        tag, typ = struct.unpack(fmt + "HH", entry[:4])
        if tag == 0x0112 and typ == 3:  # orientation, SHORT
            return struct.unpack(fmt + "H", entry[8:10])[0]
    return None


def _image_shape(path):
    """Decoded (H, W) of an image file without reading the pixels when
    possible (PNG/JPEG header sniff, EXIF-orientation aware; cv2
    fallback). A copy of ``tool/test.py::_image_shape``."""
    import struct

    try:
        with open(path, "rb") as f:
            head = f.read(32)
            if head[:8] == b"\x89PNG\r\n\x1a\n":
                w, h = struct.unpack(">II", head[16:24])
                return (h, w)
            if head[:2] == b"\xff\xd8":  # JPEG: walk segments for SOFn
                f.seek(2)
                transposed = None
                hw = None
                while hw is None or transposed is None:
                    marker = f.read(2)
                    if len(marker) < 2 or marker[0] != 0xFF:
                        break
                    if marker[1] in (0xD9, 0xDA):
                        # EOI / SOS: entropy-coded data follows (EXIF must
                        # precede SOS).
                        break
                    (size,) = struct.unpack(">H", f.read(2))
                    payload_at = f.tell()
                    if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (0xC4, 0xC8, 0xCC):
                        f.read(1)  # sample precision
                        hw = struct.unpack(">HH", f.read(4))
                        # keep walking: APP1 may legally follow SOF
                    elif marker[1] == 0xE1 and transposed is None:  # APP1
                        orient = _jpeg_exif_orientation(f)
                        transposed = orient in (5, 6, 7, 8)
                    f.seek(payload_at + size - 2)
                if hw is not None:
                    h, w = hw
                    return (w, h) if transposed else (h, w)
    except Exception:
        pass
    import cv2

    return cv2.imread(path, cv2.IMREAD_COLOR).shape[:2]


def test(logger, test_data, evaluator, gray_folder, color_folder, colors, pipeline_depth=3):
    """Predict every image of ``test_data`` with ``pipeline_depth`` images
    queued on the device ahead of the read-back (the host pipeline: one at
    a time, on the decoded float image), and save the PNGs. Returns the
    seconds of the loop, every read-back included."""
    import cv2

    from semseg_torch.utils.metrics import AverageMeter
    from semseg_torch.utils.misc import check_makedirs, colorize

    logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
    check_makedirs(gray_folder)
    check_makedirs(color_folder)

    def save(idx, gray):
        image_name = os.path.splitext(os.path.basename(test_data.data_list[idx][0]))[0]
        cv2.imwrite(os.path.join(gray_folder, image_name + ".png"), gray)
        colorize(gray, colors).save(os.path.join(color_folder, image_name + ".png"))

    data_time, batch_time = AverageMeter(), AverageMeter()
    depth = max(1, pipeline_depth)
    pending = deque()
    t0 = end = time.time()
    n = len(test_data)
    for i in range(n):
        image, _ = test_data[i]
        image = np.ascontiguousarray(image)
        data_time.update(time.time() - end)
        if evaluator.mode == "host":
            save(i, evaluator.predict(image))
        else:
            # Decoded pixels are integer-valued 0-255 floats: uint8 ships a
            # quarter of the bytes, exactly (the evaluator casts back to f32).
            pending.append((i, evaluator.predict_async(image.astype(np.uint8))))
        while len(pending) > depth:
            j, lazy = pending.popleft()
            save(j, lazy.cpu().numpy())
        batch_time.update(time.time() - end)
        end = time.time()
        if (i + 1) % 10 == 0 or i + 1 == n:
            logger.info("Test: [%d/%d] Data %.3f (%.3f) Batch %.3f (%.3f).", i + 1, n,
                        data_time.val, data_time.avg, batch_time.val, batch_time.avg)
    while pending:
        j, lazy = pending.popleft()
        save(j, lazy.cpu().numpy())
    seconds = time.time() - t0
    logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
    return seconds


def cal_acc(logger, data_list, pred_folder, classes, names):
    """Score the gray PNGs against the label PNGs (``tool/test.py:286-325``):
    per-image accuracy lines, then mIoU/mAcc/allAcc and per-class lines.
    Returns ``(mIoU, mAcc, allAcc)``."""
    import cv2

    from semseg_torch.utils.metrics import AverageMeter, intersection_and_union, summarize

    intersection_meter, union_meter, target_meter = AverageMeter(), AverageMeter(), AverageMeter()
    for i, (image_path, target_path) in enumerate(data_list):
        image_name = os.path.splitext(os.path.basename(image_path))[0]
        pred = cv2.imread(os.path.join(pred_folder, image_name + ".png"), cv2.IMREAD_GRAYSCALE)
        target = cv2.imread(target_path, cv2.IMREAD_GRAYSCALE)
        intersection, union, target_hist = (v.numpy() for v in intersection_and_union(
            torch.from_numpy(pred), torch.from_numpy(target), classes))
        intersection_meter.update(intersection)
        union_meter.update(union)
        target_meter.update(target_hist)
        accuracy = sum(intersection_meter.val) / (sum(target_meter.val) + 1e-10)
        logger.info("Evaluating %d/%d on image %s, accuracy %.4f.", i + 1, len(data_list),
                    image_name + ".png", accuracy)
    m_iou, m_acc, all_acc = summarize(intersection_meter.sum, union_meter.sum,
                                      target_meter.sum)
    logger.info("Eval result: mIoU/mAcc/allAcc %.4f/%.4f/%.4f.", m_iou, m_acc, all_acc)
    iou_class = intersection_meter.sum / (union_meter.sum + 1e-10)
    accuracy_class = intersection_meter.sum / (target_meter.sum + 1e-10)
    for i in range(classes):
        logger.info("Class_%d result: iou/accuracy %.4f/%.4f, name: %s.", i, iou_class[i],
                    accuracy_class[i], names[i])
    return m_iou, m_acc, all_acc


def main(argv=None):
    """Evaluate on ``cuda:{test_gpu[0]}``. Without a CUDA device it raises;
    ``run(cfg, device="cpu")`` evaluates on the CPU explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "semseg_torch.test needs a CUDA device and torch.cuda.is_available() is "
            "false; call run(cfg, device='cpu') to evaluate on the CPU")
    from semseg_torch.config import parse_config_args

    cfg = parse_config_args(argv, default_config="config/cityscapes/cityscapes_psanet50.yaml")
    gpus = _get(cfg, "test_gpu", None) or [0]
    run(cfg, device=f"cuda:{gpus[0]}")


if __name__ == "__main__":
    main()
