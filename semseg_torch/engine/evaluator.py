"""Sliding-window inference engine (``device`` mode), single- and
multi-scale.

Port of ``semseg_tpu/engine/evaluator.py``, numerics-compatible with the
reference pipeline (``tool/test.py:122-223``): for each scale, the long
side is resized to ``round(scale * base_size)`` (half-pixel bilinear), the
image is mean-padded to the crop size, overlapping crop windows on a
``ceil(crop * 2/3)`` stride run through the model with horizontal-flip
TTA, per-window class probabilities are accumulated in float32 and
count-normalized, un-padded and resized back to the original resolution.
The scales' maps are summed in float32, in scale order (a bf16 model's
per-scale maps are bf16; a bf16 running sum would round again at every
scale), and reduced to a uint8 class map; ``predict_probs`` returns the
sum over the number of scales. The image is uploaded once per request,
and everything after the uint8 upload runs on the evaluator's device; the
pipeline is channels-first throughout. :meth:`predict_tensor` is that
whole program on a device tensor, from the uint8 image to the uint8 map;
``engine/export.py`` exports it as one ``torch.export`` program.

With a bf16 model on CUDA, each chunk's zoom upsample, softmax and flip
average run as one fused kernel (``ops/stitch.py``) on logits taken at
feature resolution.

Several devices (``devices``, the first the primary, which holds the
canvas, the coverage and the final resize) run each chunk's window
forwards as JAX's ``mesh=`` does (``semseg_tpu/engine/evaluator.py:
109-165``): ``partition="window"`` splits the chunk's window pairs (a
window with its flip) over the devices, ``"spatial"`` splits each window's
rows (``parallel/spatial.py``). ``mode="host"`` is the reference-faithful
cv2/numpy stitching with a float64 canvas (``evaluator.py:61-79,
664-745``), the model on the primary device. ``device_bucketed`` only
bounded XLA compiles and runs the same eager pipeline as ``device``; the
JAX package's ``pooled_ms`` (off by default there) is not ported.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from semseg_torch.ops.resize import resize_bilinear_half_pixel_cf
from semseg_torch.ops.stitch import supported, upsample_softmax_flip
from semseg_torch.parallel.spatial import Spatial, split_rows
from semseg_torch.utils.misc import LRU, resolve_device, tensor_cache


def _grid_coords(new_h, new_w, crop_h, crop_w, stride_rate):
    """Static sliding-grid window origins (reference tool/test.py:158-171)."""
    stride_h = int(np.ceil(crop_h * stride_rate))
    stride_w = int(np.ceil(crop_w * stride_rate))
    grid_h = int(np.ceil(float(new_h - crop_h) / stride_h) + 1)
    grid_w = int(np.ceil(float(new_w - crop_w) / stride_w) + 1)
    coords = []
    for ih in range(grid_h):
        for iw in range(grid_w):
            e_h = min(ih * stride_h + crop_h, new_h)
            e_w = min(iw * stride_w + crop_w, new_w)
            coords.append((e_h - crop_h, e_w - crop_w))
    return coords


@tensor_cache
def _coverage(canvas_h, canvas_w, crop_h, crop_w, stride_rate, device):
    """float32 ``[canvas_h, canvas_w]`` count of the windows covering each
    pixel. Coverage is separable (the grid is a product of row and column
    origins): count = rows (x) cols."""
    coords = _grid_coords(canvas_h, canvas_w, crop_h, crop_w, stride_rate)
    rows = np.zeros(canvas_h, np.float32)
    cols = np.zeros(canvas_w, np.float32)
    for s_h in sorted({c[0] for c in coords}):
        rows[s_h:s_h + crop_h] += 1.0
    for s_w in sorted({c[1] for c in coords}):
        cols[s_w:s_w + crop_w] += 1.0
    return torch.from_numpy(np.outer(rows, cols)).to(device)


def _cv2_resize_mc(array: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) for any channel count, in chunks of at
    most 4 channels (cv2 5.x rejects >4-channel Mats; channels are
    independent, so the chunks are exact). A copy of the JAX package's."""
    import cv2

    c = array.shape[2] if array.ndim == 3 else 1
    if c <= 4:
        return cv2.resize(array, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    parts = [cv2.resize(array[:, :, i:i + 4], (out_w, out_h),
                        interpolation=cv2.INTER_LINEAR) for i in range(0, c, 4)]
    parts = [p if p.ndim == 3 else p[:, :, None] for p in parts]
    return np.concatenate(parts, axis=2)


def _device_list(devices) -> List[torch.device]:
    """``devices`` as ``torch.device`` entries; a CUDA entry without an
    index is the current device. An entry this machine lacks raises, and so
    do CPU and CUDA entries mixed (a CPU entry would run the kernels'
    plain versions)."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            count = torch.cuda.device_count()
            index = torch.cuda.current_device() if d.index is None and count else d.index
            if index is None or not 0 <= index < count:
                raise RuntimeError(f"devices entry {d}: this machine shows {count} CUDA "
                                   "device(s)")
            d = torch.device("cuda", index)
        elif d.type != "cpu":
            raise ValueError(f"devices entry {d}: the evaluator runs on cuda or cpu")
        out.append(d)
    if not out:
        raise ValueError("devices is empty")
    if len({d.type for d in out}) > 1:
        raise ValueError(f"devices {[str(d) for d in out]} mix CPU and CUDA entries")
    return out


def _scaled_size(h, w, scale, base_size):
    long_size = round(scale * base_size)
    new_h = new_w = long_size
    if h > w:
        new_w = round(long_size / float(h) * w)
    else:
        new_h = round(long_size / float(w) * h)
    return new_h, new_w


@dataclasses.dataclass
class _Geometry:
    """Everything about one image shape that does not depend on pixels
    (host values only; the coverage count is :func:`_coverage`)."""

    new_h: int
    new_w: int
    pad_h_half: int
    pad_w_half: int
    canvas_h: int
    canvas_w: int
    chunks: List[List[Tuple[int, int]]]  # window origins, padded to wb each
    n_real: List[int]  # real (non-padding) windows per chunk


class SlidingWindowEvaluator:
    def __init__(
        self,
        model,
        *,
        classes: int,
        crop_h: int,
        crop_w: int,
        mean: Sequence[float],
        std: Optional[Sequence[float]],
        base_size: int,
        scales: Sequence[float],
        flip: bool = True,
        stride_rate: float = 2 / 3,
        window_batch: int = 8,
        mode: str = "device",
        fused_stitch: Optional[bool] = None,
        device=None,
        devices: Optional[Sequence] = None,
        partition: str = "window",
    ):
        """``model``: an ``nn.Module`` on ``device`` whose ``forward(x,
        zoom=True)`` maps normalized ``[B, 3, crop_h, crop_w]`` windows to
        float32 logits (``zoom=False``: at feature resolution) and which
        carries ``dtype`` and ``zoom_factor``. ``device=None`` is the CUDA
        device (raising without one); the CPU only as ``device="cpu"``.
        ``fused_stitch=None`` picks
        the fused kernel for bf16 models with flip TTA and a zoomed head
        on CUDA; ``True`` forces it (a CPU tensor then runs the kernel's
        plain version).

        ``devices``: several devices, ``devices[0]`` the primary (the
        model's device; ``device``, if given, must name it). The model is
        replicated once, here, onto each other distinct device (JAX parks
        the weights replicated on the mesh, ``evaluator.py:161-165``);
        entries that repeat a device share its replica, so ``["cuda:0",
        "cuda:0"]`` runs the partition on one card. ``None`` is the
        single-device evaluator. ``partition="window"`` splits each chunk's
        window pairs as evenly as possible over the devices; each runs its
        pairs through the model (and, with the fused stitch, the kernel on
        its own device) and the averaged probabilities go to the primary.
        ``"spatial"`` splits each window's rows over the devices
        (``parallel/spatial.py``); the fused stitch then runs on the
        primary on the gathered feature-resolution logits. JAX turns the
        fused stitch off under a mesh (GSPMD cannot partition a
        ``pallas_call``); here the kernel stays on. ``mode="host"`` runs on
        the primary alone and warns when given several devices, as
        ``tool/test.py:119-123`` does."""
        if mode not in ("device", "device_bucketed", "host"):
            raise ValueError(
                f"mode must be 'device', 'device_bucketed' or 'host', got {mode}")
        if partition not in ("window", "spatial"):
            raise ValueError(f"partition must be 'window' or 'spatial', got {partition}")
        self._options = dict(
            classes=classes, crop_h=crop_h, crop_w=crop_w, mean=mean, std=std,
            base_size=base_size, scales=scales, flip=flip, stride_rate=stride_rate,
            window_batch=window_batch, mode=mode, fused_stitch=fused_stitch, device=device,
            devices=devices, partition=partition)
        self.mode = mode
        self.partition = partition
        self.model = model.eval()
        self.classes = classes
        self.crop_h, self.crop_w = crop_h, crop_w
        self.base_size = base_size
        self.scales = [float(s) for s in scales]
        self.flip = flip
        self.stride_rate = stride_rate
        self.window_batch = max(2, window_batch)
        if devices is None:
            self.device = resolve_device(device)
            self.devices = [self.device]
        else:
            self.devices = _device_list(devices)
            self.device = self.devices[0]
            if device is not None and _device_list([device])[0] != self.device:
                raise ValueError(f"device {device} is not devices[0] {self.device}")
        if mode == "host" and len(self.devices) > 1:
            warnings.warn("the host pipeline (cv2/numpy reference path) runs on one device: "
                          f"devices {[str(d) for d in self.devices]} reduced to {self.device}")
            self.devices = [self.device]
        # One replica per distinct device, made once (the primary holds the
        # model itself); entry k runs self.models[k].
        replicas = {self.device: self.model}
        for d in self.devices:
            if d not in replicas:
                with torch.no_grad():
                    replicas[d] = copy.deepcopy(self.model).to(d).eval()
        self.models = [replicas[d] for d in self.devices]
        self._spatial = (Spatial(self.devices, self.models)
                         if partition == "spatial" and len(self.devices) > 1 else None)
        self.dtype = getattr(model, "dtype", torch.float32)
        self._mean = torch.tensor(mean, dtype=torch.float32).view(3, 1, 1).to(self.device)
        self._std = (None if std is None else
                     torch.tensor(std, dtype=torch.float32).view(3, 1, 1).to(self.device))
        if fused_stitch is None:
            fused_stitch = (
                flip
                and mode != "host"
                and self.device.type == "cuda"
                and supported(self.dtype)  # bf16 models
                and getattr(model, "zoom_factor", 1) != 1
            )
        self.fused_stitch = bool(fused_stitch)
        if self.fused_stitch and not flip:
            # the kernel averages (window, flipped-window) pairs
            raise ValueError("fused_stitch=True requires flip=True "
                             "(the kernel fuses the flip average)")
        self._geometries = LRU()  # (h, w, scale) -> _Geometry, the recent ones

    def with_options(self, **changes) -> "SlidingWindowEvaluator":
        """A new evaluator over the same model with this one's constructor
        arguments, ``changes`` applied (``devices`` and ``partition``, a
        window batch, a mode)."""
        return SlidingWindowEvaluator(self.model, **{**self._options, **changes})

    # ------------------------------------------------------------------
    # window forward (normalize -> model -> softmax / fused stitch)
    # ------------------------------------------------------------------
    def _normalize(self, images):
        x = images - self._mean
        if self._std is not None:
            x = x / self._std
        return x

    def _logits(self, k, x, zoom=True):
        """Entry ``k``'s model on normalized windows ``x`` on its device,
        or, under the spatial partition, the partitioned forward of a batch
        on the primary."""
        if self._spatial is not None:
            return self._spatial.forward(x, zoom)
        return self.models[k](x) if zoom else self.models[k](x, zoom=False)

    def _pair_probs(self, k, wins):
        """``[wb, 3, h, w]`` normalized windows on entry ``k``'s device ->
        probs ``[wb, C, h, w]`` there, averaged with the flipped windows'
        under flip TTA; bf16 containers on a bf16 model (softmax itself in
        float32). With the fused stitch: feature-resolution logits from
        the same model, then the fused upsample + softmax + flip kernel.
        The model returns float32 logits whose values are exact in its
        compute dtype, so the cast to it loses nothing."""
        wb = len(wins)
        batch = torch.cat([wins, wins.flip(-1)]) if self.flip else wins
        if self.fused_stitch:
            logits = self._logits(k, batch, zoom=False)
            pairs = torch.stack([logits[:wb], logits[wb:]], dim=1).to(self.dtype)
            return upsample_softmax_flip(pairs.contiguous(), (self.crop_h, self.crop_w))
        probs = torch.softmax(self._logits(k, batch).float(), dim=1)
        if self.dtype == torch.bfloat16:
            probs = probs.to(torch.bfloat16)
        if self.flip:
            # un-flip = reverse W after the softmax
            probs = (probs[:wb] + probs[wb:].flip(-1)) / 2
        return probs

    def _chunk_probs(self, wins):
        """One chunk's normalized windows on the primary -> their averaged
        probs on the primary; under the window partition each device runs
        its share of the pairs."""
        if self.partition != "window" or len(self.devices) == 1:
            return self._pair_probs(0, wins)
        starts = split_rows(len(wins), len(self.devices))
        parts = [self._pair_probs(k, wins[a:b].to(d)).to(self.device)
                 for k, (d, a, b) in enumerate(zip(self.devices, starts, starts[1:])) if b > a]
        return torch.cat(parts)

    # ------------------------------------------------------------------
    # one scale's pipeline
    # ------------------------------------------------------------------
    def _geometry(self, h, w, scale) -> _Geometry:
        key = (h, w, scale)
        geom = self._geometries.get(key)
        if geom is not None:
            return geom
        crop_h, crop_w = self.crop_h, self.crop_w
        new_h, new_w = _scaled_size(h, w, scale, self.base_size)
        pad_h = max(crop_h - new_h, 0)
        pad_w = max(crop_w - new_w, 0)
        canvas_h, canvas_w = new_h + pad_h, new_w + pad_w
        coords = _grid_coords(canvas_h, canvas_w, crop_h, crop_w, self.stride_rate)
        # Fixed chunk size (window_batch, halved under flip); the last
        # chunk is padded with window (0, 0), whose result is dropped.
        wb = min(max(1, self.window_batch // (2 if self.flip else 1)), len(coords))
        chunks, n_real = [], []
        for i in range(0, len(coords), wb):
            chunk = coords[i:i + wb]
            n_real.append(len(chunk))
            chunks.append(chunk + [(0, 0)] * (wb - len(chunk)))
        geom = _Geometry(new_h, new_w, pad_h // 2, pad_w // 2, canvas_h,
                         canvas_w, chunks, n_real)
        self._geometries.put(key, geom)
        return geom

    def _scale_probs(self, img: torch.Tensor, scale: float) -> torch.Tensor:
        """The uploaded image ``[3, h, w]`` (float32, 0-255) at one scale
        -> class probabilities ``[C, h, w]`` on the device (bf16 on a bf16
        model)."""
        _, h, w = img.shape
        g = self._geometry(h, w, scale)
        crop_h, crop_w = self.crop_h, self.crop_w
        # 1) scale (half-pixel bilinear, cv2-equivalent)
        img = resize_bilinear_half_pixel_cf(img, (g.new_h, g.new_w))
        # 2) mean-pad to at least the crop size
        canvas = self._mean.expand(3, g.canvas_h, g.canvas_w).clone()
        canvas[:, g.pad_h_half:g.pad_h_half + g.new_h,
               g.pad_w_half:g.pad_w_half + g.new_w] = img
        # 3) windows in fixed-size chunks, stitched into a float32 canvas
        acc = torch.zeros((self.classes, g.canvas_h, g.canvas_w),
                          dtype=torch.float32, device=self.device)
        for chunk, n_real in zip(g.chunks, g.n_real):
            wins = torch.stack([canvas[:, y:y + crop_h, x:x + crop_w]
                                for (y, x) in chunk])
            probs = self._chunk_probs(self._normalize(wins))
            for i, (y, x) in enumerate(chunk[:n_real]):
                acc[:, y:y + crop_h, x:x + crop_w] += probs[i]
        acc /= _coverage(g.canvas_h, g.canvas_w, crop_h, crop_w, self.stride_rate,
                         self.device)
        # 4) un-pad, resize back to the original resolution
        acc = acc[:, g.pad_h_half:g.pad_h_half + g.new_h,
                  g.pad_w_half:g.pad_w_half + g.new_w]
        # bf16 models carry the count-divided probs as bf16 into the
        # final resize (the JAX package's bf16 license); float32 stays exact
        if self.dtype == torch.bfloat16:
            acc = acc.to(torch.bfloat16)
        return resize_bilinear_half_pixel_cf(acc, (h, w))

    def _upload(self, image: np.ndarray) -> torch.Tensor:
        # as is: uint8 ships a quarter of the float32 bytes
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

    def _probs_sum(self, image: torch.Tensor) -> torch.Tensor:
        """One RGB ``[h, w, 3]`` image on the device (uint8 or float,
        0-255) -> the sum over scales of the class probabilities ``[C, h,
        w]``, in float32 and scale order (one scale: its map as it is, bf16
        on a bf16 model). Nothing here waits for the device."""
        img = image.permute(2, 0, 1).float()
        total = None
        for scale in self.scales:
            probs = self._scale_probs(img, scale)
            total = probs if total is None else total.float() + probs
        return total

    # ------------------------------------------------------------------
    # host mode (reference-faithful cv2/numpy stitching)
    # ------------------------------------------------------------------
    def _run_windows(self, windows: np.ndarray) -> np.ndarray:
        """``[n, h, w, 3]`` raw 0-255 windows -> float32 probs ``[n, h, w,
        C]`` from the model on the primary device, ``window_batch`` at a
        time (a short last batch padded with its last window)."""
        n, wb = windows.shape[0], self.window_batch
        probs = np.empty((n, self.crop_h, self.crop_w, self.classes), dtype=np.float32)
        for start in range(0, n, wb):
            chunk = windows[start:start + wb]
            real = chunk.shape[0]
            if real < wb:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], wb - real, axis=0)])
            x = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(self.device)
            logits = self.model(self._normalize(x.permute(0, 3, 1, 2)))
            out = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)
            probs[start:start + real] = out[:real].cpu().numpy()
        return probs

    def net_process(self, image: np.ndarray) -> np.ndarray:
        """Single-crop probabilities with optional flip TTA (reference
        ``tool/test.py:122-146``)."""
        batch = image[None]
        if self.flip:
            batch = np.concatenate([batch, batch[:, :, ::-1]], axis=0)
        probs = self._run_windows(batch)
        if self.flip:
            return (probs[0] + probs[1][:, ::-1]) / 2
        return probs[0]

    def scale_process(self, image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
        """Host-stitched float64 prediction of one scaled image, resized to
        ``out_h x out_w`` (reference ``tool/test.py:149-178``)."""
        import cv2

        ori_h, ori_w, _ = image.shape
        pad_h = max(self.crop_h - ori_h, 0)
        pad_w = max(self.crop_w - ori_w, 0)
        pad_h_half, pad_w_half = pad_h // 2, pad_w // 2
        if pad_h > 0 or pad_w > 0:
            image = cv2.copyMakeBorder(
                image, pad_h_half, pad_h - pad_h_half, pad_w_half, pad_w - pad_w_half,
                cv2.BORDER_CONSTANT, value=self._mean.view(3).tolist())
        new_h, new_w, _ = image.shape
        coords = _grid_coords(new_h, new_w, self.crop_h, self.crop_w, self.stride_rate)
        windows = np.stack([image[s_h:s_h + self.crop_h, s_w:s_w + self.crop_w]
                            for (s_h, s_w) in coords])
        if self.flip:
            windows = np.concatenate([windows, windows[:, :, ::-1]], axis=0)
        probs = self._run_windows(windows)
        if self.flip:
            k = len(coords)
            probs = (probs[:k] + probs[k:][:, :, ::-1]) / 2
        prediction = np.zeros((new_h, new_w, self.classes), dtype=np.float64)
        count = np.zeros((new_h, new_w, 1), dtype=np.float64)
        for win_probs, (s_h, s_w) in zip(probs, coords):
            prediction[s_h:s_h + self.crop_h, s_w:s_w + self.crop_w] += win_probs
            count[s_h:s_h + self.crop_h, s_w:s_w + self.crop_w] += 1
        prediction /= count
        prediction = prediction[pad_h_half:pad_h_half + ori_h, pad_w_half:pad_w_half + ori_w]
        return _cv2_resize_mc(prediction, out_w, out_h)

    def _predict_probs_host(self, image: np.ndarray) -> np.ndarray:
        """float64 ``[h, w, C]``: the mean over scales of ``scale_process``
        on the cv2-resized image."""
        import cv2

        h, w, _ = image.shape
        prediction = np.zeros((h, w, self.classes), dtype=np.float64)
        for scale in self.scales:
            new_h, new_w = _scaled_size(h, w, scale, self.base_size)
            image_scale = cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
            prediction += self.scale_process(image_scale, h, w)
        return prediction / len(self.scales)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def predict_tensor(self, image: torch.Tensor) -> torch.Tensor:
        """The whole program on the device: one RGB ``[h, w, 3]`` image
        (uint8 or float, 0-255) on the evaluator's device -> the uint8 class
        map ``[h, w]``, the argmax of the float32 sum over scales (JAX
        ``_build_scale_raw(..., emit_argmax=True)`` and
        ``_build_ms_argmax_raw``). :meth:`predict` runs it under inference
        mode; ``engine/export.export_sliding_window`` traces it."""
        if self.mode == "host":
            raise ValueError("predict_tensor and predict_async require a device mode "
                             "(mode is 'host')")
        return torch.argmax(self._probs_sum(image), dim=0).to(torch.uint8)

    @torch.inference_mode()
    def predict_probs(self, image: np.ndarray) -> np.ndarray:
        """Class probabilities ``[h, w, C]`` float32 for one RGB image: the
        mean over scales (bf16 models' bf16 probabilities are widened
        exactly); float64 in host mode."""
        if self.mode == "host":
            return self._predict_probs_host(image)
        probs = self._probs_sum(self._upload(image)).float() / len(self.scales)
        return probs.permute(1, 2, 0).cpu().numpy()

    @torch.inference_mode()
    def predict_async(self, image: np.ndarray) -> torch.Tensor:
        """The uint8 class map ``[h, w]`` (argmax of the float32 sum over
        scales) as a device tensor; on CUDA the work is queued and the call
        returns before it finishes."""
        return self.predict_tensor(self._upload(image))

    def predict(self, image: np.ndarray) -> np.ndarray:
        """argmax class map for one image (uint8)."""
        if self.mode == "host":
            with torch.inference_mode():
                return np.argmax(self._predict_probs_host(image), axis=2).astype(np.uint8)
        return self.predict_async(image).cpu().numpy()
