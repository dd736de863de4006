"""Single-scale sliding-window inference engine (``device`` mode).

Port of ``semseg_tpu/engine/evaluator.py``, numerics-compatible with the
reference pipeline (``tool/test.py:122-223``): the long side is resized
to ``round(scale * base_size)`` (half-pixel bilinear), the image is
mean-padded to the crop size, overlapping crop windows on a
``ceil(crop * 2/3)`` stride run through the model with horizontal-flip
TTA, per-window class probabilities are accumulated in float32 and
count-normalized, un-padded, resized back to the original resolution,
and reduced to a uint8 class map. Everything after the uint8 upload runs
on the evaluator's device; the pipeline is channels-first throughout.

With a bf16 model on CUDA, each chunk's zoom upsample, softmax and flip
average run as one fused kernel (``ops/stitch.py``) on logits taken at
feature resolution.

Not ported yet: the multi-scale combiner (ROADMAP queue 1 item 11) and
the cv2 ``host`` mode. ``device_bucketed`` only bounded XLA compiles and
runs the same eager pipeline as ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from semseg_torch.ops.resize import resize_bilinear_half_pixel_cf
from semseg_torch.ops.stitch import supported, upsample_softmax_flip


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
    """Everything about one image shape that does not depend on pixels."""

    new_h: int
    new_w: int
    pad_h_half: int
    pad_w_half: int
    canvas_h: int
    canvas_w: int
    chunks: List[List[Tuple[int, int]]]  # window origins, padded to wb each
    n_real: List[int]  # real (non-padding) windows per chunk
    count: torch.Tensor  # [canvas_h, canvas_w] float32 window coverage


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
    ):
        """``model``: an ``nn.Module`` on ``device`` whose ``forward(x,
        zoom=True)`` maps normalized ``[B, 3, crop_h, crop_w]`` windows to
        float32 logits (``zoom=False``: at feature resolution) and which
        carries ``dtype`` and ``zoom_factor``. ``fused_stitch=None`` picks
        the fused kernel for bf16 models with flip TTA and a zoomed head
        on CUDA; ``True`` forces it (a CPU tensor then runs the kernel's
        plain version)."""
        if mode == "host":
            raise NotImplementedError(
                "host mode (cv2 stitching) is not ported yet")
        if mode not in ("device", "device_bucketed"):
            raise ValueError(
                f"mode must be 'device', 'device_bucketed' or 'host', got {mode}")
        if len(scales) != 1:
            raise NotImplementedError(
                "multi-scale evaluation is not ported yet "
                "(ROADMAP queue 1 item 11); pass one scale")
        self.model = model.eval()
        self.classes = classes
        self.crop_h, self.crop_w = crop_h, crop_w
        self.base_size = base_size
        self.scale = float(scales[0])
        self.flip = flip
        self.stride_rate = stride_rate
        self.window_batch = max(2, window_batch)
        self.device = torch.device(device or "cpu")
        self.dtype = getattr(model, "dtype", torch.float32)
        self._mean = torch.tensor(mean, dtype=torch.float32).view(3, 1, 1).to(self.device)
        self._std = (None if std is None else
                     torch.tensor(std, dtype=torch.float32).view(3, 1, 1).to(self.device))
        if fused_stitch is None:
            fused_stitch = (
                flip
                and self.device.type == "cuda"
                and supported(self.dtype)  # bf16 models
                and getattr(model, "zoom_factor", 1) != 1
            )
        self.fused_stitch = bool(fused_stitch)
        if self.fused_stitch and not flip:
            # the kernel averages (window, flipped-window) pairs
            raise ValueError("fused_stitch=True requires flip=True "
                             "(the kernel fuses the flip average)")
        self._geometries = {}

    # ------------------------------------------------------------------
    # window forward (normalize -> model -> softmax / fused stitch)
    # ------------------------------------------------------------------
    def _normalize(self, images):
        x = images - self._mean
        if self._std is not None:
            x = x / self._std
        return x

    def _forward_cf(self, images):
        """``[B, 3, h, w]`` raw 0-255 windows -> probs ``[B, C, h, w]``,
        bf16 containers on a bf16 model (softmax itself in float32)."""
        logits = self.model(self._normalize(images))
        probs = torch.softmax(logits.float(), dim=1)
        if self.dtype == torch.bfloat16:
            probs = probs.to(torch.bfloat16)
        return probs

    def _forward_fused_pairs(self, batch, wb):
        """``[2*wb, 3, h, w]`` (originals ++ flipped) -> averaged probs
        ``[wb, C, h, w]``: feature-resolution logits from the same model,
        then the fused upsample + softmax + flip kernel. The model returns
        float32 logits whose values are exact in its compute dtype, so the
        cast to it loses nothing."""
        logits = self.model(self._normalize(batch), zoom=False)
        pairs = torch.stack([logits[:wb], logits[wb:]], dim=1).to(self.dtype)
        return upsample_softmax_flip(pairs.contiguous(), (self.crop_h, self.crop_w))

    # ------------------------------------------------------------------
    # one scale's pipeline
    # ------------------------------------------------------------------
    def _geometry(self, h, w) -> _Geometry:
        key = (h, w)
        if key in self._geometries:
            return self._geometries[key]
        crop_h, crop_w = self.crop_h, self.crop_w
        new_h, new_w = _scaled_size(h, w, self.scale, self.base_size)
        pad_h = max(crop_h - new_h, 0)
        pad_w = max(crop_w - new_w, 0)
        canvas_h, canvas_w = new_h + pad_h, new_w + pad_w
        coords = _grid_coords(canvas_h, canvas_w, crop_h, crop_w, self.stride_rate)
        # Coverage is separable (the grid is a product of row and column
        # origins): count = rows (x) cols.
        rows = np.zeros(canvas_h, np.float32)
        cols = np.zeros(canvas_w, np.float32)
        for s_h in sorted({c[0] for c in coords}):
            rows[s_h:s_h + crop_h] += 1.0
        for s_w in sorted({c[1] for c in coords}):
            cols[s_w:s_w + crop_w] += 1.0
        count = torch.from_numpy(np.outer(rows, cols)).to(self.device)
        # Fixed chunk size (window_batch, halved under flip); the last
        # chunk is padded with window (0, 0), whose result is dropped.
        wb = min(max(1, self.window_batch // (2 if self.flip else 1)), len(coords))
        chunks, n_real = [], []
        for i in range(0, len(coords), wb):
            chunk = coords[i:i + wb]
            n_real.append(len(chunk))
            chunks.append(chunk + [(0, 0)] * (wb - len(chunk)))
        geom = _Geometry(new_h, new_w, pad_h // 2, pad_w // 2, canvas_h,
                         canvas_w, chunks, n_real, count)
        self._geometries[key] = geom
        return geom

    def _scale_probs(self, image: np.ndarray) -> torch.Tensor:
        """One RGB ``[h, w, 3]`` image (uint8 or float, 0-255) -> class
        probabilities ``[C, h, w]`` on the device (bf16 on a bf16 model)."""
        h, w, _ = image.shape
        g = self._geometry(h, w)
        crop_h, crop_w = self.crop_h, self.crop_w
        # upload as is (uint8 ships a quarter of the float32 bytes)
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        img = img.permute(2, 0, 1).float()
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
            wb = len(chunk)
            if self.flip:
                batch = torch.cat([wins, wins.flip(-1)])
            else:
                batch = wins
            if self.fused_stitch:
                probs = self._forward_fused_pairs(batch, wb)
            else:
                probs = self._forward_cf(batch)
                if self.flip:
                    # un-flip = reverse W after the softmax
                    probs = (probs[:wb] + probs[wb:].flip(-1)) / 2
            for i, (y, x) in enumerate(chunk[:n_real]):
                acc[:, y:y + crop_h, x:x + crop_w] += probs[i]
        acc /= g.count
        # 4) un-pad, resize back to the original resolution
        acc = acc[:, g.pad_h_half:g.pad_h_half + g.new_h,
                  g.pad_w_half:g.pad_w_half + g.new_w]
        # bf16 models carry the count-divided probs as bf16 into the
        # final resize (the JAX package's bf16 license); float32 stays exact
        if self.dtype == torch.bfloat16:
            acc = acc.to(torch.bfloat16)
        return resize_bilinear_half_pixel_cf(acc, (h, w))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_probs(self, image: np.ndarray) -> np.ndarray:
        """Class probabilities ``[h, w, C]`` float32 for one RGB image
        (bf16 models' bf16 probabilities are widened exactly)."""
        return self._scale_probs(image).float().permute(1, 2, 0).cpu().numpy()

    @torch.inference_mode()
    def predict_async(self, image: np.ndarray) -> torch.Tensor:
        """The uint8 class map ``[h, w]`` as a device tensor; on CUDA the
        work is queued and the call returns before it finishes."""
        return torch.argmax(self._scale_probs(image), dim=0).to(torch.uint8)

    def predict(self, image: np.ndarray) -> np.ndarray:
        """argmax class map for one image (uint8)."""
        return self.predict_async(image).cpu().numpy()
