"""Plain sliding-window evaluation (hszhao/semseg ``tool/test.py``).

For each scale the image's long side goes to ``round(scale * base_size)``
(bilinear on the cv2 ``INTER_LINEAR`` grid), the image is padded with the
mean to at least the crop, windows on a ``ceil(crop * stride_rate)``
stride run through the model with their mirror images, the softmax of the
zoomed logits is averaged with the mirror's, the windows' probabilities
are summed and divided by the count of windows over each pixel, the pad is
cut off and the map resized back. The scales' maps are averaged. All of it
in float32 on the model's device.
"""

from __future__ import annotations

import math

import torch


def linear_resize(x, out_h, out_w):
    """cv2 ``INTER_LINEAR`` on ``[..., H, W]``: ``src = (dst + 0.5) * in /
    out - 0.5`` clipped to ``[0, in - 1]``, two taps an axis."""

    def axis(t, dim, n_out):
        n_in = t.shape[dim]
        if n_in == n_out:
            return t
        src = (torch.arange(n_out, device=t.device, dtype=torch.float64) + 0.5) \
            * (n_in / n_out) - 0.5
        src = src.clamp(0, n_in - 1)
        lo = src.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(max=n_in - 1)
        frac = (src - lo).float()
        shape = [1] * t.dim()
        shape[dim] = n_out
        frac = frac.view(shape)
        return t.index_select(dim, lo) * (1 - frac) + t.index_select(dim, hi) * frac

    return axis(axis(x, x.dim() - 2, out_h), x.dim() - 1, out_w)


def scaled_size(h, w, scale, base_size):
    long_size = round(scale * base_size)
    if h > w:
        return long_size, round(long_size / float(h) * w)
    return round(long_size / float(w) * h), long_size


def grid(h, w, crop, stride_rate):
    stride = int(math.ceil(crop * stride_rate))
    rows = int(math.ceil(float(h - crop) / stride) + 1)
    cols = int(math.ceil(float(w - crop) / stride) + 1)
    return [(min(r * stride + crop, h) - crop, min(c * stride + crop, w) - crop)
            for r in range(rows) for c in range(cols)]


@torch.no_grad()
def mean_probs(model, image, *, crop, base_size, scales, mean, std, stride_rate=2 / 3,
               batch=8, dtype=torch.float32):
    """float32 ``[C, H, W]``: the mean over ``scales`` of the flip-averaged
    window probabilities of one RGB ``[H, W, 3]`` image (uint8, any
    device) through ``model`` in eval mode; the windows enter the model in
    ``dtype`` (a bfloat16 model takes bfloat16 windows), the rest is
    float32."""
    dev = next(model.parameters()).device
    img = torch.as_tensor(image).to(dev).permute(2, 0, 1).float()
    _, h, w = img.shape
    mean_t = torch.tensor(mean, device=dev).view(3, 1, 1)
    std_t = torch.tensor(std, device=dev).view(3, 1, 1)
    total = None
    for scale in scales:
        new_h, new_w = scaled_size(h, w, scale, base_size)
        x = linear_resize(img, new_h, new_w)
        pad_h, pad_w = max(crop - new_h, 0), max(crop - new_w, 0)
        top, left = pad_h // 2, pad_w // 2
        canvas = mean_t.expand(3, new_h + pad_h, new_w + pad_w).clone()
        canvas[:, top:top + new_h, left:left + new_w] = x
        canvas = (canvas - mean_t) / std_t
        ch, cw = canvas.shape[1:]
        coords = grid(ch, cw, crop, stride_rate)
        acc = None
        count = torch.zeros(1, ch, cw, device=dev)
        for i in range(0, len(coords), batch):
            part = coords[i:i + batch]
            wins = torch.stack([canvas[:, y:y + crop, x0:x0 + crop] for y, x0 in part])
            logits = model(torch.cat([wins, wins.flip(-1)]).to(dtype))
            p = torch.softmax(logits.float(), dim=1)
            p = (p[:len(part)] + p[len(part):].flip(-1)) / 2
            if acc is None:
                acc = torch.zeros(p.shape[1], ch, cw, device=dev)
            for k, (y, x0) in enumerate(part):
                acc[:, y:y + crop, x0:x0 + crop] += p[k]
                count[:, y:y + crop, x0:x0 + crop] += 1
        acc = (acc / count)[:, top:top + new_h, left:left + new_w]
        probs = linear_resize(acc, h, w)
        total = probs if total is None else total + probs
    return total / len(scales)
