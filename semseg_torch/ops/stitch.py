"""Fused per-window upsample + softmax + flip-average (CUDA kernel).

Port of ``semseg_tpu/ops/stitch_pallas.py``. For window pairs of logits
at feature resolution (half 0 the window's forward, half 1 the forward of
the horizontally flipped window, exactly as the model emits them) it
returns the flip-averaged class probabilities at crop resolution:

    probs = (softmax(up(L_orig)) + mirror(softmax(up(L_flip)))) / 2

``up`` is the model's own align-corners zoom upsample (reference
``model/pspnet.py:94-95``) and the mirror folds into the interpolation
weights (``Rw[:, ::-1]``), so it moves no data. On a CUDA tensor
``upsample_softmax_flip`` launches the kernel in ``csrc/stitch.cu`` or
raises; on a CPU tensor it runs ``upsample_softmax_flip_reference``, the
plain PyTorch version with the same rounding points.

The Pallas kernel's TPU artefacts are not carried over: no 32-row strips
with padded rows, no 128-lane padding of the logits and no scoped-VMEM
model. The kernel covers any class count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from semseg_torch.ops.resize import interp_matrix


def supported(dtype) -> bool:
    """Dispatch rule: the kernel takes bfloat16 logits, any class count
    and any crop. float32 models keep the exact unfused path."""
    return dtype == torch.bfloat16


def _weights(in_size: int, out_size: int, dtype, device) -> torch.Tensor:
    """``[out, in]`` align-corners weights rounded once to ``dtype`` (as
    the Pallas wrapper passes them), held as float32 values."""
    return interp_matrix(in_size, out_size, False, device).to(dtype).float()


@functools.lru_cache(maxsize=None)
def _taps(in_size: int, out_size: int, device: torch.device):
    """The bf16-rounded weight matrix as two taps per output index:
    int32 ``[out, 2]`` source indices and float32 ``[out, 2]`` weights.
    Rows with one non-zero weight carry it on the first tap and 0 on the
    second."""
    m = _weights(in_size, out_size, torch.bfloat16, torch.device("cpu"))
    idx = torch.zeros((out_size, 2), dtype=torch.int32)
    w = torch.zeros((out_size, 2), dtype=torch.float32)
    for r in range(out_size):
        nz = torch.nonzero(m[r]).flatten().tolist()
        if len(nz) > 2:
            raise AssertionError(f"row {r} has {len(nz)} taps")
        idx[r, 0], idx[r, 1] = nz[0], nz[-1]
        w[r, 0] = m[r, nz[0]]
        if len(nz) == 2:
            w[r, 1] = m[r, nz[1]]
    return idx.to(device), w.to(device)


def upsample_softmax_flip_reference(logits_pairs: torch.Tensor,
                                    out_hw) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the kernel's rounding
    points: weights rounded to the input dtype, H pass accumulated in
    float32, then (bf16 input only) rounded to bf16, W pass in float32,
    float32 softmax over classes times 0.5, each half cast to the output
    dtype before the add. float32 input stays float32 throughout."""
    p_n, two, c, hs, ws = logits_pairs.shape
    if two != 2:
        raise ValueError(f"expected [P, 2, C, hs, ws], got {tuple(logits_pairs.shape)}")
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    dt = logits_pairs.dtype
    low = dt == torch.bfloat16
    out_dtype = torch.bfloat16 if low else torch.float32
    dev = logits_pairs.device
    rh = _weights(hs, out_h, dt, dev)                      # [out_h, hs]
    rw = _weights(ws, out_w, dt, dev)                      # [out_w, ws]
    rw = torch.stack([rw, rw.flip(0)])[None, :, None]     # [1, 2, 1, out_w, ws]
    t = torch.matmul(rh, logits_pairs.float())             # [P, 2, C, out_h, ws]
    if low:
        t = t.to(torch.bfloat16).float()
    t = torch.matmul(t, rw.transpose(-1, -2))              # [P, 2, C, out_h, out_w]
    p = torch.softmax(t, dim=2) * 0.5
    return p[:, 0].to(out_dtype) + p[:, 1].to(out_dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    from semseg_torch.ops._build import load_library

    lib = load_library("stitch")
    fn = lib.semseg_stitch_upsample_softmax_flip
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def upsample_softmax_flip(logits_pairs: torch.Tensor, out_hw) -> torch.Tensor:
    """Fused zoom-upsample + softmax + flip-TTA average.

    ``logits_pairs``: ``[P, 2, C, hs, ws]`` window-pair logits at feature
    resolution. Returns ``[P, C, out_h, out_w]`` averaged probabilities,
    bf16 for bf16 input (the evaluator's container dtype). CPU tensors run
    the plain version; CUDA tensors must be contiguous bf16 and run the
    kernel, which adds one to ``upsample_softmax_flip.launches``.
    """
    if logits_pairs.device.type == "cpu":
        return upsample_softmax_flip_reference(logits_pairs, out_hw)
    if logits_pairs.device.type != "cuda":
        raise ValueError(f"unsupported device {logits_pairs.device}")
    if logits_pairs.dim() != 5 or logits_pairs.shape[1] != 2:
        raise ValueError(f"expected [P, 2, C, hs, ws], got {tuple(logits_pairs.shape)}")
    if not supported(logits_pairs.dtype):
        raise ValueError(f"the CUDA kernel takes bfloat16, got {logits_pairs.dtype}")
    if not logits_pairs.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous tensor")
    p_n, _, c, hs, ws = logits_pairs.shape
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    dev = logits_pairs.device
    out = torch.empty((p_n, c, out_h, out_w), dtype=torch.bfloat16, device=dev)
    row_idx, row_w = _taps(hs, out_h, dev)
    col_idx, col_w = _taps(ws, out_w, dev)
    fn = _lib()
    with torch.cuda.device(dev):
        rc = fn(logits_pairs.data_ptr(), out.data_ptr(), row_idx.data_ptr(),
                row_w.data_ptr(), col_idx.data_ptr(), col_w.data_ptr(),
                p_n, c, hs, ws, out_h, out_w,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stitch kernel launch failed: cudaError {rc}")
    upsample_softmax_flip.launches += 1
    return out


upsample_softmax_flip.launches = 0
