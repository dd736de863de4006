"""Fused PSA attention aggregation (CUDA kernels), forward.

Port of the forward half of ``semseg_tpu/ops/psa_pallas.py``. Computes

    out[n, c, j] = (1/norm) * sum_i x[n, c, i] * softmax_i(A[n, i, j])

the softmax(dim=1) + bmm hot spot of the PSA module (reference
``model/psanet.py:68-70``), without writing the softmaxed ``(H*W)^2``
attention to device memory. ``x`` is ``[N, C, HW]`` and ``A`` is
``[N, HW, HW]``, both bfloat16 or both float32; the output is float32
``[N, C, HW]`` and all in-kernel math is float32 (the JAX contract:
``_precision_for`` gives HIGHEST for f32, and bf16 operands are held to the
f32 reference on the same bf16 values).

Two kernels in ``csrc/psa.cu``, picked by :func:`select_psa_kernel`:
- **resident** (:func:`psa_softmax_bmm`): an exact column softmax per
  query tile (a first pass over all source rows for the column max and
  sum, a second that contracts ``p`` against ``x``);
- **flash** (:func:`psa_softmax_bmm_flash`): one pass over the source
  rows with an online softmax (running max ``m``, running sum ``l``); it
  reads ``A`` once and can return ``m`` and ``l`` for a backward.

On a CPU tensor each entry point runs its plain PyTorch version; on a
CUDA tensor it launches its kernel or raises. The backward kernels are not
ported yet (ROADMAP queue 2 items 3, 4 and 6), so inputs that require grad
while grad is enabled raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Dispatch threshold of the Hopper rule (see select_psa_kernel).
RESIDENT_MAX_HW = 2048


def psa_softmax_bmm_reference(x: torch.Tensor, a: torch.Tensor,
                              norm: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version (JAX ``psa_pallas.py:242``): float32 softmax
    over axis 1, float32 bmm, divided by ``norm``."""
    p = torch.softmax(a.float(), dim=1)
    return torch.bmm(x.float(), p) / norm


def psa_softmax_stats(a: torch.Tensor):
    """Plain version of the flash kernel's softmax statistics: ``m`` = column max and ``l`` =
    sum of ``exp(a - m)`` over axis 1, float32 ``[N, HW]``."""
    af = a.float()
    m = af.amax(dim=1)
    return m, torch.exp(af - m[:, None, :]).sum(dim=1)


def select_psa_kernel(c: int, hw: int, dtype=torch.bfloat16) -> str:
    """'resident' for ``hw <= RESIDENT_MAX_HW``, else 'flash'.

    Gives the JAX package's choices at the three recipe extents (hw 900
    and 2025 resident, 7921 flash). The TPU rule's scoped-VMEM model and
    its ``SEMSEG_*`` overrides are not carried over: on Hopper neither
    kernel's shared memory depends on ``hw`` or ``C``. ``c`` and ``dtype``
    are kept for the rule's signature."""
    del c, dtype
    return "resident" if hw <= RESIDENT_MAX_HW else "flash"


@functools.lru_cache(maxsize=None)
def _lib():
    from semseg_torch.ops._build import load_library

    lib = load_library("psa")
    fwd = lib.semseg_psa_softmax_bmm
    fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    flash = lib.semseg_psa_softmax_bmm_flash
    flash.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    flash.restype = ctypes.c_int
    return fwd, flash


def _check_cuda(x: torch.Tensor, a: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take."""
    if x.device.type != "cuda" or a.device != x.device:
        raise ValueError(f"x and a must share one CUDA device, got {x.device}, {a.device}")
    if x.dim() != 3 or a.dim() != 3:
        raise ValueError(f"expected x [N, C, HW] and a [N, HW, HW], got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}")
    n, _, hw = x.shape
    if tuple(a.shape) != (n, hw, hw):
        raise ValueError(f"a must be [N, HW, HW] = {(n, hw, hw)}, got {tuple(a.shape)}")
    if x.dtype != a.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernels take x and a both bfloat16 or both "
                         f"float32, got {x.dtype} and {a.dtype}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous tensors")
    if torch.is_grad_enabled() and (x.requires_grad or a.requires_grad):
        raise NotImplementedError(
            "the PSA kernels have no backward yet (ROADMAP queue 2 items 3, 4 "
            "and 6); call them under torch.no_grad() or inference_mode()")


def psa_softmax_bmm(x: torch.Tensor, a: torch.Tensor,
                    norm: float = 1.0) -> torch.Tensor:
    """``(1/norm) * x @ softmax(a, dim=1)`` with the resident kernel.

    Returns float32 ``[N, C, HW]``. CPU tensors run the plain version;
    CUDA tensors run the kernel and add one to
    ``psa_softmax_bmm.launches``."""
    if x.device.type == "cpu" and a.device.type == "cpu":
        return psa_softmax_bmm_reference(x, a, norm)
    _check_cuda(x, a)
    n, c, hw = x.shape
    out = torch.empty((n, c, hw), dtype=torch.float32, device=x.device)
    fwd, _ = _lib()
    with torch.cuda.device(x.device):
        rc = fwd(x.data_ptr(), a.data_ptr(), out.data_ptr(), n, c, hw,
                 1.0 / norm, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PSA resident kernel launch failed: cudaError {rc}")
    psa_softmax_bmm.launches += 1
    return out


psa_softmax_bmm.launches = 0


def psa_softmax_bmm_flash(x: torch.Tensor, a: torch.Tensor, norm: float = 1.0,
                          return_stats: bool = False):
    """``(1/norm) * x @ softmax(a, dim=1)`` with the flash kernel.

    Returns float32 ``[N, C, HW]``, or ``(out, m, l)`` with
    ``return_stats``: the column max and the sum of ``exp(a - m)``, float32
    ``[N, HW]`` (what the flash backward reads). CPU tensors run the plain
    version; CUDA tensors run the kernel and add one to
    ``psa_softmax_bmm_flash.launches``."""
    if x.device.type == "cpu" and a.device.type == "cpu":
        out = psa_softmax_bmm_reference(x, a, norm)
        return (out, *psa_softmax_stats(a)) if return_stats else out
    _check_cuda(x, a)
    n, c, hw = x.shape
    out = torch.empty((n, c, hw), dtype=torch.float32, device=x.device)
    m = torch.empty((n, hw), dtype=torch.float32, device=x.device)
    l = torch.empty((n, hw), dtype=torch.float32, device=x.device)
    _, flash = _lib()
    with torch.cuda.device(x.device):
        rc = flash(x.data_ptr(), a.data_ptr(), out.data_ptr(), m.data_ptr(),
                   l.data_ptr(), n, c, hw, 1.0 / norm,
                   int(x.dtype == torch.bfloat16),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PSA flash kernel launch failed: cudaError {rc}")
    psa_softmax_bmm_flash.launches += 1
    return (out, m, l) if return_stats else out


psa_softmax_bmm_flash.launches = 0


def psa_softmax_bmm_auto(x: torch.Tensor, a: torch.Tensor,
                         norm: float = 1.0) -> torch.Tensor:
    """Fused PSA aggregation with the kernel that :func:`select_psa_kernel`
    picks for the shape."""
    _, c, hw = x.shape
    if select_psa_kernel(c, hw, x.dtype) == "resident":
        return psa_softmax_bmm(x, a, norm)
    return psa_softmax_bmm_flash(x, a, norm)
