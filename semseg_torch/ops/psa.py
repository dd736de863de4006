"""Fused PSA attention aggregation (CUDA kernels), forward and backward.

Port of ``semseg_tpu/ops/psa_pallas.py``. Computes

    out[n, c, j] = (1/norm) * sum_i x[n, c, i] * softmax_i(A[n, i, j])

the softmax(dim=1) + bmm hot spot of the PSA module (reference
``model/psanet.py:68-70``), without writing the softmaxed ``(H*W)^2``
attention to device memory. ``x`` is ``[N, C, HW]`` and ``A`` is
``[N, HW, HW]``, both bfloat16 or both float32; the output is float32
``[N, C, HW]`` and all in-kernel math is float32 (the JAX contract:
``_precision_for`` gives HIGHEST for f32, and bf16 operands are held to the
f32 reference on the same bf16 values).

Five kernels in ``csrc/psa.cu``. Forward, picked by
:func:`select_psa_kernel`:
- **resident** (:func:`psa_softmax_bmm`): an exact column softmax per
  query tile (a first pass over all source rows for the column max ``m``
  and sum ``l``, a second that contracts ``p`` against ``x``);
- **flash** (:func:`psa_softmax_bmm_flash`): one pass over the source
  rows with an online softmax (running max ``m``, running sum ``l``).
Backward, from the forward's ``m``, ``l`` and output (p is recomputed as
``exp(A - m) / l``; the softmax VJP's column term comes from the flash
identity ``sum_i p * dP = sum_c g * out``):
- resident: :func:`psa_softmax_bmm_bwd_da` and :func:`psa_softmax_bmm_bwd_dx`;
- flash: :func:`psa_softmax_bmm_flash_bwd`, both gradients in one launch.

:func:`psa_softmax_bmm` and :func:`psa_softmax_bmm_flash` are
differentiable: while grad is enabled and an input requires it, they run
through a ``torch.autograd.Function`` whose backward is the matching
backward kernel(s), from the saved x, a, out, m and l. Gradients come back in the primal dtypes. On CPU
tensors every entry point runs its plain PyTorch version (autograd runs
through the same Functions); on CUDA tensors it launches its kernel or
raises. Each kernel's wrapper counts its launches in ``.launches``.
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
    """Plain version of the forward kernels' softmax statistics: ``m`` =
    column max and ``l`` = sum of ``exp(a - m)`` over axis 1, float32
    ``[N, HW]``."""
    af = a.float()
    m = af.amax(dim=1)
    return m, torch.exp(af - m[:, None, :]).sum(dim=1)


def _probs(a, m, l):
    return torch.exp(a.float() - m[:, None, :]) / l[:, None, :]


def _delta(g, out):
    """The softmax VJP's column term, ``sum_c g * out``, float32 ``[N, HW]``
    (``psa_pallas.py:424-427``)."""
    return (g.float() * out).sum(dim=1)


def psa_softmax_bmm_bwd_da_reference(x, a, g, m, l, out, norm: float = 1.0):
    """Plain version of the da kernels: ``da = p * (x^T g / norm - delta)``
    in float32 from ``p = exp(a - m) / l`` and ``delta = sum_c g * out``,
    returned in ``a``'s dtype."""
    dp = torch.bmm(x.float().transpose(1, 2), g.float()) / norm
    return (_probs(a, m, l) * (dp - _delta(g, out)[:, None, :])).to(a.dtype)


def psa_softmax_bmm_bwd_dx_reference(x, a, g, m, l, norm: float = 1.0):
    """Plain version of the dx kernels: ``dx = g p^T / norm`` in float32,
    returned in ``x``'s dtype."""
    return (torch.bmm(g.float(), _probs(a, m, l).transpose(1, 2)) / norm).to(x.dtype)


def psa_softmax_bmm_bwd_reference(x, a, g, m, l, out, norm: float = 1.0):
    """Plain version of the backward kernels: ``(dx, da)`` for the upstream
    gradient ``g`` of ``out``,

        da = p * (x^T g / norm - delta),   dx = g p^T / norm,

    in the dtypes of ``x`` and ``a`` (``psa_pallas.py:209-214``)."""
    return (psa_softmax_bmm_bwd_dx_reference(x, a, g, m, l, norm),
            psa_softmax_bmm_bwd_da_reference(x, a, g, m, l, out, norm))


def select_psa_kernel(c: int, hw: int, dtype=torch.bfloat16) -> str:
    """'resident' for ``hw <= RESIDENT_MAX_HW``, else 'flash'.

    Gives the JAX package's choices at the three recipe extents (hw 900
    and 2025 resident, 7921 flash). The TPU rule's scoped-VMEM model and
    its ``SEMSEG_*`` overrides are not carried over: on Hopper no kernel's
    shared memory depends on ``hw`` or ``C``. ``c`` and ``dtype`` are kept
    for the rule's signature."""
    del c, dtype
    return "resident" if hw <= RESIDENT_MAX_HW else "flash"


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    from semseg_torch.ops._build import load_library

    lib = load_library("psa")
    signatures = {
        "semseg_psa_softmax_bmm": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
        "semseg_psa_softmax_bmm_flash": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
        "semseg_psa_bwd_da": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
        "semseg_psa_bwd_dx": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
        "semseg_psa_flash_bwd": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    }
    fns = {}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _check_cuda(x: torch.Tensor, a: torch.Tensor) -> None:
    """Raise on operands the CUDA kernels do not take."""
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


def _check_cuda_f32(x: torch.Tensor, **tensors) -> None:
    """Raise unless each of ``tensors`` is contiguous float32 on ``x``'s
    device with the shape the backward kernels read (g and out
    ``[N, C, HW]``, m and l ``[N, HW]``)."""
    n, c, hw = x.shape
    for name, t in tensors.items():
        want = (n, c, hw) if name in ("g", "out") else (n, hw)
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be float32 {want} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def _launch(name: str, x: torch.Tensor, *args) -> None:
    with torch.cuda.device(x.device):
        rc = _lib()[name](*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PSA kernel {name} launch failed: cudaError {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _needs_grad(x, a) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or a.requires_grad)


def _forward(x, a, norm, flash: bool, stats: bool):
    """One forward launch (or its plain version on the CPU): ``out`` and,
    with ``stats``, ``m`` and ``l``."""
    if x.device.type == "cpu" and a.device.type == "cpu":
        out = psa_softmax_bmm_reference(x, a, norm)
        return (out, *psa_softmax_stats(a)) if stats else out
    _check_cuda(x, a)
    n, c, hw = x.shape
    out = torch.empty((n, c, hw), dtype=torch.float32, device=x.device)
    m = l = None
    if stats or flash:  # the flash kernel always writes them
        m = torch.empty((n, hw), dtype=torch.float32, device=x.device)
        l = torch.empty((n, hw), dtype=torch.float32, device=x.device)
    name = "semseg_psa_softmax_bmm_flash" if flash else "semseg_psa_softmax_bmm"
    _launch(name, x, _ptr(x), _ptr(a), _ptr(out), _ptr(m), _ptr(l),
            n, c, hw, 1.0 / norm, int(x.dtype == torch.bfloat16))
    wrapper = psa_softmax_bmm_flash if flash else psa_softmax_bmm
    wrapper.launches += 1
    return (out, m, l) if stats else out


class _PSA(torch.autograd.Function):
    """The fused aggregation with the resident (``flash=False``) or the
    flash kernels, forward and backward. Saves x, a, out, m and l."""

    @staticmethod
    def forward(ctx, x, a, norm, flash):
        out, m, l = _forward(x, a, norm, flash=flash, stats=True)
        ctx.save_for_backward(x, a, out, m, l)
        ctx.norm, ctx.flash = norm, flash
        return out

    @staticmethod
    def backward(ctx, g):
        x, a, out, m, l = ctx.saved_tensors
        g = g.contiguous()
        if ctx.flash:
            return (*psa_softmax_bmm_flash_bwd(x, a, g, m, l, out, ctx.norm), None, None)
        dx = da = None
        if ctx.needs_input_grad[0]:
            dx = psa_softmax_bmm_bwd_dx(x, a, g, m, l, ctx.norm)
        if ctx.needs_input_grad[1]:
            da = psa_softmax_bmm_bwd_da(x, a, g, m, l, out, ctx.norm)
        return dx, da, None, None


def psa_softmax_bmm(x: torch.Tensor, a: torch.Tensor, norm: float = 1.0,
                    return_stats: bool = False):
    """``(1/norm) * x @ softmax(a, dim=1)`` with the resident kernel.

    Returns float32 ``[N, C, HW]``, or ``(out, m, l)`` with
    ``return_stats`` (forward only; the statistics carry no graph). While
    grad is enabled and an input requires it, the call is differentiable
    through the resident backward kernels. CPU tensors run the plain
    version; CUDA tensors run the kernel and add one to
    ``psa_softmax_bmm.launches``."""
    if _needs_grad(x, a):
        if return_stats:
            raise ValueError("return_stats is forward-only: call under torch.no_grad()")
        return _PSA.apply(x, a, norm, False)
    return _forward(x, a, norm, flash=False, stats=return_stats)


psa_softmax_bmm.launches = 0


def psa_softmax_bmm_flash(x: torch.Tensor, a: torch.Tensor, norm: float = 1.0,
                          return_stats: bool = False):
    """``(1/norm) * x @ softmax(a, dim=1)`` with the flash kernel.

    Returns float32 ``[N, C, HW]``, or ``(out, m, l)`` with
    ``return_stats``: the column max and the sum of ``exp(a - m)``, float32
    ``[N, HW]`` (forward only, as for :func:`psa_softmax_bmm`). While grad is
    enabled and an input requires it, the call is differentiable through
    the flash backward kernel. CPU tensors run the plain version; CUDA
    tensors run the kernel and add one to ``psa_softmax_bmm_flash.launches``."""
    if _needs_grad(x, a):
        if return_stats:
            raise ValueError("return_stats is forward-only: call under torch.no_grad()")
        return _PSA.apply(x, a, norm, True)
    return _forward(x, a, norm, flash=True, stats=return_stats)


psa_softmax_bmm_flash.launches = 0


def psa_softmax_bmm_bwd_da(x, a, g, m, l, out, norm: float = 1.0) -> torch.Tensor:
    """Resident backward, ``da = p * (x^T g / norm - sum_c g * out)`` in
    ``a``'s dtype (``psa_pallas.py::_bwd_da_kernel``). CPU tensors run the
    plain version; CUDA tensors run the kernel and add one to
    ``psa_softmax_bmm_bwd_da.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_da_reference(x, a, g, m, l, out, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l, out=out)
    n, c, hw = x.shape
    delta = _delta(g, out)
    da = torch.empty_like(a)
    _launch("semseg_psa_bwd_da", x, _ptr(x), _ptr(a), _ptr(g), _ptr(m), _ptr(l),
            _ptr(delta), _ptr(da), n, c, hw, 1.0 / norm, int(x.dtype == torch.bfloat16))
    psa_softmax_bmm_bwd_da.launches += 1
    return da


psa_softmax_bmm_bwd_da.launches = 0


def psa_softmax_bmm_bwd_dx(x, a, g, m, l, norm: float = 1.0) -> torch.Tensor:
    """Resident backward, ``dx = g p^T / norm`` in ``x``'s dtype
    (``psa_pallas.py::_bwd_dx_kernel``; ``x`` gives the shape and dtype
    only). CPU tensors run the plain version; CUDA tensors run the kernel
    and add one to ``psa_softmax_bmm_bwd_dx.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_dx_reference(x, a, g, m, l, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l)
    n, c, hw = x.shape
    dx = torch.empty((n, c, hw), dtype=torch.float32, device=x.device)
    _launch("semseg_psa_bwd_dx", x, _ptr(a), _ptr(g), _ptr(m), _ptr(l), _ptr(dx),
            n, c, hw, 1.0 / norm, int(x.dtype == torch.bfloat16))
    psa_softmax_bmm_bwd_dx.launches += 1
    return dx.to(x.dtype)


psa_softmax_bmm_bwd_dx.launches = 0


def psa_softmax_bmm_flash_bwd(x, a, g, m, l, out, norm: float = 1.0):
    """Flash backward, ``(dx, da)`` in one launch
    (``psa_pallas.py::_flash_bwd_kernel``), in the dtypes of ``x`` and
    ``a``. CPU tensors run the plain version; CUDA tensors run the kernel and
    add one to ``psa_softmax_bmm_flash_bwd.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_reference(x, a, g, m, l, out, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l, out=out)
    n, c, hw = x.shape
    delta = _delta(g, out)
    da = torch.empty_like(a)
    dx = torch.empty((n, c, hw), dtype=torch.float32, device=x.device)
    _launch("semseg_psa_flash_bwd", x, _ptr(x), _ptr(a), _ptr(g), _ptr(m), _ptr(l),
            _ptr(delta), _ptr(da), _ptr(dx), n, c, hw, 1.0 / norm,
            int(x.dtype == torch.bfloat16))
    psa_softmax_bmm_flash_bwd.launches += 1
    return dx.to(x.dtype), da


psa_softmax_bmm_flash_bwd.launches = 0


def psa_softmax_bmm_auto(x: torch.Tensor, a: torch.Tensor,
                         norm: float = 1.0) -> torch.Tensor:
    """Fused PSA aggregation with the kernel that :func:`select_psa_kernel`
    picks for the shape (differentiable, as the two entry points are)."""
    _, c, hw = x.shape
    if select_psa_kernel(c, hw, x.dtype) == "resident":
        return psa_softmax_bmm(x, a, norm)
    return psa_softmax_bmm_flash(x, a, norm)
