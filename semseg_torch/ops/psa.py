"""Fused PSA attention aggregation (CUDA kernels), forward and backward.

Port of ``semseg_tpu/ops/psa_pallas.py``. Computes

    out[n, c, j] = (1/norm) * sum_i x[n, c, i] * softmax_i(A[n, i, j])

the softmax(dim=1) + bmm hot spot of the PSA module (reference
``model/psanet.py:68-70``), without writing the softmaxed ``(H*W)^2``
attention to device memory. ``x`` is ``[N, C, HW]`` and ``A`` is
``[N, HW, HW]``, both bfloat16 or both float32; the output is float32
``[N, C, HW]``. The operand dtype picks the precision, as the JAX kernels'
``_precision_for`` does: float32 operands run at HIGHEST precision, float32
products to within the 1e-5 bars (as 3xTF32 on the tensor cores);
bfloat16 operands may run the product at DEFAULT precision, one bf16 pass
with ``p`` (and ``g`` in the backward) rounded to bfloat16 and float32
sums.

Six kernels in ``csrc/psa.cu``, all on the tensor cores: for each operand
dtype a forward, a dx and a da kernel. Forward, picked by
:func:`select_psa_kernel`:
- **resident** (:func:`psa_softmax_bmm`): one pass over all source rows
  per query tile with an online softmax: float32 operands as 3xTF32
  (:func:`psa_softmax_bmm_tf32x3`: each operand split into a TF32 high
  part and a TF32 remainder, three wgmma passes into f32 sums), bfloat16
  operands in one bf16 pass (:func:`psa_softmax_bmm_wgmma`);
- **flash** (:func:`psa_softmax_bmm_flash`): the same kernel of the
  operands' dtype, which always writes the running max ``m`` and sum
  ``l``. The TPU split its forward in two to bound VMEM; on Hopper the
  resident kernel's shared memory does not depend on ``hw``, so the two
  entry points give bit-identical results.
Backward, from the forward's ``m``, ``l`` and output (p is recomputed as
``exp(A - m) / l``; the softmax VJP's column term comes from the flash
identity ``sum_i p * dP = sum_c g * out``):
- resident: :func:`psa_softmax_bmm_bwd_da` (float32 operands:
  :func:`psa_softmax_bmm_bwd_da_tf32x3`; bfloat16:
  :func:`psa_softmax_bmm_bwd_da_wgmma`) and :func:`psa_softmax_bmm_bwd_dx`
  (float32: :func:`psa_softmax_bmm_bwd_dx_tf32x3`; bfloat16:
  :func:`psa_softmax_bmm_bwd_dx_wgmma`);
- flash: :func:`psa_softmax_bmm_flash_bwd`, the same dx and da kernels
  launched in turn from the flash forward's ``m`` and ``l``.
The dtype rule is a rule, not a fallback: if a kernel does not build or a
launch fails, the call raises.

The forward without statistics is also the registered operator
``torch.ops.semseg.psa_softmax_bmm(x, a, norm, flash)``
(:func:`psa_softmax_bmm_op`): its CUDA implementation is the launch above,
its CPU implementation the plain version, and a fake implementation gives
``torch.export`` the output's shape and dtype. The kernels are ``ctypes``
calls, which a trace cannot follow; the operator is what a traced program
(``engine/export.py``) records in their place and runs on the card.

:func:`psa_softmax_bmm` and :func:`psa_softmax_bmm_flash` are
differentiable: while grad is enabled and an input requires it, they run
through a ``torch.autograd.Function`` whose backward is the matching
backward kernel(s), from the saved x, a, out, m and l. Gradients come back in the primal dtypes. On CPU
tensors every entry point runs its plain PyTorch version (autograd runs
through the same Functions); on CUDA tensors it launches its kernel or
raises. Each kernel's wrapper (the ``_wgmma`` and ``_tf32x3`` functions)
counts its launches in ``.launches``; the dtype-dispatching entry points
(:func:`psa_softmax_bmm`, :func:`psa_softmax_bmm_flash`, the two resident
backward ones and :func:`psa_softmax_bmm_flash_bwd`) count their calls on
CUDA tensors in theirs. The counters move only where the kernels launch,
never while a program is traced.
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


def psa_softmax_bmm_bf16_reference(x: torch.Tensor, a: torch.Tensor,
                                   norm: float = 1.0) -> torch.Tensor:
    """Plain version of the tensor-core forward: the float32 softmax over
    axis 1 rounded to bfloat16 (the TPU's DEFAULT-precision operand), then
    a float32 bmm with ``x``, divided by ``norm``. It rounds each term of p
    once, as the kernel does (the kernel rounds p times a per-column
    factor, so the two agree to the order of the sums and that rounding)."""
    p = torch.softmax(a.float(), dim=1).to(torch.bfloat16).float()
    return torch.bmm(x.float(), p) / norm


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest
    with ties away from zero, keeping 10 mantissa bits (the low 13 bits of
    the result are 0)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(v: torch.Tensor):
    """The 3xTF32 kernels' split of float32 ``v``: the TF32 high part
    ``hi = rna(v)`` and the TF32 remainder ``lo = rna(v - hi)``, both
    float32; ``hi + lo`` is ``v`` within 2^-22 |v|."""
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _tf32x3_bmm(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``u @ v`` as the 3xTF32 kernels form it: both operands split by
    :func:`tf32_split`, then ``lo hi + hi lo + hi hi`` in float32 (the
    ``lo lo`` term is dropped)."""
    uh, ul = tf32_split(u)
    vh, vl = tf32_split(v)
    return torch.bmm(ul, vh) + torch.bmm(uh, vl) + torch.bmm(uh, vh)


def psa_softmax_bmm_tf32x3_reference(x: torch.Tensor, a: torch.Tensor,
                                     norm: float = 1.0) -> torch.Tensor:
    """Plain version of the 3xTF32 forward: the float32 softmax over axis 1
    and ``x``, each split into TF32 high parts and remainders, multiplied
    as ``lo hi + hi lo + hi hi`` in float32, divided by ``norm``. It splits
    p where the kernel splits p times a per-column factor (its online
    softmax divides by the column sum at the end), so the two agree to the
    order of the sums and that rounding."""
    p = torch.softmax(a.float(), dim=1)
    return _tf32x3_bmm(x.float(), p) / norm


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


def psa_softmax_bmm_bwd_da_bf16_reference(x, a, g, m, l, out, norm: float = 1.0):
    """Plain version of the tensor-core da: ``g`` rounded to bfloat16 (the
    TPU's DEFAULT-precision operand; ``x`` is bfloat16 already), then the
    float32 math of :func:`psa_softmax_bmm_bwd_da_reference` with ``delta``
    from the float32 ``g``, returned in bfloat16."""
    gb = g.to(torch.bfloat16).float()
    dp = torch.bmm(x.float().transpose(1, 2), gb) / norm
    return (_probs(a, m, l) * (dp - _delta(g, out)[:, None, :])).to(torch.bfloat16)


def psa_softmax_bmm_bwd_da_tf32x3_reference(x, a, g, m, l, out, norm: float = 1.0):
    """Plain version of the 3xTF32 da: ``x`` and ``g`` split into TF32 high
    parts and remainders, ``dP = x^T g / norm`` as ``lo hi + hi lo + hi hi``
    in float32, then ``da = p * (dP - delta)`` with ``p = exp(a - m) / l``
    and ``delta = sum_c g * out`` in float32, returned in ``a``'s dtype."""
    dp = _tf32x3_bmm(x.float().transpose(1, 2), g.float()) / norm
    return (_probs(a, m, l) * (dp - _delta(g, out)[:, None, :])).to(a.dtype)


def psa_softmax_bmm_bwd_dx_reference(x, a, g, m, l, norm: float = 1.0):
    """Plain version of the dx kernels: ``dx = g p^T / norm`` in float32,
    returned in ``x``'s dtype."""
    return (torch.bmm(g.float(), _probs(a, m, l).transpose(1, 2)) / norm).to(x.dtype)


def psa_softmax_bmm_bwd_dx_bf16_reference(x, a, g, m, l, norm: float = 1.0):
    """Plain version of the tensor-core dx: ``p`` and ``g`` rounded to
    bfloat16, then ``g p^T / norm`` in float32, returned in ``x``'s
    dtype."""
    p = _probs(a, m, l).to(torch.bfloat16).float()
    gb = g.to(torch.bfloat16).float()
    return (torch.bmm(gb, p.transpose(1, 2)) / norm).to(x.dtype)


def psa_softmax_bmm_bwd_dx_tf32x3_reference(x, a, g, m, l, norm: float = 1.0):
    """Plain version of the 3xTF32 dx: ``g`` and ``p = exp(a - m) / l``
    split into TF32 high parts and remainders, ``g p^T / norm`` as ``lo hi
    + hi lo + hi hi`` in float32, returned in ``x``'s dtype."""
    return (_tf32x3_bmm(g.float(), _probs(a, m, l).transpose(1, 2)) / norm).to(x.dtype)


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
        "semseg_psa_softmax_bmm_wgmma": [_P] * 6 + [_I] * 3 + [_F, _P],
        "semseg_psa_bwd_dx_wgmma": [_P] * 6 + [_I] * 3 + [_F, _P],
        "semseg_psa_bwd_da_wgmma": [_P] * 8 + [_I] * 3 + [_F, _P],
        "semseg_psa_softmax_bmm_tf32x3": [_P] * 6 + [_I] * 3 + [_F, _P],
        "semseg_psa_bwd_dx_tf32x3": [_P] * 6 + [_I] * 3 + [_F, _P],
        "semseg_psa_bwd_da_tf32x3": [_P] * 8 + [_I] * 3 + [_F, _P],
    }
    fns = {}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    for name in ("semseg_psa_wgmma_pack_elems", "semseg_psa_da_wgmma_pack_elems",
                 "semseg_psa_tf32x3_pack_elems", "semseg_psa_da_tf32x3_pack_elems"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [_I] * 3, ctypes.c_longlong
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


def _check_bf16(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the bf16 tensor-core kernels take bfloat16 operands, got {x.dtype} "
                         "(float32 operands run the 3xTF32 kernels)")


def _check_f32(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"the 3xTF32 kernels take float32 operands, got {x.dtype} "
                         "(bfloat16 operands run the bf16 tensor-core kernels)")


def _wgmma_pack(x: torch.Tensor) -> torch.Tensor:
    """Scratch for the tensor-core kernels' bf16 copy of x or g, padded to
    whole tiles (``tc::pack_elems`` in ``csrc/psa.cu``)."""
    n, c, hw = x.shape
    elems = _lib()["semseg_psa_wgmma_pack_elems"](n, c, hw)
    return torch.empty(elems, dtype=torch.bfloat16, device=x.device)


def _tf32x3_pack(x: torch.Tensor) -> torch.Tensor:
    """Scratch for the 3xTF32 kernels' split copy of x or g, padded to
    whole tiles (``tc::tf32_pack_elems`` in ``csrc/psa.cu``)."""
    n, c, hw = x.shape
    elems = _lib()["semseg_psa_tf32x3_pack_elems"](n, c, hw)
    return torch.empty(elems, dtype=torch.float32, device=x.device)


def _forward(x, a, norm, flash: bool, stats: bool):
    """One forward launch (or its plain version on the CPU): ``out`` and,
    with ``stats``, ``m`` and ``l``. CUDA operands run the tensor-core
    forward of their dtype (bf16 or 3xTF32), the flash route always with
    ``m`` and ``l``, and count on the entry point of ``flash``."""
    if x.device.type == "cpu" and a.device.type == "cpu":
        out = psa_softmax_bmm_reference(x, a, norm)
        return (out, *psa_softmax_stats(a)) if stats else out
    _check_cuda(x, a)
    kernel = _forward_wgmma if x.dtype == torch.bfloat16 else _forward_tf32x3
    res = kernel(x, a, norm, stats or flash)
    (psa_softmax_bmm_flash if flash else psa_softmax_bmm).launches += 1
    return res if stats or not flash else res[0]


def _forward_wgmma(x, a, norm, stats: bool):
    """The tensor-core resident forward on checked bfloat16 CUDA operands."""
    n, c, hw = x.shape
    out = torch.empty((n, c, hw), dtype=torch.float32, device=x.device)
    m = l = None
    if stats:
        m = torch.empty((n, hw), dtype=torch.float32, device=x.device)
        l = torch.empty((n, hw), dtype=torch.float32, device=x.device)
    pack = _wgmma_pack(x)
    _launch("semseg_psa_softmax_bmm_wgmma", x, _ptr(x), _ptr(a), _ptr(out), _ptr(m), _ptr(l),
            _ptr(pack), n, c, hw, 1.0 / norm)
    psa_softmax_bmm_wgmma.launches += 1
    return (out, m, l) if stats else out


def _forward_tf32x3(x, a, norm, stats: bool):
    """The 3xTF32 resident forward on checked float32 CUDA operands."""
    n, c, hw = x.shape
    out = torch.empty((n, c, hw), dtype=torch.float32, device=x.device)
    m = l = None
    if stats:
        m = torch.empty((n, hw), dtype=torch.float32, device=x.device)
        l = torch.empty((n, hw), dtype=torch.float32, device=x.device)
    pack = _tf32x3_pack(x)
    _launch("semseg_psa_softmax_bmm_tf32x3", x, _ptr(x), _ptr(a), _ptr(out), _ptr(m), _ptr(l),
            _ptr(pack), n, c, hw, 1.0 / norm)
    psa_softmax_bmm_tf32x3.launches += 1
    return (out, m, l) if stats else out


@torch.library.custom_op("semseg::psa_softmax_bmm", mutates_args=(), device_types="cuda")
def psa_softmax_bmm_op(x: torch.Tensor, a: torch.Tensor, norm: float,
                       flash: bool) -> torch.Tensor:
    """The forward as an operator, ``torch.ops.semseg.psa_softmax_bmm``:
    float32 ``[N, C, HW]``. On CUDA tensors, one launch of the tensor-core
    forward of the operands' dtype (bf16 or 3xTF32), counted on its kernel
    and on :func:`psa_softmax_bmm_flash` (``flash``) or
    :func:`psa_softmax_bmm`; on CPU tensors the plain version. Forward only:
    the differentiable path is :class:`_PSA`."""
    return _forward(x, a, norm, flash=flash, stats=False)


@psa_softmax_bmm_op.register_kernel("cpu")
def _psa_softmax_bmm_op_cpu(x, a, norm, flash):
    del flash  # one plain version for both entry points
    return psa_softmax_bmm_reference(x, a, norm)


@psa_softmax_bmm_op.register_fake
def _psa_softmax_bmm_op_fake(x, a, norm, flash):
    n, c, hw = x.shape
    return x.new_empty((n, c, hw), dtype=torch.float32)


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
    version; float32 CUDA tensors run the 3xTF32 kernel and add one to
    ``psa_softmax_bmm_tf32x3.launches``; bfloat16 CUDA tensors run the bf16
    tensor-core kernel and add one to ``psa_softmax_bmm_wgmma.launches``;
    either adds one to ``psa_softmax_bmm.launches``."""
    if _needs_grad(x, a):
        if return_stats:
            raise ValueError("return_stats is forward-only: call under torch.no_grad()")
        return _PSA.apply(x, a, norm, False)
    if return_stats:
        return _forward(x, a, norm, flash=False, stats=True)
    return psa_softmax_bmm_op(x, a, norm, False)


psa_softmax_bmm.launches = 0


def psa_softmax_bmm_wgmma(x: torch.Tensor, a: torch.Tensor, norm: float = 1.0,
                          return_stats: bool = False):
    """The resident forward on the tensor cores, for bfloat16 operands:
    ``(1/norm) * x @ p`` with ``p = softmax(a, dim=1)``, each term of p
    rounded once to bfloat16 and the sums in float32
    (``psa_pallas.py::_fwd_kernel`` at DEFAULT precision). The kernel's
    softmax is online: it rounds ``exp(a - m)`` for the running column max
    ``m`` and divides by the column sum at the end, which is ``p`` up to a
    per-column float32 factor.
    Returns float32 ``[N, C, HW]``, or ``(out, m, l)`` with
    ``return_stats``. Forward only: :func:`psa_softmax_bmm` is the
    differentiable entry point and calls this kernel for bf16 operands. CPU
    tensors run the plain version (:func:`psa_softmax_bmm_bf16_reference`);
    CUDA tensors must be bfloat16, run the kernel and add one to
    ``psa_softmax_bmm_wgmma.launches``."""
    if x.device.type == "cpu" and a.device.type == "cpu":
        out = psa_softmax_bmm_bf16_reference(x, a, norm)
        return (out, *psa_softmax_stats(a)) if return_stats else out
    _check_cuda(x, a)
    _check_bf16(x)
    return _forward_wgmma(x, a, norm, return_stats)


psa_softmax_bmm_wgmma.launches = 0


def psa_softmax_bmm_tf32x3(x: torch.Tensor, a: torch.Tensor, norm: float = 1.0,
                           return_stats: bool = False):
    """The resident forward on the tensor cores, for float32 operands:
    ``(1/norm) * x @ p`` with ``p = softmax(a, dim=1)``, ``x`` and ``p``
    each split into a TF32 high part and a TF32 remainder and multiplied as
    ``lo hi + hi lo + hi hi`` into float32 sums (``psa_pallas.py::_fwd_kernel``
    at HIGHEST precision, within its 1e-5 bars). The softmax is online, as
    in :func:`psa_softmax_bmm_wgmma`. Returns float32 ``[N, C, HW]``, or
    ``(out, m, l)`` with ``return_stats``. Forward only:
    :func:`psa_softmax_bmm` is the differentiable entry point and calls
    this kernel for float32 operands. CPU tensors run the plain version
    (:func:`psa_softmax_bmm_tf32x3_reference`); CUDA tensors must be
    float32, run the kernel and add one to
    ``psa_softmax_bmm_tf32x3.launches``."""
    if x.device.type == "cpu" and a.device.type == "cpu":
        out = psa_softmax_bmm_tf32x3_reference(x, a, norm)
        return (out, *psa_softmax_stats(a)) if return_stats else out
    _check_cuda(x, a)
    _check_f32(x)
    return _forward_tf32x3(x, a, norm, return_stats)


psa_softmax_bmm_tf32x3.launches = 0


def psa_softmax_bmm_flash(x: torch.Tensor, a: torch.Tensor, norm: float = 1.0,
                          return_stats: bool = False):
    """``(1/norm) * x @ softmax(a, dim=1)``, the flash forward
    (``psa_pallas.py::_flash_fwd_kernel``).

    Returns float32 ``[N, C, HW]``, or ``(out, m, l)`` with
    ``return_stats``: the column max and the sum of ``exp(a - m)``, float32
    ``[N, HW]`` (forward only, as for :func:`psa_softmax_bmm`). While grad is
    enabled and an input requires it, the call is differentiable through
    :func:`psa_softmax_bmm_flash_bwd`. CPU tensors run the plain version.
    CUDA tensors run the route: the tensor-core forward of their dtype, as
    :func:`psa_softmax_bmm` does (bit-identical to it; the counter of
    :func:`psa_softmax_bmm_wgmma` or :func:`psa_softmax_bmm_tf32x3` moves),
    always writing ``m`` and ``l``; each such call adds one to
    ``psa_softmax_bmm_flash.launches``."""
    if _needs_grad(x, a):
        if return_stats:
            raise ValueError("return_stats is forward-only: call under torch.no_grad()")
        return _PSA.apply(x, a, norm, True)
    if return_stats:
        return _forward(x, a, norm, flash=True, stats=True)
    return psa_softmax_bmm_op(x, a, norm, True)


psa_softmax_bmm_flash.launches = 0


def psa_softmax_bmm_bwd_da(x, a, g, m, l, out, norm: float = 1.0) -> torch.Tensor:
    """Resident backward, ``da = p * (x^T g / norm - sum_c g * out)`` in
    ``a``'s dtype (``psa_pallas.py::_bwd_da_kernel``). CPU tensors run the
    plain version; float32 CUDA tensors run the 3xTF32 kernel
    (:func:`psa_softmax_bmm_bwd_da_tf32x3`), bfloat16 ones the bf16
    tensor-core kernel (:func:`psa_softmax_bmm_bwd_da_wgmma`); either adds
    one to ``psa_softmax_bmm_bwd_da.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_da_reference(x, a, g, m, l, out, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l, out=out)
    da = _bwd_da(x, a, g, m, l, out, norm)
    psa_softmax_bmm_bwd_da.launches += 1
    return da


def _bwd_da(x, a, g, m, l, out, norm):
    """The tensor-core da of the dtype of checked CUDA operands."""
    if x.dtype == torch.bfloat16:
        return _bwd_da_wgmma(x, a, g, m, l, out, norm)
    return _bwd_da_tf32x3(x, a, g, m, l, out, norm)


psa_softmax_bmm_bwd_da.launches = 0


def _bwd_da_wgmma(x, a, g, m, l, out, norm):
    """The tensor-core da kernel on checked bfloat16 CUDA operands."""
    n, c, hw = x.shape
    delta = _delta(g, out)
    da = torch.empty_like(a)
    elems = _lib()["semseg_psa_da_wgmma_pack_elems"](n, c, hw)
    pack = torch.empty(2 * elems, dtype=torch.bfloat16, device=x.device)
    _launch("semseg_psa_bwd_da_wgmma", x, _ptr(x), _ptr(g), _ptr(a), _ptr(m), _ptr(l),
            _ptr(delta), _ptr(da), _ptr(pack), n, c, hw, 1.0 / norm)
    psa_softmax_bmm_bwd_da_wgmma.launches += 1
    return da


def psa_softmax_bmm_bwd_da_wgmma(x, a, g, m, l, out, norm: float = 1.0) -> torch.Tensor:
    """Resident da on the tensor cores, for bfloat16 operands: ``g``
    rounded to bfloat16, ``dP = x^T g / norm`` summed in float32
    (``psa_pallas.py::_bwd_da_kernel`` at DEFAULT precision), then ``da = p
    * (dP - sum_c g * out)`` with ``p = exp(a - m) / l``, returned in
    bfloat16. CPU tensors run the plain version
    (:func:`psa_softmax_bmm_bwd_da_bf16_reference`); CUDA tensors must be
    bfloat16 (``g``, ``out``, ``m``, ``l`` float32), run the kernel and add
    one to ``psa_softmax_bmm_bwd_da_wgmma.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_da_bf16_reference(x, a, g, m, l, out, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l, out=out)
    _check_bf16(x)
    return _bwd_da_wgmma(x, a, g, m, l, out, norm)


psa_softmax_bmm_bwd_da_wgmma.launches = 0


def _bwd_da_tf32x3(x, a, g, m, l, out, norm):
    """The 3xTF32 da kernel on checked float32 CUDA operands."""
    n, c, hw = x.shape
    delta = _delta(g, out)
    da = torch.empty_like(a)
    elems = _lib()["semseg_psa_da_tf32x3_pack_elems"](n, c, hw)
    pack = torch.empty(elems, dtype=torch.float32, device=x.device)
    _launch("semseg_psa_bwd_da_tf32x3", x, _ptr(x), _ptr(g), _ptr(a), _ptr(m), _ptr(l),
            _ptr(delta), _ptr(da), _ptr(pack), n, c, hw, 1.0 / norm)
    psa_softmax_bmm_bwd_da_tf32x3.launches += 1
    return da


def psa_softmax_bmm_bwd_da_tf32x3(x, a, g, m, l, out, norm: float = 1.0) -> torch.Tensor:
    """Resident da on the tensor cores, for float32 operands: ``x`` and
    ``g`` each split into a TF32 high part and a TF32 remainder, ``dP = x^T
    g / norm`` as ``lo hi + hi lo + hi hi`` into float32 sums
    (``psa_pallas.py::_bwd_da_kernel`` at HIGHEST precision), then ``da = p
    * (dP - sum_c g * out)`` with ``p = exp(a - m) / l``, returned in
    float32. CPU tensors run the plain version
    (:func:`psa_softmax_bmm_bwd_da_tf32x3_reference`); CUDA tensors must be
    float32, run the kernel and add one to
    ``psa_softmax_bmm_bwd_da_tf32x3.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_da_tf32x3_reference(x, a, g, m, l, out, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l, out=out)
    _check_f32(x)
    return _bwd_da_tf32x3(x, a, g, m, l, out, norm)


psa_softmax_bmm_bwd_da_tf32x3.launches = 0


def psa_softmax_bmm_bwd_dx(x, a, g, m, l, norm: float = 1.0) -> torch.Tensor:
    """Resident backward, ``dx = g p^T / norm`` in ``x``'s dtype
    (``psa_pallas.py::_bwd_dx_kernel``; ``x`` gives the shape and dtype
    only). CPU tensors run the plain version; float32 CUDA tensors run the
    3xTF32 kernel (:func:`psa_softmax_bmm_bwd_dx_tf32x3`), bfloat16 ones the
    bf16 tensor-core kernel (:func:`psa_softmax_bmm_bwd_dx_wgmma`); either
    adds one to ``psa_softmax_bmm_bwd_dx.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_dx_reference(x, a, g, m, l, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l)
    dx = _bwd_dx(x, a, g, m, l, norm)
    psa_softmax_bmm_bwd_dx.launches += 1
    return dx


def _bwd_dx(x, a, g, m, l, norm):
    """The tensor-core dx of the dtype of checked CUDA operands."""
    if x.dtype == torch.bfloat16:
        return _bwd_dx_wgmma(x, a, g, m, l, norm)
    return _bwd_dx_tf32x3(x, a, g, m, l, norm)


psa_softmax_bmm_bwd_dx.launches = 0


def _bwd_dx_wgmma(x, a, g, m, l, norm):
    """The tensor-core dx kernel on checked bfloat16 CUDA operands."""
    n, c, hw = x.shape
    dx = torch.empty((n, c, hw), dtype=torch.bfloat16, device=x.device)
    pack = _wgmma_pack(x)
    _launch("semseg_psa_bwd_dx_wgmma", x, _ptr(a), _ptr(g), _ptr(m), _ptr(l), _ptr(dx),
            _ptr(pack), n, c, hw, 1.0 / norm)
    psa_softmax_bmm_bwd_dx_wgmma.launches += 1
    return dx


def psa_softmax_bmm_bwd_dx_wgmma(x, a, g, m, l, norm: float = 1.0) -> torch.Tensor:
    """Resident dx on the tensor cores, for bfloat16 operands: ``g`` and
    ``p = exp(a - m) / l`` rounded to bfloat16, ``g p^T / norm`` summed in
    float32 (``psa_pallas.py::_bwd_dx_kernel`` at DEFAULT precision),
    returned in bfloat16. CPU tensors run the plain version
    (:func:`psa_softmax_bmm_bwd_dx_bf16_reference`); CUDA tensors must be
    bfloat16 (``g``, ``m``, ``l`` float32), run the kernel and add one to
    ``psa_softmax_bmm_bwd_dx_wgmma.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_dx_bf16_reference(x, a, g, m, l, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l)
    _check_bf16(x)
    return _bwd_dx_wgmma(x, a, g, m, l, norm)


psa_softmax_bmm_bwd_dx_wgmma.launches = 0


def _bwd_dx_tf32x3(x, a, g, m, l, norm):
    """The 3xTF32 dx kernel on checked float32 CUDA operands."""
    n, c, hw = x.shape
    dx = torch.empty((n, c, hw), dtype=torch.float32, device=x.device)
    pack = _tf32x3_pack(x)
    _launch("semseg_psa_bwd_dx_tf32x3", x, _ptr(a), _ptr(g), _ptr(m), _ptr(l), _ptr(dx),
            _ptr(pack), n, c, hw, 1.0 / norm)
    psa_softmax_bmm_bwd_dx_tf32x3.launches += 1
    return dx


def psa_softmax_bmm_bwd_dx_tf32x3(x, a, g, m, l, norm: float = 1.0) -> torch.Tensor:
    """Resident dx on the tensor cores, for float32 operands: ``g`` and
    ``p = exp(a - m) / l`` each split into a TF32 high part and a TF32
    remainder, ``g p^T / norm`` as ``lo hi + hi lo + hi hi`` into float32
    sums (``psa_pallas.py::_bwd_dx_kernel`` at HIGHEST precision, within
    its 1e-4 / 1e-5 bars), returned in float32. CPU tensors run the plain
    version (:func:`psa_softmax_bmm_bwd_dx_tf32x3_reference`); CUDA tensors
    must be float32, run the kernel and add one to
    ``psa_softmax_bmm_bwd_dx_tf32x3.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_dx_tf32x3_reference(x, a, g, m, l, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l)
    _check_f32(x)
    return _bwd_dx_tf32x3(x, a, g, m, l, norm)


psa_softmax_bmm_bwd_dx_tf32x3.launches = 0


def psa_softmax_bmm_flash_bwd(x, a, g, m, l, out, norm: float = 1.0):
    """Flash backward, ``(dx, da)`` in the dtypes of ``x`` and ``a``
    (``psa_pallas.py::_flash_bwd_kernel``), from the flash forward's ``m``,
    ``l`` and output. CPU tensors run the plain version; CUDA tensors run the
    tensor-core dx and da kernels of their dtype in turn (the counters of
    :func:`psa_softmax_bmm_bwd_dx_tf32x3` and
    :func:`psa_softmax_bmm_bwd_da_tf32x3`, or of the ``_wgmma`` pair, move).
    The TPU kernel fused the two to bound VMEM; on Hopper neither kernel's
    shared memory depends on ``hw``. Each call on CUDA tensors also adds one
    to ``psa_softmax_bmm_flash_bwd.launches``."""
    if x.device.type == "cpu":
        return psa_softmax_bmm_bwd_reference(x, a, g, m, l, out, norm)
    _check_cuda(x, a)
    _check_cuda_f32(x, g=g, m=m, l=l, out=out)
    grads = _bwd_dx(x, a, g, m, l, norm), _bwd_da(x, a, g, m, l, out, norm)
    psa_softmax_bmm_flash_bwd.launches += 1
    return grads


psa_softmax_bmm_flash_bwd.launches = 0


def psa_softmax_bmm_auto(x: torch.Tensor, a: torch.Tensor,
                         norm: float = 1.0) -> torch.Tensor:
    """Fused PSA aggregation with the kernel that :func:`select_psa_kernel`
    picks for the shape (differentiable, as the two entry points are)."""
    _, c, hw = x.shape
    if select_psa_kernel(c, hw, x.dtype) == "resident":
        return psa_softmax_bmm(x, a, norm)
    return psa_softmax_bmm_flash(x, a, norm)
