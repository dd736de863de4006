"""The port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and the same arrays go to both
sides. Every JAX result is materialised (``np.asarray``) before any torch
compute runs: torch's OpenMP work corrupts XLA:CPU buffers still in
flight. The CUDA kernel itself is compared with its plain version in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from semseg_tpu.ops import pool as jpool
from semseg_tpu.ops import resize as jresize
from semseg_tpu.ops import stitch_pallas as jstitch
from semseg_torch.ops import pool, resize, stitch


SIZES = [((1, 1), (5, 4)), ((5, 4), (1, 1)), ((7, 9), (13, 17)),
         ((13, 17), (7, 9)), ((12, 90), (97, 713)), ((41, 57), (31, 43))]


@pytest.mark.parametrize("half_pixel", [False, True])
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_matches_jax(src, dst, half_pixel):
    """f32, rtol 1e-5: both sides sum the same two weighted taps per
    output; only FMA contraction may differ in the last bit."""
    x = np.random.RandomState(0).randn(2, 3, *src).astype(np.float32)
    jfn = (jresize.resize_bilinear_half_pixel_cf if half_pixel
           else jresize.resize_bilinear_align_corners_cf)
    want = np.asarray(jfn(jnp.asarray(x), dst))
    fn = (resize.resize_bilinear_half_pixel_cf if half_pixel
          else resize.resize_bilinear_align_corners_cf)
    got = fn(torch.from_numpy(x), dst)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, *dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_resize_align_corners_is_f_interpolate():
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 2, 9, 12).astype(np.float32))
    got = resize.resize_bilinear_align_corners_cf(x, (33, 45))
    want = F.interpolate(x, (33, 45), mode="bilinear", align_corners=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_resize_same_size_returns_input_and_keeps_bf16():
    x = torch.randn(3, 8, 8).to(torch.bfloat16)
    assert resize.resize_bilinear_half_pixel_cf(x, (8, 8)) is x
    y = resize.resize_bilinear_half_pixel_cf(x, (5, 11))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (3, 5, 11)


@pytest.mark.parametrize("hw", [(5, 7), (12, 12), (13, 9), (6, 1)])
@pytest.mark.parametrize("bins", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax(hw, bins):
    x = np.random.RandomState(2).randn(2, *hw, 4).astype(np.float32)  # NHWC
    want = np.asarray(jpool.adaptive_avg_pool2d(jnp.asarray(x), bins))
    got = pool.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), bins)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(9, 9), (10, 7), (17, 33)])
def test_max_pool_matches_jax(hw):
    """-inf padding: an all-negative input must never pick a pad value."""
    x = -np.abs(np.random.RandomState(3).randn(2, *hw, 3)).astype(np.float32) - 1.0
    want = np.asarray(jpool.max_pool2d(jnp.asarray(x), 3, 2, 1))
    got = pool.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _pairs(rs, p, hs, c, ws):
    return rs.randn(p, 2, c, hs, ws).astype(np.float32) * 3.0


@pytest.mark.parametrize("hs,out_h", [(13, 97), (12, 89), (7, 48)])
def test_stitch_plain_matches_jax_kernel_f32(hs, out_h):
    """f32 operands: the plain version against the Pallas kernel run in
    interpret mode (tolerance of tests/test_stitch_pallas.py)."""
    lp = _pairs(np.random.RandomState(0), 3, hs, 5, hs)
    want = np.asarray(jstitch.upsample_softmax_flip(
        jnp.asarray(lp), (out_h, out_h), interpret=True))
    got = stitch.upsample_softmax_flip(torch.from_numpy(lp), (out_h, out_h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_stitch_plain_matches_jax_kernel_bf16():
    """bf16 operands: same rounding points as the Pallas kernel; atol
    2e-2 covers bf16 output rounding and exp ulps. Rows sum to 1."""
    lp = _pairs(np.random.RandomState(1), 2, 13, 4, 13)
    want = np.asarray(jstitch.upsample_softmax_flip(
        jnp.asarray(lp, jnp.bfloat16), (97, 97), interpret=True), np.float32)
    got = stitch.upsample_softmax_flip(
        torch.from_numpy(lp).to(torch.bfloat16), (97, 97))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=2e-2)


def test_stitch_flip_fold_is_exact_mirror():
    """With half 1 the W-mirror of half 0, the average equals half 0's
    softmax alone: the reversed interpolation weights undo the flip."""
    base = np.random.RandomState(2).randn(1, 6, 9, 9).astype(np.float32)
    lp = np.stack([base, base[..., ::-1]], axis=1)
    want = np.asarray(jstitch.upsample_softmax_flip(
        jnp.asarray(lp), (65, 65), interpret=True))
    got = stitch.upsample_softmax_flip(torch.from_numpy(lp.copy()), (65, 65))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    only = torch.softmax(resize.resize_bilinear_align_corners_cf(
        torch.from_numpy(base), (65, 65)), dim=1)
    np.testing.assert_allclose(got.numpy(), only.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("src,dst", [(90, 713), (89, 705), (60, 473), (13, 97), (1, 5), (5, 1)])
def test_stitch_taps_reproduce_weight_matrix(src, dst):
    """The kernel's two-tap tables hold exactly the bf16-rounded weights
    the plain version multiplies by."""
    idx, w = stitch._taps(src, dst, torch.device("cpu"))
    dense = torch.zeros(dst, src)
    rows = torch.arange(dst)
    dense[rows, idx[:, 0].long()] += w[:, 0]
    dense[rows, idx[:, 1].long()] += w[:, 1]
    want = stitch._weights(src, dst, torch.bfloat16, torch.device("cpu"))
    assert torch.equal(dense, want)


@pytest.mark.parametrize("src,dst", [(89, 705), (60, 473), (5, 1)])
def test_stitch_tap_records_pack_the_taps(src, dst):
    """The kernel's 16-byte tap records hold the tap tables bit for bit:
    indices, then the float32 weights' bits."""
    idx, w = stitch._taps(src, dst, torch.device("cpu"))
    rec = stitch._tap_records(src, dst, torch.device("cpu"))
    assert rec.dtype == torch.int32 and tuple(rec.shape) == (dst, 4) and rec.is_contiguous()
    assert torch.equal(rec[:, :2], idx)
    assert torch.equal(rec[:, 2:].contiguous().view(torch.float32), w)


def test_stitch_wrapper_dispatch_rules():
    lp = torch.zeros(1, 2, 3, 5, 5)
    before = stitch.upsample_softmax_flip.launches
    stitch.upsample_softmax_flip(lp, (9, 9))  # CPU: plain version, no launch
    assert stitch.upsample_softmax_flip.launches == before
    with pytest.raises(ValueError):
        stitch.upsample_softmax_flip(torch.empty(1, 2, 3, 5, 5, device="meta"), (9, 9))
    assert stitch.supported(torch.bfloat16)
    assert not stitch.supported(torch.float32)



def test_resize_is_differentiable_after_inference_mode():
    """The matrix cache filled by a first call under ``inference_mode``
    (the evaluator) must serve a later training step: gradients equal
    ``F.interpolate``'s (a process that serves and then trains failed with
    "Inference tensors cannot be saved for backward")."""
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 2, 7, 11).astype(np.float32))
    with torch.inference_mode():
        resize.resize_bilinear_align_corners_cf(x, (13, 21))
    xg = x.clone().requires_grad_()
    resize.resize_bilinear_align_corners_cf(xg, (13, 21)).square().sum().backward()
    xr = x.clone().requires_grad_()
    F.interpolate(xr, (13, 21), mode="bilinear", align_corners=True).square().sum().backward()
    torch.testing.assert_close(xg.grad, xr.grad, rtol=1e-5, atol=1e-5)
