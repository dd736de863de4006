"""The port's PSANet path against the JAX package's, on the CPU.

psamask (exact), the plain versions of the two PSA forward kernels against
the JAX Pallas kernels in interpret mode, the ``PSA`` module, PSANet50 eval
logits, the state_dict converter and the sliding-window slice. Inputs are
made from seeds with numpy and handed to both sides; JAX-initialised
weights (with drawn BN statistics) are carried into the port through
``state_dict_from_jax``. JAX results are materialised before any torch
compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.engine import evaluator as jeval
from semseg_tpu.models.convert import export_torch_state_dict
from semseg_tpu.models.psanet import PSA as JPSA
from semseg_tpu.models.psanet import PSANet as JPSANet
from semseg_tpu.ops import psa_pallas as jpsa
from semseg_tpu.ops import psamask as jmask
from semseg_torch.engine import evaluator as teval
from semseg_torch.models import build
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.psanet import PSA, PSANet, use_fused_attention
from semseg_torch.ops import psa, psamask
from tests.test_torch_models import _randomize_bn

# ---------------------------------------------------------------- psamask


@pytest.mark.parametrize("h,w,mask_h,mask_w", [
    (5, 7, 9, 13),   # full relative extent
    (5, 7, 5, 7),    # clipped odd mask
    (4, 6, 3, 5),
    (6, 6, 11, 1),
    (1, 1, 1, 1),
])
@pytest.mark.parametrize("psa_type", [psamask.COLLECT, psamask.DISTRIBUTE])
def test_psamask_matches_jax(h, w, mask_h, mask_w, psa_type):
    """Exact: the skew is data movement only."""
    y = np.random.RandomState(h * 10 + w).randn(2, h, w, mask_h * mask_w).astype(np.float32)
    want = np.asarray(jmask.psa_attention_matrix(jnp.asarray(y), psa_type, mask_h, mask_w))
    want_mask = np.asarray(jmask.psa_mask(jnp.asarray(y), psa_type, mask_h, mask_w))

    yt = torch.from_numpy(y)
    got = psamask.psa_attention_matrix(yt, psa_type, mask_h, mask_w)
    got_cf = psamask.psa_attention_matrix_cf(yt.permute(0, 3, 1, 2).contiguous(),
                                             psa_type, mask_h, mask_w)
    assert tuple(got.shape) == (2, h * w, h * w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_cf.numpy(), want)
    np.testing.assert_array_equal(
        psamask.psa_mask(yt, psa_type, mask_h, mask_w).numpy(), want_mask)


def test_psamask_bf16_is_data_movement():
    y = torch.from_numpy(np.random.RandomState(0).randn(1, 3, 4, 5 * 7).astype(np.float32))
    a32 = psamask.psa_attention_matrix(y, 0, 5, 7)
    a16 = psamask.psa_attention_matrix(y.to(torch.bfloat16), 0, 5, 7)
    assert a16.dtype == torch.bfloat16
    assert torch.equal(a16.float(), a32.to(torch.bfloat16).float())


def test_psamask_module_matches_jax_and_checks_inputs():
    y = np.random.RandomState(1).randn(1, 3, 4, 5 * 7).astype(np.float32)
    for t in (0, 1):
        want = np.asarray(jmask.PSAMask(t)(jnp.asarray(y)))  # full extent by default
        np.testing.assert_array_equal(psamask.PSAMask(t)(torch.from_numpy(y)).numpy(), want)
    with pytest.raises(ValueError, match="psa_type"):
        psamask.PSAMask(2)
    with pytest.raises(ValueError, match="both"):
        psamask.PSAMask(0, mask_h=3)
    with pytest.raises(ValueError, match="channels"):
        psamask.PSAMask(0, 3, 3)(torch.from_numpy(y))
    with pytest.raises(ValueError, match="exceeds"):
        psamask.psa_attention_matrix(torch.zeros(1, 2, 2, 25), 0, 5, 5)
    with pytest.raises(ValueError, match="odd"):
        psamask.psa_attention_matrix(torch.zeros(1, 3, 3, 16), 0, 4, 4)


# ----------------------------------------------- plain kernel versions vs Pallas


def _operands(seed, n, c, hw, dtype):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, c, hw).astype(np.float32)
    a = (rs.randn(n, hw, hw) * 3).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(a).astype(jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(a).to(tdt)))


@pytest.mark.parametrize("n,c,hw,tile_j,dtype,norm", [
    (1, 16, 36, 16, "f32", 1.7),   # ragged everything
    (2, 8, 128, 128, "f32", 1.0),
    (1, 24, 100, 32, "bf16", 1.0),
    (1, 8, 40, 16, "bf16", 1.5),
])
def test_resident_plain_matches_pallas(n, c, hw, tile_j, dtype, norm):
    """rtol/atol 1e-5, as tests/test_psa_pallas.py (bf16 operands against
    f32 math on the same bf16 values)."""
    (jx, ja), (x, a) = _operands(hw, n, c, hw, dtype)
    want = np.asarray(jpsa.psa_softmax_bmm(jx, ja, norm, tile_j, True))
    before = psa.psa_softmax_bmm.launches
    got = psa.psa_softmax_bmm(x, a, norm)
    assert psa.psa_softmax_bmm.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, c, hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,c,hw,cap_i,cap_j,dtype,norm", [
    (1, 16, 40, 16, 128, "f32", 1.7),  # 3 source tiles
    (2, 8, 100, 32, 32, "f32", 1.0),   # several tiles on both axes, ragged
    (1, 8, 48, 16, 128, "bf16", 1.5),
    (1, 24, 36, 64, 128, "bf16", 1.0),  # one source tile
])
def test_flash_plain_matches_pallas(n, c, hw, cap_i, cap_j, dtype, norm):
    """Output, and the softmax statistics ``m`` and ``l`` of
    ``_flash_fwd``, at rtol/atol 1e-5."""
    (jx, ja), (x, a) = _operands(hw + 1, n, c, hw, dtype)
    want = np.asarray(jpsa.psa_softmax_bmm_flash(jx, ja, norm, True, cap_i, cap_j))
    _, want_m, want_l = (np.asarray(v) for v in
                         jpsa._flash_fwd(jx, ja, norm, cap_i, cap_j, interpret=True))
    before = psa.psa_softmax_bmm_flash.launches
    got = psa.psa_softmax_bmm_flash(x, a, norm)
    out, m, l = psa.psa_softmax_bmm_flash(x, a, norm, return_stats=True)
    assert psa.psa_softmax_bmm_flash.launches == before
    assert tuple(m.shape) == tuple(l.shape) == (n, hw) and m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.numpy(), got.numpy())
    np.testing.assert_array_equal(m.numpy(), want_m)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_select_psa_kernel(dtype):
    """The Hopper rule gives the JAX choices at the recipe extents."""
    for hw, want in ((900, "resident"), (2025, "resident"), (7921, "flash")):
        assert psa.select_psa_kernel(512, hw, dtype) == want
        op_bytes = 2 if dtype == torch.bfloat16 else 4
        assert jpsa.select_psa_kernel(512, hw, op_bytes) == want
    x = torch.randn(1, 4, 9, dtype=dtype)
    a = torch.randn(1, 9, 9, dtype=dtype)
    torch.testing.assert_close(psa.psa_softmax_bmm_auto(x, a, 2.0),
                               psa.psa_softmax_bmm_reference(x, a, 2.0))


# ------------------------------------------------------------- PSA module


def _psa_module_case(psa_type, compact, shrink, mask, norm, psa_softmax, seed):
    """JAX PSA (fused_attention=False) output and variables on 9x9
    features (in 16, mid 8)."""
    jm = JPSA(in_channels=16, mid_channels=8, psa_type=psa_type, compact=compact,
              shrink_factor=shrink, mask_h=mask[0], mask_w=mask[1],
              normalization_factor=norm, psa_softmax=psa_softmax,
              fused_attention=False)
    x = np.random.RandomState(seed).randn(2, 9, 9, 16).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    v = _randomize_bn(v, seed)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    return x, v, want


@pytest.mark.parametrize("psa_type,compact,shrink,mask,norm,psa_softmax,fused", [
    (0, False, 2, (9, 9), 1.0, True, None),
    (1, False, 2, (5, 7), 1.0, True, True),
    (2, False, 1, (7, 5), 2.0, True, None),
    (2, False, 2, (9, 9), 81.0, False, None),
    (1, False, 1, (17, 17), 1.0, True, None),
    (0, True, 2, (5, 5), 1.0, True, None),
    (1, True, 1, (9, 9), 1.0, True, True),
    (2, True, 2, (5, 5), 1.0, True, True),
])
def test_psa_module_matches_jax(psa_type, compact, shrink, mask, norm,
                                psa_softmax, fused):
    """atol 1e-5 against JAX's plain attention path (its fused path would
    try a Mosaic compile on the CPU); the port's fused path runs the
    kernels' plain versions here."""
    x, v, want = _psa_module_case(psa_type, compact, shrink, mask, norm,
                                  psa_softmax, seed=psa_type + 3 * shrink)
    m = PSA(16, 8, psa_type, compact, shrink, mask[0], mask[1], norm,
            psa_softmax, fused).eval()
    sd = state_dict_from_jax({"params": {"backbone": {}, "psa": v["params"]},
                              "batch_stats": {"backbone": {}, "psa": v["batch_stats"]}},
                             "psa")
    m.load_state_dict({k[len("psa."):]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, 32, 9, 9)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def test_use_fused_attention():
    assert use_fused_attention(None, torch.device("cuda", 0))
    assert not use_fused_attention(None, "cpu")
    assert use_fused_attention(True, "cpu") and not use_fused_attention(False, "cuda")
    with pytest.raises(ValueError, match="psa_type"):
        PSA(16, 8, psa_type=3)


# -------------------------------------------------------------- PSANet50


@pytest.fixture(scope="module")
def psanet():
    """JAX PSANet50 (4 classes, bi-direction, shrink 2, mask 5x5 from 33
    crops, aux head included) with drawn BN statistics, and the port model
    holding the same weights."""
    jmodel = JPSANet(layers=50, classes=4, zoom_factor=8, psa_type=2,
                     shrink_factor=2, mask_h=5, mask_w=5,
                     normalization_factor=1.0, fused_attention=False)
    key = jax.random.PRNGKey(5)
    v = jax.jit(lambda k, x: jmodel.init({"params": k, "dropout": k}, x, train=True))(
        key, jnp.zeros((1, 33, 33, 3), jnp.float32))
    v = _randomize_bn(v, seed=6)
    model = PSANet(layers=50, classes=4, zoom_factor=8, psa_type=2,
                   shrink_factor=2, mask_h=5, mask_w=5, normalization_factor=1.0)
    model.load_state_dict(state_dict_from_jax(v, "psa"), strict=True)
    return jmodel, v, model.eval()


def test_psa_state_dict_matches_jax_exporter(psanet):
    _, v, _ = psanet
    want = export_torch_state_dict(v, "psa", 50, ddp_prefix=False)
    got = state_dict_from_jax(v, "psa", 50)
    assert sorted(got) == sorted(want)
    for k, arr in want.items():
        np.testing.assert_array_equal(got[k].numpy(), arr, err_msg=k)
    fresh = PSANet(layers=50, classes=4, mask_h=5, mask_w=5)
    fresh.load_state_dict(got, strict=True)
    assert sorted(fresh.state_dict()) == sorted(want)
    assert "psa.attention_p.3.weight" in got and "psa.attention.3.bias" not in got


def test_psanet50_eval_logits_match_jax(psanet):
    """f32, zoomed logits and the feature-resolution form; atol 1e-4 as
    for PSPNet50 (50+ conv layers summed in another order)."""
    jmodel, v, model = psanet
    x = np.random.RandomState(7).randn(2, 33, 33, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    want_low = np.asarray(jax.jit(
        lambda v, x: jmodel.clone(zoom_factor=1).apply(v, x, train=False))(
        v, jnp.asarray(x)))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(xt)
        got_low = model(xt, zoom=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, 33, 33)
    assert tuple(got_low.shape) == (2, 4, 5, 5)
    assert 0.1 < np.abs(want).max() < 100
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_low.permute(0, 2, 3, 1).numpy(), want_low,
                               rtol=0, atol=1e-4)


def test_psanet50_slice_matches_jax(psanet):
    """The port's evaluator against the JAX evaluator, f32, crop 33: probs
    within 1e-4 abs, class maps equal where the top two JAX probs are more
    than 1e-4 apart (as test_pspnet50_slice_matches_jax)."""
    jmodel, v, model = psanet
    image = (np.random.RandomState(8).rand(41, 57, 3) * 255).astype(np.uint8)
    kw = dict(classes=4, crop_h=33, crop_w=33, mean=[123.675, 116.28, 103.53],
              std=[58.395, 57.12, 57.375], base_size=57, scales=[1.0], flip=True,
              window_batch=4)
    jev = jeval.SlidingWindowEvaluator(jmodel, v, mode="device", **kw)
    want_probs = np.asarray(jev.predict_probs(image))
    want_pred = np.asarray(jev.predict(image))

    ev = teval.SlidingWindowEvaluator(model, **kw)
    probs = ev.predict_probs(image)
    pred = ev.predict(image)
    assert probs.shape == (41, 57, 4) and pred.dtype == np.uint8
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-4)
    top2 = np.sort(want_probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pred[clear], want_pred[clear])


def test_build_psanet_defaults():
    """An empty normalization_factor becomes mask_h*mask_w (reference
    model/psanet.py:20-22); fused_attention passes through."""
    from types import SimpleNamespace as NS

    m = build.build_model(NS(arch="psa", layers=50, classes=19, zoom_factor=8,
                             train_h=33, train_w=33, psa_type=2, compact=0,
                             shrink_factor=2, normalization_factor=None,
                             psa_softmax=1, fused_attention=False))
    assert (m.psa.mask_h, m.psa.mask_w) == (5, 5)
    assert m.psa.normalization_factor == 25.0 and m.psa.fused_attention is False
    assert m.psa.attention[3].weight.shape == (25, 512, 1, 1)


# --------------------------------------------- backward: plain vs Pallas VJPs


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _assert_grads_close(got: torch.Tensor, want, dtype):
    """f32: rtol 1e-4, atol 1e-5 (``tests/test_psa_pallas.py:95-141``).
    bf16: within one bf16 ulp of max|want| (both round the same f32 math
    to bf16; sums in another order may flip the last bit)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=_bf16_ulp(np.abs(want).max()))


@pytest.mark.parametrize("flash,n,c,hw,tiles,dtype,norm", [
    (False, 1, 16, 36, 16, "f32", 1.7),        # ragged, 3 query tiles
    (False, 2, 8, 70, 32, "bf16", 2.0),
    (True, 1, 8, 70, (32, 128), "f32", 2.0),   # several source tiles
    (True, 2, 8, 100, (32, 32), "f32", 1.3),   # several tiles on both axes, ragged
    (True, 1, 8, 48, (16, 128), "bf16", 1.5),
])
def test_plain_backward_matches_pallas_vjp(flash, n, c, hw, tiles, dtype, norm):
    """``psa_softmax_bmm_bwd_reference`` (and the three backward entry
    points, which run it on the CPU) against ``jax.vjp`` of the Pallas
    resident or flash kernel in interpret mode; the statistics come from
    the plain forward."""
    (jx, ja), (x, a) = _operands(hw + 2, n, c, hw, dtype)
    g = np.random.RandomState(hw + 3).randn(n, c, hw).astype(np.float32)
    if flash:
        fwd = lambda xx, aa: jpsa.psa_softmax_bmm_flash(xx, aa, norm, True, *tiles)  # noqa: E731
    else:
        fwd = lambda xx, aa: jpsa.psa_softmax_bmm(xx, aa, norm, tiles, True)  # noqa: E731
    _, pull = jax.vjp(fwd, jx, ja)
    want_dx, want_da = pull(jnp.asarray(g))
    assert want_dx.dtype == jx.dtype and want_da.dtype == ja.dtype

    gt = torch.from_numpy(g)
    out = psa.psa_softmax_bmm_reference(x, a, norm)
    m, l = psa.psa_softmax_stats(a)
    dx, da = psa.psa_softmax_bmm_bwd_reference(x, a, gt, m, l, out, norm)
    assert dx.dtype == x.dtype and da.dtype == a.dtype
    _assert_grads_close(dx, want_dx, dtype)
    _assert_grads_close(da, want_da, dtype)

    counts = (psa.psa_softmax_bmm_bwd_da.launches, psa.psa_softmax_bmm_bwd_dx.launches,
              psa.psa_softmax_bmm_flash_bwd.launches)
    if flash:
        fdx, fda = psa.psa_softmax_bmm_flash_bwd(x, a, gt, m, l, out, norm)
    else:
        fdx = psa.psa_softmax_bmm_bwd_dx(x, a, gt, m, l, norm)
        fda = psa.psa_softmax_bmm_bwd_da(x, a, gt, m, l, out, norm)
    assert counts == (psa.psa_softmax_bmm_bwd_da.launches, psa.psa_softmax_bmm_bwd_dx.launches,
                      psa.psa_softmax_bmm_flash_bwd.launches)  # CPU: plain versions
    torch.testing.assert_close(fdx, dx, rtol=0, atol=0)
    torch.testing.assert_close(fda, da, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["psa_softmax_bmm", "psa_softmax_bmm_flash"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entry_points_are_differentiable(entry, dtype):
    """Under grad the entry points run their autograd Function (plain
    versions on the CPU): the same output as the plain forward, gradients
    in the primal dtypes equal to the plain backward, and autograd of the
    plain forward within 1e-5 (f32; bf16 within one bf16 ulp)."""
    fn = getattr(psa, entry)
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 6, 23).astype(np.float32)).to(dtype).requires_grad_()
    a = torch.from_numpy((rs.randn(2, 23, 23) * 3).astype(np.float32)).to(dtype).requires_grad_()
    g = torch.from_numpy(rs.randn(2, 6, 23).astype(np.float32))
    out = fn(x, a, 1.5)
    assert out.grad_fn is not None and out.dtype == torch.float32
    dx, da = torch.autograd.grad(out, (x, a), g)
    assert dx.dtype == da.dtype == dtype
    with torch.no_grad():
        plain = psa.psa_softmax_bmm_reference(x, a, 1.5)
        m, l = psa.psa_softmax_stats(a)
        want = psa.psa_softmax_bmm_bwd_reference(x, a, g, m, l, plain, 1.5)
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    torch.testing.assert_close(dx, want[0], rtol=0, atol=0)
    torch.testing.assert_close(da, want[1], rtol=0, atol=0)
    auto = torch.autograd.grad(psa.psa_softmax_bmm_reference(x, a, 1.5), (x, a), g)
    for got, ref in zip((dx, da), auto):
        _assert_grads_close(got, ref.float().numpy(), "f32" if dtype == torch.float32 else "bf16")
    with pytest.raises(ValueError, match="forward-only"):
        fn(x, a, 1.5, return_stats=True)
    with torch.no_grad():
        assert len(fn(x, a, 1.5, return_stats=True)) == 3


# ------------------------------------------------------- PSA module, train


@pytest.mark.parametrize("psa_type,compact,shrink,mask,norm,fused", [
    (0, False, 2, (9, 9), 1.0, True),
    (1, False, 1, (7, 5), 2.0, True),
    (2, False, 2, (9, 9), 1.0, None),
    (0, True, 2, (5, 5), 1.0, True),
    (1, True, 1, (9, 9), 1.0, True),
    (2, True, 2, (5, 5), 1.0, True),
])
def test_psa_module_train_matches_jax(psa_type, compact, shrink, mask, norm, fused):
    """Train mode, f32: the output and the new running statistics against
    flax ``PSA`` with ``mutable=["batch_stats"]``, and the gradients of
    ``sum(out * G)`` for the input and every parameter (mapped through
    ``state_dict_from_jax``): within 3e-4 of each tensor's max|JAX|. BN
    weight gradients are sums over 50-162 positions with cancellation, and
    JAX's train-mode BN takes var = E[x^2] - E[x]^2 where torch takes a
    two-pass variance; measured up to 1.6e-4 (attention BN at shrink 1), the
    same with the plain attention as with the Function."""
    seed = 10 + psa_type + 3 * shrink
    jm = JPSA(in_channels=16, mid_channels=8, psa_type=psa_type, compact=compact,
              shrink_factor=shrink, mask_h=mask[0], mask_w=mask[1],
              normalization_factor=norm, psa_softmax=True, fused_attention=False)
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 9, 9, 16).astype(np.float32)
    gout = rs.randn(2, 9, 9, 32).astype(np.float32)
    v = _randomize_bn(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False), seed)

    def loss(params, xx):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * gout), (out, upd)

    (_, (want, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    want, gx = np.asarray(want), np.asarray(gx)

    def sd(params, stats):
        return {k[len("psa."):]: t for k, t in state_dict_from_jax(
            {"params": {"backbone": {}, "psa": jax.device_get(params)},
             "batch_stats": {"backbone": {}, "psa": jax.device_get(stats)}}, "psa").items()}

    m = PSA(16, 8, psa_type, compact, shrink, mask[0], mask[1], norm, True, fused).train()
    m.load_state_dict(sd(v["params"], v["batch_stats"]), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = m(xt)
    (out * torch.from_numpy(gout).permute(0, 3, 1, 2)).sum().backward()

    def close(got, ref, name):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-4 * max(1e-3, np.abs(ref).max()),
                                   err_msg=name)

    close(out.detach().permute(0, 2, 3, 1).numpy(), want, "out")
    close(xt.grad.permute(0, 2, 3, 1).numpy(), gx, "dx")
    want_grads = sd(gp, upd["batch_stats"])
    got_state = m.state_dict()
    for name, p in m.named_parameters():
        close(p.grad.numpy(), want_grads[name].numpy(), name)
    stats = [k for k in want_grads if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        close(got_state[k].numpy(), want_grads[k].numpy(), k)
