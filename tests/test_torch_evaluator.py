"""The port's sliding-window evaluator against the JAX package's (device
mode), on the CPU: the whole slice, single- and multi-scale, with PSPNet50
f32 and JAX-initialised weights, and the fused stitch path with a bf16 stub
model (JAX runs its Pallas kernel in interpret mode, the port the kernel's
plain version). JAX results are materialised before any torch compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.engine import evaluator as jeval
from semseg_tpu.models.pspnet import PSPNet as JPSPNet
from semseg_tpu.ops.resize import resize_bilinear_align_corners
from semseg_torch.engine import evaluator as teval
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.pspnet import PSPNet
from semseg_torch.ops.resize import resize_bilinear_align_corners_cf

IMAGE = (np.random.RandomState(0).rand(41, 57, 3) * 255).astype(np.uint8)
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


@pytest.fixture(scope="module")
def psp():
    """JAX PSPNet50 (4 classes) variables and the port model holding them."""
    jmodel = JPSPNet(layers=50, classes=4, zoom_factor=8)
    key = jax.random.PRNGKey(3)
    v = jax.jit(lambda k, x: jmodel.init({"params": k, "dropout": k}, x, train=True))(
        key, jnp.zeros((1, 33, 33, 3), jnp.float32))
    v = jax.tree.map(np.asarray, v)
    model = PSPNet(layers=50, classes=4, zoom_factor=8)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return jmodel, v, model.eval()


def _check_pspnet50_slice(psp, scales):
    """f32 probs within 1e-4 abs (conv summation order through 50
    layers); the uint8 class map equal wherever the top two JAX probs
    are more than 1e-4 apart."""
    jmodel, v, model = psp
    kw = dict(classes=4, crop_h=33, crop_w=33, mean=MEAN, std=STD, base_size=57,
              scales=scales, flip=True, window_batch=4)
    jev = jeval.SlidingWindowEvaluator(jmodel, v, mode="device", **kw)
    want_probs = np.asarray(jev.predict_probs(IMAGE))
    want_pred = np.asarray(jev.predict(IMAGE))

    ev = teval.SlidingWindowEvaluator(model, device="cpu", **kw)
    assert not ev.fused_stitch
    probs = ev.predict_probs(IMAGE)
    pred = ev.predict(IMAGE)
    assert probs.shape == (41, 57, 4) and pred.shape == (41, 57) and pred.dtype == np.uint8
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-4)
    top2 = np.sort(want_probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pred[clear], want_pred[clear])


@pytest.mark.parametrize("scale", [1.0, 0.75])
def test_pspnet50_slice_matches_jax(psp, scale):
    """Single scale; 0.75 runs both half-pixel resizes (image down, probs
    up) and the mean padding."""
    _check_pspnet50_slice(psp, [scale])


def test_pspnet50_multiscale_matches_jax(psp):
    """Two scales against ``_build_ms_argmax_raw`` and the f32 mean of
    ``predict_probs``: 0.5 pads the 20x28 image to the 33 crop (one
    window), 1.25 tiles 51x71 with six."""
    _check_pspnet50_slice(psp, [0.5, 1.25])


class _JaxZoomStub:
    """bf16 JAX model stub with a zoomed head (as in
    tests/test_stitch_pallas.py): the attributes the fused dispatch reads."""

    def __init__(self, zoom_factor=8):
        self.zoom_factor = zoom_factor
        self.dtype = jnp.bfloat16

    def clone(self, zoom_factor):
        return _JaxZoomStub(zoom_factor)

    def apply(self, variables, x, train=False):
        h, w = x.shape[1], x.shape[2]
        f = x[:, ::8, ::8].astype(self.dtype)
        m = jnp.mean(f, axis=-1, keepdims=True)
        logits = jnp.concatenate([m, 0.5 - m, 0.25 * m + 0.1], axis=-1)
        if self.zoom_factor != 1:
            out = ((h - 1) // 8 * self.zoom_factor + 1, (w - 1) // 8 * self.zoom_factor + 1)
            logits = resize_bilinear_align_corners(logits, out)
        return logits


class _TorchZoomStub(torch.nn.Module):
    """The same stub for the port (NCHW, ``forward(x, zoom)``)."""

    dtype = torch.bfloat16
    zoom_factor = 8

    def forward(self, x, zoom=True):
        h, w = x.shape[-2], x.shape[-1]
        f = x[:, :, ::8, ::8].to(self.dtype)
        m = f.mean(dim=1, keepdim=True)
        logits = torch.cat([m, 0.5 - m, 0.25 * m + 0.1], dim=1)
        if zoom:
            logits = resize_bilinear_align_corners_cf(
                logits, ((h - 1) // 8 * 8 + 1, (w - 1) // 8 * 8 + 1))
        return logits


STUB_KW = dict(classes=3, crop_h=17, crop_w=17, mean=[0.5, 0.5, 0.5],
               std=[1.0, 1.0, 1.0], base_size=57, flip=True, window_batch=4)
STUB_IMAGE = (np.random.RandomState(4).rand(41, 57, 3) * 2.0).astype(np.float32)


def _check_fused_path(scales):
    """The fused path on both sides: JAX's Pallas kernel (interpret) and
    the port's plain version of its CUDA kernel. atol 2e-2 and argmax
    agreement > 0.995, the license of tests/test_stitch_pallas.py."""
    jev = jeval.SlidingWindowEvaluator(_JaxZoomStub(), {}, fused_stitch=True,
                                       scales=scales, mode="device", **STUB_KW)
    want = np.asarray(jev.predict_probs(STUB_IMAGE), np.float32)

    ev = teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", fused_stitch=True,
                                      scales=scales, **STUB_KW)
    assert ev.fused_stitch
    got = ev.predict_probs(STUB_IMAGE)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-2)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.995


@pytest.mark.parametrize("scale", [0.75, 1.0])
def test_fused_path_matches_jax(scale):
    _check_fused_path([scale])


def test_fused_path_multiscale_matches_jax():
    _check_fused_path([0.5, 1.25])


def test_multiscale_sums_bf16_maps_in_f32():
    """A bf16 model's per-scale maps are bf16; the scales' sum is float32,
    in scale order (the JAX package's ``eec3491``): ``predict_probs`` is,
    bit for bit, the float32 mean of what single-scale evaluators give,
    and ``predict`` the argmax of their float32 sum. A bf16 running sum
    differs from it (so the check is not blind to that trap)."""
    scales = [0.5, 0.75, 1.25]
    kw = dict(STUB_KW, fused_stitch=True)
    maps = [teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", scales=[s],
                                         **kw).predict_probs(STUB_IMAGE) for s in scales]
    total = maps[0].copy()
    for m in maps[1:]:
        total += m
    ev = teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", scales=scales, **kw)
    np.testing.assert_array_equal(ev.predict_probs(STUB_IMAGE), total / np.float32(len(scales)))
    np.testing.assert_array_equal(ev.predict(STUB_IMAGE), total.argmax(-1).astype(np.uint8))
    bf16_sum = torch.from_numpy(maps[0]).to(torch.bfloat16)
    for m in maps[1:]:
        bf16_sum = bf16_sum + torch.from_numpy(m).to(torch.bfloat16)
    assert not np.array_equal(bf16_sum.float().numpy(), total)


def test_fused_matches_unfused_in_the_port():
    fused = teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", fused_stitch=True,
                                         scales=[0.75], **STUB_KW)
    plain = teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", fused_stitch=False,
                                         scales=[0.75], **STUB_KW)
    a, b = fused.predict_probs(STUB_IMAGE), plain.predict_probs(STUB_IMAGE)
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=2e-2)
    assert (a.argmax(-1) == b.argmax(-1)).mean() > 0.995


def test_construction_rules():
    kw = dict(STUB_KW, scales=[1.0])
    # auto dispatch: the fused kernel only on CUDA
    assert not teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", **kw).fused_stitch
    with pytest.raises(ValueError, match="requires flip"):
        teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", fused_stitch=True,
                                     **dict(kw, flip=False))
    # host mode: the cv2/numpy pipeline (float64 probabilities, no fused
    # stitch); it has no device program to queue
    host = teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", mode="host", **kw)
    assert not host.fused_stitch
    probs = host.predict_probs(STUB_IMAGE)
    assert probs.dtype == np.float64 and probs.shape == STUB_IMAGE.shape[:2] + (3,)
    np.testing.assert_array_equal(host.predict(STUB_IMAGE), probs.argmax(-1).astype(np.uint8))
    with pytest.raises(ValueError, match="device mode"):
        host.predict_async(STUB_IMAGE)
    with pytest.raises(ValueError, match="partition"):
        teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", partition="rows", **kw)
    # several scales run: one class map over the image
    ms = teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", **dict(kw, scales=[0.5, 1.0]))
    assert ms.scales == [0.5, 1.0]
    pred = ms.predict(STUB_IMAGE)
    assert pred.shape == STUB_IMAGE.shape[:2] and pred.dtype == np.uint8
    with pytest.raises(ValueError):
        teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", mode="tpu", **kw)
    # device_bucketed (the server's default) runs the same pipeline
    a = teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", mode="device_bucketed", **kw)
    b = teval.SlidingWindowEvaluator(_TorchZoomStub(), device="cpu", mode="device", **kw)
    np.testing.assert_array_equal(a.predict(STUB_IMAGE), b.predict(STUB_IMAGE))


@pytest.mark.parametrize("hw,crop,scale,base", [
    ((1024, 2048), 713, 1.0, 2048), ((512, 683), 473, 0.75, 512),
    ((41, 57), 33, 0.75, 57), ((300, 200), 97, 1.75, 256), ((33, 33), 33, 1.0, 33),
])
def test_grid_geometry_matches_jax(hw, crop, scale, base):
    new = jeval._scaled_size(*hw, scale, base)
    assert teval._scaled_size(*hw, scale, base) == new
    canvas = (max(new[0], crop), max(new[1], crop))
    assert (teval._grid_coords(*canvas, crop, crop, 2 / 3)
            == jeval._grid_coords(*canvas, crop, crop, 2 / 3))
