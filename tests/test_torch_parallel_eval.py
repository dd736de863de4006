"""The port's multi-device sliding-window evaluation and host pipeline on
the CPU (``engine/evaluator.py``, ``parallel/spatial.py``): the window and
spatial partitions over 2 and 3 CPU entries against the port's
single-device evaluator, at the bars of ``tests/test_parallel_eval.py``
(1e-6 for ``window``, 1e-5 rtol and atol for ``spatial``); PSPNet50 under
both partitions against JAX's evaluator over a mesh of as many CPU
devices, at the port's 1e-4 bar of ``tests/test_torch_evaluator.py``; and
the cv2 ``host`` mode against JAX's. Models: a twin of the JAX test's
``_ConvModel`` (a 3x3 conv and a global mean), a stub with a stride-2
conv, a max pool and a dilation-4 conv whose halo is larger than a slab,
PSPNet50 with JAX-initialised weights at 33x33 crops, and PSANet50 with
the PSA kernels' plain versions. Inputs come from numpy seeds; JAX results
are materialised before any torch compute.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch import nn

from semseg_tpu.engine import evaluator as jeval
from semseg_tpu.models.pspnet import PSPNet as JPSPNet
from semseg_tpu.parallel.mesh import DATA_AXIS
from semseg_torch.engine import evaluator as teval
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.layers import BatchNorm2d, Conv2d, ConvBN
from semseg_torch.models.psanet import PSANet
from semseg_torch.models.pspnet import PPM, PSPNet
from semseg_torch.ops.pool import AdaptiveAvgPool2d
from semseg_torch.ops.resize import resize_bilinear_align_corners_cf
from semseg_torch.parallel.spatial import split_rows
from tests.test_integration import _PerPixelModel
from tests.test_parallel_eval import _ConvModel

BARS = {"window": 1e-6, "spatial": 1e-5}  # tests/test_parallel_eval.py
MEAN, STD = [124.0, 117.0, 104.0], [59.0, 57.0, 58.0]


@pytest.fixture(autouse=True, scope="module")
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _conv_kernel():
    return np.random.RandomState(5).randn(3, 3, 3, 2).astype(np.float32)


class _ConvTwin(nn.Sequential):
    """``tests/test_parallel_eval.py::_ConvModel`` for the port: a 3x3 conv
    (HWIO kernel, SAME padding, no bias) plus its global mean, per-pixel
    logits at the window's size. The mean is a PPM of one bin whose branch
    is the pool alone (resized back to the window: a broadcast), and a 1x1
    conv of weights ``[I I]`` adds it to the conv's output, exactly."""

    dtype = torch.float32
    zoom_factor = 1

    def __init__(self, kernel):
        conv = Conv2d(3, 2, 3, padding=1, bias=False)
        mean = PPM(2, 2, (1,))
        mean.features[0] = nn.Sequential(AdaptiveAvgPool2d(1))
        add = Conv2d(4, 2, 1, bias=False)
        super().__init__(conv, mean, add)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
            add.weight.copy_(torch.cat([torch.eye(2), torch.eye(2)], 1)[:, :, None, None])

    def forward(self, x, zoom=True):
        return super().forward(x)


class _HaloStub(nn.Sequential):
    """A stride-2 ConvBN without ReLU (negative values reach the pool), the
    max pool, a dilation-4 ConvBN, a 1x1 conv to 3 classes, and the zoom
    back to the window. A 17-row window has 9 rows after the stride and 5
    after the pool: 3 + 2 over two entries, 2 + 2 + 1 over three, so the
    dilated conv's 4-row halo reaches past the neighbour's slab."""

    zoom_factor = 4

    def __init__(self, dtype=torch.float32):
        super().__init__(*ConvBN(3, 6, 3, stride=2, padding=1, relu=False),
                         nn.MaxPool2d(3, 2, 1),
                         *ConvBN(6, 6, 3, padding=4, dilation=4), Conv2d(6, 3, 1))
        self.dtype = dtype
        g = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, 0.4, generator=g)
                    if m.bias is not None:
                        m.bias.normal_(0.0, 0.1, generator=g)
                if isinstance(m, BatchNorm2d):
                    m.running_mean.normal_(0.0, 0.2, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
        self.eval()

    def forward(self, x, zoom=True):
        y = super().forward(x.to(self.dtype))
        if zoom:
            y = resize_bilinear_align_corners_cf(y, x.shape[-2:])
        return y.float()


@functools.lru_cache(maxsize=None)
def _psp():
    """JAX PSPNet50 (4 classes) variables and the port model holding them."""
    jmodel = JPSPNet(layers=50, classes=4, zoom_factor=8, dropout=0.0)
    v = jax.jit(lambda k, x: jmodel.init({"params": k, "dropout": k}, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3), jnp.float32))
    v = jax.tree.map(np.asarray, v)
    model = PSPNet(layers=50, classes=4, zoom_factor=8)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    return jmodel, v, model.eval()


@functools.lru_cache(maxsize=None)
def _psanet():
    """PSANet50 at 33x33 windows (5x5 features, shrink 2, 5x5 mask), seeded
    weights and BatchNorm statistics; the PSA kernels' plain versions."""
    model = PSANet(layers=50, classes=4, zoom_factor=8, mask_h=5, mask_w=5)
    model.init_weights(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.eval()


@functools.lru_cache(maxsize=None)
def _case(name):
    """(model, evaluator keywords, image) of each model, built once."""
    big = dict(classes=4, crop_h=33, crop_w=33, mean=MEAN, std=STD, base_size=65,
               scales=[1.0], flip=True, window_batch=8)
    image = (np.random.RandomState(6).rand(47, 65, 3) * 255).astype(np.float32)
    if name == "conv_twin":
        kw = dict(classes=2, crop_h=17, crop_w=17, mean=[10.0, 20.0, 30.0],
                  std=[55.0, 55.0, 55.0], base_size=61, scales=[0.75, 1.0, 1.25],
                  flip=True, window_batch=8)
        return (_ConvTwin(_conv_kernel()), kw,
                (np.random.RandomState(5).rand(40, 61, 3) * 255).astype(np.float32))
    if name == "halo_stub":
        kw = dict(classes=3, crop_h=17, crop_w=17, mean=[120.0, 120.0, 120.0],
                  std=[60.0, 60.0, 60.0], base_size=57, scales=[1.0, 0.75], flip=True,
                  window_batch=6)
        return (_HaloStub(), kw,
                (np.random.RandomState(8).rand(41, 57, 3) * 255).astype(np.float32))
    if name == "pspnet50":
        return _psp()[2], big, image
    return _psanet(), dict(big, base_size=61), image[:33, :61]  # 3 windows


@functools.lru_cache(maxsize=None)
def _single_probs(name):
    model, kw, image = _case(name)
    return teval.SlidingWindowEvaluator(model, device="cpu", **kw).predict_probs(image)


def test_split_rows():
    assert split_rows(5, 2) == [0, 3, 5] and split_rows(5, 3) == [0, 2, 4, 5]
    assert split_rows(2, 3) == [0, 1, 2, 2] and split_rows(90, 2) == [0, 45, 90]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("partition", ["window", "spatial"])
@pytest.mark.parametrize("name", ["conv_twin", "halo_stub", "pspnet50", "psanet50"])
def test_partition_matches_single_device(name, partition, n):
    """``n`` CPU entries against one device, at JAX's bar of the
    partition; one replica serves the repeated entry."""
    model, kw, image = _case(name)
    multi = teval.SlidingWindowEvaluator(model, devices=["cpu"] * n, partition=partition, **kw)
    assert multi.devices == [torch.device("cpu")] * n and multi.device == torch.device("cpu")
    assert all(m is model for m in multi.models)
    want = _single_probs(name)
    got = multi.predict_probs(image)
    bar = BARS[partition]
    np.testing.assert_allclose(got, want, rtol=bar, atol=bar)
    assert (multi.predict(image) == want.argmax(-1)).mean() > 0.999


def test_conv_twin_matches_jax():
    """The twin is JAX's ``_ConvModel`` (single device, 1e-5)."""
    _, kw, image = _case("conv_twin")
    jev = jeval.SlidingWindowEvaluator(_ConvModel(), {"kernel": jnp.asarray(_conv_kernel())},
                                       mode="device", **kw)
    want = np.asarray(jev.predict_probs(image))
    got = teval.SlidingWindowEvaluator(_ConvTwin(_conv_kernel()), device="cpu",
                                       **kw).predict_probs(image)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("partition", ["window", "spatial"])
def test_fused_stitch_under_partitions(partition):
    """A bf16 model with the fused stitch (its plain version here): under
    ``window`` each entry runs the stitch on its own pairs; under
    ``spatial`` the feature-resolution logits are gathered on the primary.
    Against one device within the stitch license (atol 2e-2, rtol 1e-2,
    argmax agreement > 0.995, ``tests/test_stitch_pallas.py``)."""
    _, kw, image = _case("halo_stub")
    model = _HaloStub(torch.bfloat16)
    kw = dict(kw, fused_stitch=True)
    want = teval.SlidingWindowEvaluator(model, device="cpu", **kw).predict_probs(image)
    multi = teval.SlidingWindowEvaluator(model, devices=["cpu", "cpu"], partition=partition,
                                         **kw)
    assert multi.fused_stitch
    got = multi.predict_probs(image)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-2)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.995


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("partition", ["window", "spatial"])
def test_pspnet50_partition_matches_jax_mesh(partition, n):
    """PSPNet50 under the partition against JAX's evaluator over a mesh of
    ``n`` CPU devices with the same partition (``mesh=``), 1e-4 abs."""
    jmodel, v, model = _psp()
    _, kw, image = _case("pspnet50")
    mesh = Mesh(np.asarray(jax.devices()[:n]), (DATA_AXIS,))
    jev = jeval.SlidingWindowEvaluator(jmodel, v, mode="device", mesh=mesh,
                                       partition=partition, **kw)
    want = np.asarray(jev.predict_probs(image))
    got = teval.SlidingWindowEvaluator(model, devices=["cpu"] * n, partition=partition,
                                       **kw).predict_probs(image)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_host_matches_jax_host():
    """The cv2/numpy pipeline (float64 canvas) against JAX's ``host`` mode
    on PSPNet50, two scales (0.5 pads the image to the crop), 1e-4 abs; it
    also agrees with the port's device mode at JAX's bar of
    ``tests/test_integration.py:322-324``."""
    jmodel, v, model = _psp()
    _, kw, image = _case("pspnet50")
    kw = dict(kw, scales=[0.5, 1.0])
    want = np.asarray(jeval.SlidingWindowEvaluator(jmodel, v, mode="host", **kw)
                      .predict_probs(image))
    host = teval.SlidingWindowEvaluator(model, device="cpu", mode="host", **kw)
    got = host.predict_probs(image)
    assert got.dtype == np.float64 and got.shape == image.shape[:2] + (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    dev = teval.SlidingWindowEvaluator(model, device="cpu", **kw).predict_probs(image)
    np.testing.assert_allclose(dev, got, atol=2e-2, rtol=1e-2)
    assert (dev.argmax(-1) == got.argmax(-1)).mean() > 0.995


class _PerPixelTwin(nn.Module):
    """``tests/test_integration.py::_PerPixelModel`` for the port."""

    dtype = torch.float32
    zoom_factor = 1

    def __init__(self, threshold=50.0):
        super().__init__()
        self.threshold = threshold

    def forward(self, x, zoom=True):
        mean = x.mean(dim=1, keepdim=True)
        return torch.cat([mean, self.threshold - mean], dim=1)


@pytest.mark.parametrize("mode", ["device", "host"])
def test_sliding_window_stitch_exact(mode):
    """``tests/test_integration.py:284-296``: logits that depend only on
    the pixel make the stitched class map exact, in both modes."""
    ev = teval.SlidingWindowEvaluator(
        _PerPixelTwin(), device="cpu", classes=2, crop_h=17, crop_w=17,
        mean=[0.0, 0.0, 0.0], std=None, base_size=40, scales=[1.0], flip=True,
        window_batch=4, mode=mode)
    image = (np.random.RandomState(1).rand(40, 40, 3) * 100).astype(np.float32)
    want = (image.mean(axis=-1) <= 25.0).astype(np.uint8)
    np.testing.assert_array_equal(ev.predict(image), want)
    # JAX's host pipeline on the same stub gives the same float64 map
    jev = jeval.SlidingWindowEvaluator(_PerPixelModel(), {}, classes=2, crop_h=17, crop_w=17,
                                       mean=[0.0, 0.0, 0.0], std=None, base_size=40,
                                       scales=[1.0], flip=True, window_batch=4, mode="host")
    if mode == "host":
        np.testing.assert_allclose(ev.predict_probs(image), jev.predict_probs(image),
                                   rtol=1e-6, atol=1e-6)
        crop = image[:17, :17]  # the reference's single-crop net_process
        np.testing.assert_allclose(ev.net_process(crop), jev.net_process(crop),
                                   rtol=1e-6, atol=1e-6)


def test_devices_rules(monkeypatch):
    """A device the machine lacks, mixed CPU and CUDA entries, ``device``
    other than ``devices[0]`` and an unknown partition raise; the host
    pipeline warns and keeps the primary; a model without a spatial rule
    raises when the spatial partition runs it."""
    model, kw, image = _case("conv_twin")
    count = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA device"):
        teval.SlidingWindowEvaluator(model, devices=[f"cuda:{count}"], **kw)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="mix CPU and CUDA"):
        teval.SlidingWindowEvaluator(model, devices=["cpu", "cuda:1"], **kw)
    with pytest.raises(ValueError, match="is not devices"):
        teval.SlidingWindowEvaluator(model, device="cuda:0", devices=["cpu", "cpu"], **kw)
    with pytest.raises(ValueError, match="partition"):
        teval.SlidingWindowEvaluator(model, devices=["cpu", "cpu"], partition="rows", **kw)
    with pytest.warns(UserWarning, match="host pipeline"):
        host = teval.SlidingWindowEvaluator(model, devices=["cpu", "cpu"], mode="host", **kw)
    assert host.devices == [torch.device("cpu")]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        teval.SlidingWindowEvaluator(model, devices=["cpu", "cpu"], **kw)
    ev = teval.SlidingWindowEvaluator(_PerPixelTwin(), devices=["cpu", "cpu"],
                                      partition="spatial", **kw)
    with pytest.raises(TypeError, match="no spatial rule"):
        ev.predict(image)
