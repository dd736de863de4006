"""The port's serving export (``semseg_torch/engine/export.py`` and the
``semseg_torch.export`` driver) on the CPU, at 25x25 crops with 4 classes:
each artifact, reloaded from disk, against the port's in-framework path
(within 1e-6 for a crop, byte for byte for the whole sliding-window
program, ``tests/test_export.py:78,203``'s bars) and against the JAX
package's export and evaluator, with JAX-initialised weights carried over
by ``state_dict_from_jax`` (the port's model bar, 1e-4 abs on
probabilities). PSANet50 keeps the PSA forward as the operator
``semseg::psa_softmax_bmm``, whose CPU implementation (the plain version)
stands in for the kernel. JAX results are materialised before any torch
compute.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_torch import export as driver
from semseg_torch.config import Config
from semseg_torch.engine import evaluator as teval
from semseg_torch.engine.checkpoint import save_checkpoint
from semseg_torch.engine.export import (
    export_serving,
    export_sliding_window,
    load_serving,
    make_serving_fn,
    read_meta,
)
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.pspnet import PSPNet
from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 25
FULL = dict(scales=[0.5, 1.0], base_size=40)


def _crops(batch, seed):
    return (np.random.RandomState(seed).rand(batch, CROP, CROP, 3) * 255).astype(np.float32)


def _demo_image():
    """``figure/demo/ADE_val_00001515.jpg`` as RGB, resized to 45x37."""
    import cv2

    demo = cv2.imread(os.path.join(REPO, "figure", "demo", "ADE_val_00001515.jpg"),
                      cv2.IMREAD_COLOR)
    demo = cv2.cvtColor(demo, cv2.COLOR_BGR2RGB)
    return cv2.resize(demo, (45, 37), interpolation=cv2.INTER_LINEAR)


@pytest.fixture(scope="module")
def psp(tmp_path_factory):
    """JAX PSPNet50 (4 classes) and its variables, the port model holding
    them, a port checkpoint of them, and the JAX serving function jitted
    over its variables (one compile for every set of weights)."""
    from semseg_tpu.engine import export as jexport
    from semseg_tpu.models.pspnet import PSPNet as JPSPNet

    jmodel = JPSPNet(layers=50, classes=4, zoom_factor=8)
    v = jax.jit(lambda k, x: jmodel.init({"params": k, "dropout": k}, x, train=True))(
        jax.random.PRNGKey(7), jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    v = jax.tree.map(np.asarray, v)
    jserve = jax.jit(lambda var, x: jexport.make_serving_fn(
        jmodel, var, mean=IMAGENET_MEAN, std=IMAGENET_STD)(x))
    model = PSPNet(layers=50, classes=4, zoom_factor=8)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    root = tmp_path_factory.mktemp("export")
    ckpt = save_checkpoint(str(root / "exp"), 3, {"step": 0, "state_dict": model.state_dict(),
                                                  "optimizer": {}})
    yield dict(jmodel=jmodel, v=v, jserve=jserve, model=model.eval(), ckpt=ckpt, root=root)
    shutil.rmtree(root)  # artifacts of 200 MB each


@pytest.fixture(autouse=True, scope="module")
def threads():
    """Two intra-op threads: the suite runs in several pytest workers that
    share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfg(psp, **keys):
    return Config(dict(arch="psp", layers=50, classes=4, zoom_factor=8, train_h=CROP,
                       train_w=CROP, test_h=CROP, test_w=CROP, model_path=psp["ckpt"], **keys))


@pytest.fixture(scope="module")
def crop_artifact(psp):
    """The driver's portable crop artifact (``export_platforms ['cpu',
    'cuda']``, probabilities) of the checkpoint."""
    path = str(psp["root"] / "crop.pt2")
    assert driver.run(_cfg(psp, export_path=path, export_platforms=["cpu", "cuda"]),
                      device="cpu") == path
    return path


def test_crop_artifact_matches_in_framework(psp, crop_artifact):
    """(a) Reloaded from disk, one artifact at batch 1 and 3 (its batch is
    symbolic), within 1e-6 of ``make_serving_fn``; rows sum to 1."""
    assert read_meta(crop_artifact)["ops"] == []
    serve = load_serving(crop_artifact)
    direct = make_serving_fn(psp["model"], mean=IMAGENET_MEAN, std=IMAGENET_STD)
    for batch in (1, 3):
        x = torch.from_numpy(_crops(batch, batch))
        got = serve(x)
        with torch.no_grad():
            want = direct(x)
        assert got.shape == (batch, CROP, CROP, 4) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_serving_fn_matches_jax(psp):
    """(b) The port's ``make_serving_fn`` against JAX's on the same crops
    and weights: probabilities within 1e-4 abs."""
    x = _crops(3, 11)
    want = np.asarray(psp["jserve"](psp["v"], x))
    with torch.no_grad():
        got = make_serving_fn(psp["model"], mean=IMAGENET_MEAN, std=IMAGENET_STD)(
            torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, CROP, CROP, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_pred_output(psp):
    """(c) The ``pred`` program gives the uint8 ``[B, h, w]`` argmax of
    the in-framework logits (float32 NHWC, whose softmax is ``probs``),
    below ``classes``."""
    exported = export_serving(psp["model"], crop_h=CROP, crop_w=CROP, mean=IMAGENET_MEAN,
                              std=IMAGENET_STD, output="pred")
    x = torch.from_numpy(_crops(2, 5))
    with torch.no_grad():
        got = exported.module()(x)
        logits = make_serving_fn(psp["model"], mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                 output="logits")(x)
        probs = make_serving_fn(psp["model"], mean=IMAGENET_MEAN, std=IMAGENET_STD)(x)
    assert got.shape == (2, CROP, CROP) and got.dtype == torch.uint8
    assert int(got.max()) < 4
    assert torch.equal(got, logits.argmax(-1).to(torch.uint8))
    assert logits.shape == (2, CROP, CROP, 4) and logits.dtype == torch.float32
    torch.testing.assert_close(torch.softmax(logits, -1), probs, rtol=0, atol=1e-6)


def _evaluator(psp, **keys):
    return teval.SlidingWindowEvaluator(
        psp["model"], classes=4, crop_h=CROP, crop_w=CROP, mean=IMAGENET_MEAN,
        std=IMAGENET_STD, window_batch=8, device="cpu", **{**FULL, **keys})


def test_full_artifact_matches_predict_and_jax(psp):
    """(d) ``export_scope full`` on the demo image at 45x37, scales [0.5,
    1.0], base 40: the artifact's uint8 map is byte for byte the port's
    ``predict``, and JAX's ``SlidingWindowEvaluator.predict`` wherever
    JAX's top-2 probabilities are more than 1e-4 apart."""
    from semseg_tpu.engine import evaluator as jeval

    image = _demo_image()
    jev = jeval.SlidingWindowEvaluator(
        psp["jmodel"], psp["v"], classes=4, crop_h=CROP, crop_w=CROP, mean=IMAGENET_MEAN,
        std=IMAGENET_STD, mode="device", **FULL)
    want_probs = np.asarray(jev.predict_probs(image))
    want_jax = np.asarray(jev.predict(image))

    path = str(psp["root"] / "full.pt2")
    driver.run(_cfg(psp, export_path=path, export_scope="full", export_h=37, export_w=45,
                    **FULL), device="cpu")
    got = load_serving(path)(torch.from_numpy(image)).numpy()
    assert got.shape == (37, 45) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _evaluator(psp).predict(image))
    top2 = np.sort(want_probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want_jax[clear])


def test_portable_artifact_loads_with_bare_torch(psp, crop_artifact, tmp_path):
    """(f) A fresh interpreter loads the portable artifact with
    ``torch.export.load`` alone: no ``semseg_torch`` module and no jax is
    imported, and its probabilities equal the in-framework module's
    within 1e-6."""
    x = _crops(3, 9)
    np.save(tmp_path / "x.npy", x)
    script = (
        "import sys, numpy as np, torch\n"
        f"ep = torch.export.load({crop_artifact!r})\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "with torch.no_grad():\n"
        f"    np.save({str(tmp_path / 'y.npy')!r}, ep.module()(x).numpy())\n"
        "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] in "
        "('semseg_torch', 'semseg_tpu', 'jax', 'flax')))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=""), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
    with torch.no_grad():
        want = make_serving_fn(psp["model"], mean=IMAGENET_MEAN, std=IMAGENET_STD)(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), want, rtol=1e-6, atol=1e-6)


def _cached_tensors():
    from semseg_torch.ops import resize, stitch

    return [t for fn in (resize.interp_matrix, stitch._taps, stitch._tap_records,
                         teval._coverage)
            for value in fn.cache.values()
            for t in (value if isinstance(value, tuple) else (value,))]


def _clear_caches():
    from semseg_torch.ops import resize, stitch

    for fn in (resize.interp_matrix, stitch._taps, stitch._tap_records, teval._coverage):
        fn.cache_clear()


def _host_copies(exported):
    """Calls of the traced graph that copy a tensor built during the trace
    (a per-call host-to-device copy on CUDA)."""
    return [n for n in exported.graph.nodes
            if n.op == "call_function" and "lift_fresh" in str(n.target)]


def test_predict_is_unchanged_by_an_export(psp):
    """(g) Caches and traces, from empty caches: a bare ``torch.export`` of
    the whole program records its constants as tensors built during the
    trace and stores none of them; ``predict`` fills the caches under
    inference mode; ``export_sliding_window`` (whose eager call comes
    before its trace) records the cached constants themselves, no copy,
    and must not trip on inference tensors. ``predict`` before and after
    the exports gives the same bytes, and the program's own; no cached
    tensor is a fake or an inference tensor, and the model's eager output
    is a plain tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    from semseg_torch.engine.export import SlidingWindowProgram

    image = _demo_image()
    ev = _evaluator(psp, scales=[0.5])  # resize, pad, one chunk of windows
    _clear_caches()
    with torch.no_grad():
        bare = torch.export.export(SlidingWindowProgram(ev), (torch.from_numpy(image),),
                                   strict=False)
    assert _cached_tensors() == [] and _host_copies(bare)
    before = ev.predict(image)
    assert _cached_tensors()
    ev.predict_probs(image)
    exported = export_sliding_window(ev, 37, 45)
    assert _host_copies(exported) == []
    after = ev.predict(image)
    np.testing.assert_array_equal(before, after)
    np.testing.assert_array_equal(exported.module()(torch.from_numpy(image)).numpy(), before)
    np.testing.assert_array_equal(bare.module()(torch.from_numpy(image)).numpy(), before)
    cached = _cached_tensors()
    assert cached and not any(isinstance(t, FakeTensor) or t.is_inference() for t in cached)
    with torch.no_grad():
        out = psp["model"](torch.zeros(1, 3, CROP, CROP))
    assert type(out) is torch.Tensor


def test_pth_export_reads_back_in_jax(psp):
    """(h) ``export_format pth`` from a port checkpoint: the reference's
    ``{"epoch", "state_dict"}`` with ``module.`` keys, which JAX's
    ``load_model_variables`` reads back to the variables the port started
    from, and whose JAX forward matches the port's within 1e-4."""
    from semseg_tpu.engine.checkpoint import load_model_variables

    path = str(psp["root"] / "model.pth")
    assert driver.run(_cfg(psp, export_path=path, export_format="pth")) == path
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert payload["epoch"] == 3
    assert payload["state_dict"] and all(k.startswith("module.") for k in payload["state_dict"])
    v = load_model_variables(path, "psp", 50)
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, v), psp["v"])
    x = _crops(3, 13)
    want = np.asarray(psp["jserve"](v, x))
    with torch.no_grad():
        got = make_serving_fn(psp["model"], mean=IMAGENET_MEAN, std=IMAGENET_STD)(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_driver_rules(psp, tmp_path):
    """(i) ``stablehlo`` and ``tpu`` name the JAX package's tool; a full
    scope needs ``export_h``/``export_w``; an unknown output raises; with
    no device the driver and ``main`` need CUDA."""
    out = str(tmp_path / "x.pt2")
    with pytest.raises(ValueError, match="tool/export.py"):
        driver.run(_cfg(psp, export_path=out, export_format="stablehlo"), device="cpu")
    with pytest.raises(ValueError, match="tool/export.py"):
        driver.run(_cfg(psp, export_path=out, export_platforms=["tpu"]), device="cpu")
    with pytest.raises(ValueError, match="export_h"):
        driver.run(_cfg(psp, export_path=out, export_scope="full", export_w=45), device="cpu")
    with pytest.raises(ValueError, match="export_output"):
        driver.run(_cfg(psp, export_path=out, export_output="argmax"), device="cpu")
    with pytest.raises(ValueError, match="export_path"):
        driver.run(_cfg(psp), device="cpu")
    with pytest.raises(RuntimeError, match="no checkpoint"):
        driver.run(Config({**_cfg(psp, export_path=out), "model_path": str(tmp_path / "none")}),
                   device="cpu")
    with pytest.raises(ValueError, match="cuda-targeted"):
        export_serving(psp["model"], crop_h=CROP, crop_w=CROP, mean=IMAGENET_MEAN,
                       std=IMAGENET_STD, platforms=["cuda"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            driver.run(_cfg(psp, export_path=out))
        with pytest.raises(RuntimeError, match="CUDA"):
            driver.main(["--config", os.path.join(REPO, "config/ade20k/ade20k_pspnet50.yaml"),
                         "model_path", psp["ckpt"], "export_path", out])
    assert not os.path.exists(out)
