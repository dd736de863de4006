"""The port's PSANet50 export on the CPU, through the
``semseg_torch.export`` driver at 33x33 crops: with ``fused_attention
True`` the crop artifact keeps the PSA forward as the operator
``semseg::psa_softmax_bmm`` (its CPU implementation, the plain version,
standing in for the kernel) and equals the eager model within 1e-6;
without it the full-scope artifact is portable and byte for byte
``predict``. Also the PSA entry points' trace to the operator.
(PSPNet50, and the comparisons with the JAX package:
``tests/test_torch_export.py``.)
"""

import os
import shutil

import numpy as np
import pytest
import torch

from semseg_torch import export as driver
from semseg_torch.config import Config
from semseg_torch.engine import evaluator as teval
from semseg_torch.engine.checkpoint import save_checkpoint
from semseg_torch.engine.export import check_portable, load_serving, make_serving_fn, read_meta
from semseg_torch.models.build import build_model
from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = dict(scales=[0.5, 1.0], base_size=40)


@pytest.fixture(autouse=True, scope="module")
def threads():
    """Two intra-op threads: the suite runs in several pytest workers that
    share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _demo_image():
    """``figure/demo/ADE_val_00001515.jpg`` as RGB, resized to 45x37."""
    import cv2

    demo = cv2.imread(os.path.join(REPO, "figure", "demo", "ADE_val_00001515.jpg"),
                      cv2.IMREAD_COLOR)
    demo = cv2.cvtColor(demo, cv2.COLOR_BGR2RGB)
    return cv2.resize(demo, (45, 37), interpolation=cv2.INTER_LINEAR)


@pytest.fixture(scope="module")
def psa(tmp_path_factory):
    """A seeded port PSANet50 (4 classes, 33x33 crops, mask 5x5), a
    directory for its files, its checkpoint and the driver's config for
    it."""
    root = tmp_path_factory.mktemp("export_psa")
    keys = dict(arch="psa", layers=50, classes=4, zoom_factor=8, train_h=33, train_w=33,
                test_h=33, test_w=33, psa_type=2, compact=0, shrink_factor=2,
                normalization_factor=1.0, psa_softmax=1)
    model = build_model(Config(keys), device="cpu", seed=1)
    ckpt = save_checkpoint(str(root / "exp"), 1, {"step": 0, "state_dict": model.state_dict(),
                                                  "optimizer": {}})
    yield dict(model=model, root=root,
               cfg=lambda **k: Config({**keys, "model_path": ckpt, **k}))
    shutil.rmtree(root)


def test_psanet_crop_artifact_keeps_the_psa_operator(psa):
    """(e) The driver's PSANet50 crop export with ``fused_attention True``:
    the graph calls ``semseg::psa_softmax_bmm`` twice (two directions),
    the artifact names it, and reloaded it equals the eager model within
    1e-6 at batch 1 and 3, the operator's CPU implementation standing in
    for the kernel."""
    path = str(psa["root"] / "crop.pt2")
    driver.run(psa["cfg"](export_path=path, fused_attention=True, export_platforms=["cpu"]),
               device="cpu")
    assert read_meta(path)["ops"] == ["semseg::psa_softmax_bmm"]
    serve = load_serving(path)
    assert str(serve.graph).count("semseg.psa_softmax_bmm") == 2
    os.remove(path)  # 200 MB
    model = psa["model"]
    model.psa.fused_attention = True
    direct = make_serving_fn(model, mean=IMAGENET_MEAN, std=IMAGENET_STD)
    for batch in (1, 3):
        x = torch.from_numpy(
            (np.random.RandomState(batch).rand(batch, 33, 33, 3) * 255).astype(np.float32))
        with torch.no_grad():
            want = direct(x)
        np.testing.assert_allclose(serve(x).numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_psanet_full_artifact_matches_predict(psa):
    """The driver's PSANet50 full-scope export with no platform list:
    the plain attention (no operator, portable), byte for byte the port's
    ``predict`` on the demo image."""
    path = str(psa["root"] / "full.pt2")
    driver.run(psa["cfg"](export_path=path, export_scope="full", export_h=37, export_w=45,
                          **FULL), device="cpu")
    assert read_meta(path)["ops"] == []
    image = _demo_image()
    got = load_serving(path)(torch.from_numpy(image)).numpy()
    os.remove(path)
    model = psa["model"]
    model.psa.fused_attention = None
    ev = teval.SlidingWindowEvaluator(model, classes=4, crop_h=33, crop_w=33,
                                      mean=IMAGENET_MEAN, std=IMAGENET_STD, window_batch=8,
                                      device="cpu", **FULL)
    np.testing.assert_array_equal(got, ev.predict(image))


@pytest.mark.parametrize("flash", [False, True])
def test_psa_entry_points_trace_to_the_operator(flash):
    """(e) The no-grad forward of ``psa_softmax_bmm`` and of
    ``psa_softmax_bmm_flash`` is the operator with ``flash`` as given; the
    traced program equals the plain version and cannot pass as portable,
    and grad-enabled calls still run the autograd Function."""
    from semseg_torch.ops import psa

    entry = psa.psa_softmax_bmm_flash if flash else psa.psa_softmax_bmm

    class Agg(torch.nn.Module):
        def forward(self, x, a):
            return entry(x, a, 1.3)

    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(3, 8, 16).astype(np.float32))
    a = torch.from_numpy(rs.randn(3, 16, 16).astype(np.float32) * 3)
    with torch.no_grad():
        exported = torch.export.export(Agg(), (x, a), strict=False)
    calls = [n.args for n in exported.graph.nodes
             if n.op == "call_function" and "semseg" in str(n.target)]
    assert len(calls) == 1 and calls[0][2:] == (1.3, flash)
    want = psa.psa_softmax_bmm_reference(x, a, 1.3)
    torch.testing.assert_close(exported.module()(x, a), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="portable"):
        check_portable(exported, ["cpu", "cuda"])
    assert entry(x.requires_grad_(), a, 1.3).grad_fn is not None
