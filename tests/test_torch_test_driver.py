"""The port's test and demo drivers against the JAX package's, on the
CPU: ``semseg_torch.test.run`` against ``tool/test.py::run`` on the same
list and weights, a port-trained ``.pth`` evaluated by the JAX package,
the demo against the test driver (``tests/test_integration.py:450-523``),
and both drivers in a fresh process that imports no JAX. Data are seeded
synthetic PNGs with a list file (``tests/driver_data.py``)."""

import importlib.util
import logging
import os
import shutil
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driver_data import CLASSES, CONFIG, CROP, H, REPO, W, argv as _argv, cfg as _cfg  # noqa: F401
from driver_data import threads as _threads  # noqa: F401
from driver_data import write_dataset as _write_dataset
from semseg_torch import config as tconfig
from semseg_torch import train


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tool", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A PSANet50 trained 2 steps by the port's ``run``; its
    ``train_epoch_1.pth``."""
    root = tmp_path_factory.mktemp("drivers")
    _write_dataset(root)
    res = train.run(_cfg(root, "epochs", "1"), "cpu")
    return root, res["checkpoints"][0]


def test_test_driver_matches_jax(trained):
    """``semseg_torch.test.run`` against ``tool/test.py::run`` on the same
    list (4 images, 48x64, single scale, flip, 20 windows an image): the
    port reads the port-trained ``.pth``, the JAX driver the same weights
    after a round trip through the JAX package (``load_model_variables``
    of that file, then ``export_pth``). The gray PNGs are equal at every
    pixel whose top two JAX probabilities are more than 1e-4 apart, and
    mIoU/mAcc/allAcc agree. The cross-load: the JAX evaluator on the
    port's ``.pth`` and the port's evaluator give float32 probabilities
    within 1e-4 on every image."""
    from semseg_tpu import config as jconfig
    from semseg_tpu.engine.checkpoint import load_model_variables
    from semseg_tpu.engine.evaluator import SlidingWindowEvaluator as JEvaluator
    from semseg_tpu.models.build import build_model as jbuild_model
    from semseg_tpu.models.convert import export_pth
    from semseg_torch import test as ttest

    root, pth = trained
    variables = load_model_variables(pth, "psa", 50)
    jax_pth = os.path.join(root, "jax_export.pth")
    export_pth(jax_pth, variables, "psa", 50)
    argv = _argv(root, "save_folder", os.path.join(root, "jax_result"), "model_path", jax_pth)
    jcfg = jconfig.parse_config_args(argv)
    tool_test = _load_tool("test")
    tool_test.run(jcfg)
    want_metrics = tool_test.cal_acc(logging.getLogger("t"), [
        (os.path.join(str(root), "img", f"{k}.png"), os.path.join(str(root), "img",
                                                                  f"{k}_label.png"))
        for k in range(4)], os.path.join(root, "jax_result", "gray"), CLASSES,
        [str(c) for c in range(CLASSES)])

    tcfg = tconfig.parse_config_args(_argv(root, "model_path", pth))
    out = ttest.run(tcfg, device="cpu")
    assert out["images"] == 4 and out["seconds"] > 0
    np.testing.assert_allclose(out["metrics"], want_metrics, rtol=0, atol=1e-12)

    jmodel, _ = jbuild_model(jcfg, dtype=jnp.float32)
    jev = JEvaluator(jmodel, jax.tree.map(jnp.asarray, variables), classes=CLASSES,
                     crop_h=CROP, crop_w=CROP, mean=train.IMAGENET_MEAN, std=train.IMAGENET_STD,
                     base_size=W, scales=[1.0], window_batch=8, mode="device")
    tev = ttest.make_evaluator(tcfg, ttest.load_model(tcfg, "cpu", logging.getLogger("t")),
                               "cpu", "device")
    for k in range(4):
        rgb = cv2.cvtColor(cv2.imread(os.path.join(root, "img", f"{k}.png")), cv2.COLOR_BGR2RGB)
        want_probs = np.asarray(jev.predict_probs(rgb))
        np.testing.assert_allclose(tev.predict_probs(rgb), want_probs, rtol=0, atol=1e-4)
        top2 = np.sort(want_probs, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-4
        gray = cv2.imread(os.path.join(root, "result", "gray", f"{k}.png"), cv2.IMREAD_GRAYSCALE)
        jgray = cv2.imread(os.path.join(root, "jax_result", "gray", f"{k}.png"),
                           cv2.IMREAD_GRAYSCALE)
        assert gray.shape == (H, W) and clear.mean() > 0.9
        np.testing.assert_array_equal(gray[clear], jgray[clear])
        color = os.path.join(root, "result", "color", f"{k}.png")
        assert os.path.isfile(color)


def test_demo_matches_the_test_driver(trained):
    """The demo's gray PNG of one image equals the test driver's for it;
    the palette PNG lands beside it."""
    from semseg_torch import demo
    from semseg_torch import test as ttest

    root, pth = trained
    folder = os.path.join(root, "demo")
    os.makedirs(folder, exist_ok=True)
    image = os.path.join(folder, "1.png")
    shutil.copy(os.path.join(root, "img", "1.png"), image)
    cfg = demo.parse_args(["--config", CONFIG, "image", image, *_argv(root, "model_path", pth)[2:]])
    gray = demo.run(cfg, device="cpu")
    tcfg = tconfig.parse_config_args(_argv(root, "model_path", pth, "index_start", "1",
                                           "index_step", "1",
                                           "save_folder", os.path.join(root, "one")))
    assert ttest.run(tcfg, device="cpu")["images"] == 1
    want = cv2.imread(os.path.join(root, "one", "gray", "1.png"), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(gray, want)
    np.testing.assert_array_equal(cv2.imread(os.path.join(folder, "1_gray.png"),
                                             cv2.IMREAD_GRAYSCALE), want)
    assert os.path.isfile(os.path.join(folder, "1_color.png"))
    rand = demo.parse_args(["--config", CONFIG, "--image", image, "allow_random_weights",
                            "True", *_argv(root, "model_path", "absent.pth")[2:]])
    assert demo.run(rand, device="cpu").shape == (H, W)


@pytest.fixture(scope="module")
def one_device_gray(trained):
    """The single-device test driver's gray map of image 0."""
    from semseg_torch import test as ttest

    root, pth = trained
    folder = os.path.join(root, "one_device")
    ttest.run(tconfig.parse_config_args(_argv(root, "model_path", pth, "index_step", "1",
                                              "save_folder", folder)), device="cpu")
    return cv2.imread(os.path.join(folder, "gray", "0.png"), cv2.IMREAD_GRAYSCALE)


@pytest.mark.parametrize("partition", ["window", "spatial"])
def test_drivers_eval_devices(trained, one_device_gray, partition):
    """``eval_devices 2`` with ``eval_partition`` on the CPU: the test
    driver's and the demo's gray maps of one image equal the single-device
    driver's (``window`` at every pixel; ``spatial``, whose float32 sums
    run in another order, at >= 0.999 of them)."""
    from semseg_torch import demo
    from semseg_torch import test as ttest

    root, pth = trained
    folder = os.path.join(root, f"two_{partition}")
    keys = ("model_path", pth, "eval_devices", "2", "eval_partition", partition)
    cfg = tconfig.parse_config_args(_argv(root, *keys, "index_step", "1",
                                          "save_folder", folder))
    assert ttest.eval_devices(cfg, "cpu") == [torch.device("cpu")] * 2
    assert ttest.run(cfg, device="cpu")["images"] == 1
    bar = 1.0 if partition == "window" else 0.999
    gray = cv2.imread(os.path.join(folder, "gray", "0.png"), cv2.IMREAD_GRAYSCALE)
    assert (gray == one_device_gray).mean() >= bar
    image = os.path.join(folder, "0.png")
    shutil.copy(os.path.join(root, "img", "0.png"), image)
    gray = demo.run(demo.parse_args(["--config", CONFIG, "image", image,
                                     *_argv(root, *keys)[2:]]), device="cpu")
    assert (gray == one_device_gray).mean() >= bar


def test_eval_devices_rules(monkeypatch):
    """``eval_devices``: unset or 1 is one device; on CUDA ``cuda:0 ..
    N-1``, ``all`` every device, more than the machine shows raises; on
    the CPU ``all`` raises (it counts CUDA devices)."""
    from types import SimpleNamespace

    from semseg_torch import test as ttest

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert ttest.eval_devices(SimpleNamespace(), "cpu") is None
    assert ttest.eval_devices(SimpleNamespace(eval_devices=1), "cuda:0") is None
    assert ttest.eval_devices(SimpleNamespace(eval_devices="all"), "cuda:0") == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="only 2 CUDA devices"):
        ttest.eval_devices(SimpleNamespace(eval_devices=3), "cuda:0")
    with pytest.raises(ValueError, match="all"):
        ttest.eval_devices(SimpleNamespace(eval_devices="all"), "cpu")
    assert ttest.eval_devices(SimpleNamespace(eval_devices=3), "cpu") == [torch.device("cpu")] * 3


# Run by test_test_and_demo_import_no_jax in a fresh interpreter.
_SCRIPT = """
import sys
from semseg_torch import demo, test
from semseg_torch.config import parse_config_args
argv, image = sys.argv[1:-1], sys.argv[-1]
out = test.run(parse_config_args(argv), device="cpu")
gray = demo.run(demo.parse_args(argv[:2] + ["image", image] + argv[2:]), device="cpu")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "semseg_tpu"))
print("RESULT", out["images"], gray.shape, loaded)
"""


def test_test_and_demo_import_no_jax(tmp_path):
    """``semseg_torch.test`` and ``semseg_torch.demo`` in a fresh process,
    on a ``.pth`` of seeded weights: no jax, jaxlib, flax, orbax or
    ``semseg_tpu`` module is imported. Without CUDA, both ``main``s
    raise."""
    from semseg_torch import demo
    from semseg_torch import test as ttest
    from semseg_torch.models.build import build_model

    _write_dataset(tmp_path)
    model = build_model(_cfg(tmp_path), device="cpu", seed=2)
    pth = str(tmp_path / "model.pth")
    torch.save({"epoch": 0, "state_dict": model.state_dict()}, pth)
    image = str(tmp_path / "copy.png")
    shutil.copy(tmp_path / "img" / "0.png", image)
    argv = _argv(tmp_path, "model_path", pth, "index_step", "2")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, *argv, image], capture_output=True,
                          text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][0]
    assert result == f"RESULT 2 ({H}, {W}) []"
    assert "Eval result: mIoU/mAcc/allAcc" in proc.stderr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttest.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.main(["--config", CONFIG, "image", image])
