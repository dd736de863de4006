"""The port's HTTP server end to end on the CPU, its weight loading, and
the import boundary of the port (no jax, no flax, no eager cv2/yaml/PIL).
"""

import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from semseg_torch import serve
from semseg_torch.utils.misc import get_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    base = dict(arch="psp", layers=50, classes=4, zoom_factor=8,
                train_h=25, train_w=25, test_h=25, test_w=25,
                base_size=40, scales=[1.0], model_path="",
                allow_random_weights=True, window_batch=4,
                eval_pipeline="device")
    base.update(kw)
    return SimpleNamespace(**base)


def test_serve_end_to_end(tmp_path):
    colors = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    colors_path = tmp_path / "colors.txt"
    np.savetxt(colors_path, colors, fmt="%d")
    cfg = _cfg(colors_path=str(colors_path))
    server = serve.make_server(cfg, port=0, device="cpu")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["classes"] == 4
        assert health["device"] == "cpu"

        bgr = (np.random.RandomState(0).rand(30, 40, 3) * 255).astype(np.uint8)
        ok, png = cv2.imencode(".png", bgr)
        assert ok

        def post(query=""):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict{query}", data=png.tobytes(),
                method="POST", headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.read(), r.headers.get("Content-Type")

        body, ctype = post()
        assert ctype == "image/png"
        gray = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_GRAYSCALE)
        assert gray.shape == (30, 40) and gray.max() < 4

        # transport only: byte-equal to driving the evaluator directly
        evaluator = serve.build_evaluator(cfg, get_logger(), device="cpu")
        np.testing.assert_array_equal(
            gray, evaluator.predict(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))

        body, ctype = post("?format=json")
        assert ctype == "application/json"
        payload = json.loads(body)
        assert payload["shape"] == [30, 40]
        np.testing.assert_array_equal(payload["classes"],
                                      np.bincount(gray.reshape(-1), minlength=4))

        body, ctype = post("?format=color")
        assert ctype == "image/png"
        from PIL import Image

        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))), gray)

        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert e.value.code == 404
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_build_evaluator_weights(tmp_path):
    logger = get_logger()
    with pytest.raises(RuntimeError, match="no checkpoint"):
        serve.build_evaluator(_cfg(allow_random_weights=False), logger, device="cpu")
    with pytest.raises(ValueError, match="export_format pth"):  # an orbax directory
        serve.build_evaluator(_cfg(model_path=str(tmp_path)), logger, device="cpu")

    # a DDP-style .pth loads strictly and is what gets served
    ref = serve.build_evaluator(_cfg(), logger, seed=7, device="cpu").model
    path = str(tmp_path / "model.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in ref.state_dict().items()}}, path)
    ev = serve.build_evaluator(_cfg(model_path=path, allow_random_weights=False), logger,
                               device="cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(ev.model.state_dict()[k], v), k
    # seeded random weights are reproducible and differ across seeds
    a = serve.build_evaluator(_cfg(), logger, seed=7, device="cpu").model.cls[4].weight
    b = serve.build_evaluator(_cfg(), logger, seed=8, device="cpu").model.cls[4].weight
    assert torch.equal(a, ref.cls[4].weight) and not torch.equal(a, b)


def test_main_raises_without_cuda(monkeypatch):
    """The server does not fall back to the CPU when no GPU is found."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--config", "config/cityscapes/cityscapes_psanet50.yaml",
                    "allow_random_weights", "True"])


def _entry_points():
    """Each entry point that takes a device, called with ``**kw``."""
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.models.build import build_model

    def evaluator(**kw):
        model = build_model(_cfg(), device="cpu")
        return SlidingWindowEvaluator(model, classes=4, crop_h=25, crop_w=25,
                                      mean=serve.IMAGENET_MEAN, std=serve.IMAGENET_STD,
                                      base_size=40, scales=[1.0], **kw)

    return {
        "build_model": lambda **kw: build_model(_cfg(), **kw),
        "build_evaluator": lambda **kw: serve.build_evaluator(_cfg(), get_logger(), **kw),
        "make_server": lambda **kw: serve.make_server(_cfg(), port=0, **kw),
        "SlidingWindowEvaluator": evaluator,
    }


def _close(obj):
    if hasattr(obj, "server_close"):
        obj.server_close()


@pytest.mark.parametrize("entry", ["build_model", "build_evaluator", "make_server",
                                   "SlidingWindowEvaluator"])
def test_entry_point_defaults_to_cuda(monkeypatch, entry):
    """With no device the entry points run on the card: without CUDA they
    raise and do not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _close(_entry_points()[entry]())


@pytest.mark.parametrize("entry", ["build_model", "build_evaluator", "make_server",
                                   "SlidingWindowEvaluator"])
def test_entry_point_runs_on_cpu_when_asked(monkeypatch, entry):
    """``device="cpu"`` runs there, CUDA or not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj = _entry_points()[entry](device="cpu")
    try:
        if entry == "build_model":
            assert next(obj.parameters()).device.type == "cpu"
        elif entry == "make_server":
            assert obj.server_address[1] > 0
        else:
            assert obj.device == torch.device("cpu")
            pred = obj.predict(np.zeros((30, 40, 3), np.uint8))
            assert pred.shape == (30, 40) and pred.max() < 4
    finally:
        _close(obj)


def test_port_imports_no_jax():
    """Importing the port (its data-parallel modules too) and serving one
    image pulls in no jax/flax, and no cv2, yaml or PIL (those load only
    inside the functions that use them)."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import semseg_torch
        import semseg_torch.serve
        import semseg_torch.engine.evaluator
        import semseg_torch.parallel.dist
        import semseg_torch.parallel.parity
        from types import SimpleNamespace
        from semseg_torch.utils.misc import get_logger
        cfg = SimpleNamespace(arch="psp", layers=50, classes=3, zoom_factor=8,
                              train_h=25, train_w=25, test_h=25, test_w=25,
                              base_size=32, scales=[1.0], model_path="",
                              allow_random_weights=True, window_batch=2)
        ev = semseg_torch.serve.build_evaluator(cfg, get_logger(), device="cpu")
        out = ev.predict(np.zeros((20, 32, 3), np.uint8))
        assert out.shape == (20, 32), out.shape
        bad = sorted(m for m in ("jax", "flax", "cv2", "yaml", "PIL", "semseg_tpu")
                     if m in sys.modules)
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
