"""Inference server for the port: ``tool/serve.py`` on PyTorch.

Loads weights once, builds the sliding-window evaluator and answers
per-image requests over HTTP (stdlib only):

    POST /predict           body: encoded image (anything cv2 decodes,
                            BGR like cv2.imread) -> gray PNG class map
    POST /predict?format=color   -> palette-color PNG (needs colors_path)
    POST /predict?format=json    -> {"shape", "classes" histogram}
    GET  /healthz           liveness + model/config echo

Requests are served one at a time on the device (a lock around
``predict``). Scales, crop and flip come from the TEST section of the
config, as in the batch tester.

Usage (on ``cuda:{test_gpu[0]}``; without a CUDA device ``main`` raises):
    python -m semseg_torch.serve --config config/cityscapes/cityscapes_pspnet50.yaml \\
        model_path exp/.../model.pth [serve_port 8080]
    python -m semseg_torch.serve --config config/cityscapes/cityscapes_psanet50.yaml \\
        model_path exp/.../model.pth [serve_port 8080]

Smoke (random weights):
    python -m semseg_torch.serve --config ... allow_random_weights True serve_port 0
"""

from __future__ import annotations

import io
import json
import os
import threading

import numpy as np
import torch

IMAGENET_MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
IMAGENET_STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]


def build_evaluator(cfg, logger, dtype: torch.dtype = torch.float32,
                    device=None, seed: int = 0):
    """Model + weights + sliding-window pipeline, as ``tool/serve.py``.
    ``cfg`` is a ``semseg_torch.config.Config`` or any namespace with the
    same attributes (optional keys are read with ``getattr``). ``device=None``
    is the CUDA device and raises without one; the CPU only as
    ``device="cpu"``.

    Weights come from ``cfg.model_path`` (a reference or port ``.pth``),
    else from ``seed`` when ``allow_random_weights`` is set; anything else
    raises."""
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.models.build import build_model
    from semseg_torch.models.convert import load_pth
    from semseg_torch.utils.misc import resolve_device

    device = resolve_device(device)
    model = build_model(cfg, dtype=dtype, device=device, seed=seed)
    path = getattr(cfg, "model_path", None) or ""
    if os.path.isfile(path) and path.endswith(".pth"):
        model.load_state_dict(load_pth(path), strict=True)
        logger.info("=> loaded checkpoint '%s'", path)
    elif os.path.exists(path):
        raise NotImplementedError(
            f"'{path}': only .pth checkpoints load in the port so far "
            "(orbax checkpoints: ROADMAP queue 1 item 9)")
    elif getattr(cfg, "allow_random_weights", None):
        logger.warning("serving RANDOM weights (allow_random_weights)")
    else:
        raise RuntimeError(f"=> no checkpoint found at '{path}'")

    return SlidingWindowEvaluator(
        model, classes=cfg.classes, crop_h=cfg.test_h, crop_w=cfg.test_w,
        mean=IMAGENET_MEAN, std=IMAGENET_STD, base_size=cfg.base_size,
        scales=cfg.scales, window_batch=getattr(cfg, "window_batch", None) or 16,
        mode=getattr(cfg, "eval_pipeline", None) or "device_bucketed", device=device,
    )


def make_server(cfg, port=None, device=None):
    """Build (and return, unstarted) the HTTP server; ``.serve_forever()``
    to run. The returned object has ``.server_address`` for tests.
    ``device=None`` serves on the CUDA device and raises without one."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from semseg_torch.utils.misc import colorize, get_logger

    logger = get_logger()
    evaluator = build_evaluator(cfg, logger, device=device)
    lock = threading.Lock()
    colors = None
    colors_path = getattr(cfg, "colors_path", None)
    if colors_path and os.path.isfile(colors_path):
        colors = np.loadtxt(colors_path).astype("uint8")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            logger.info("serve: " + fmt, *args)

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] != "/healthz":
                return self._send(404, b"not found", "text/plain")
            info = json.dumps({
                "status": "ok", "arch": cfg.arch, "layers": cfg.layers,
                "classes": cfg.classes, "scales": list(cfg.scales),
                "crop": [cfg.test_h, cfg.test_w],
                "device": str(evaluator.device),
            }).encode()
            self._send(200, info, "application/json")

        def do_POST(self):
            import cv2

            path, _, query = self.path.partition("?")
            if path != "/predict":
                return self._send(404, b"not found", "text/plain")
            fmt = "gray"
            for part in query.split("&"):
                if part.startswith("format="):
                    fmt = part.split("=", 1)[1]
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
            if bgr is None:
                return self._send(400, b"undecodable image", "text/plain")
            # BGR -> RGB; stays uint8 (the evaluator casts on the device)
            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            with lock:
                gray = evaluator.predict(rgb)
            if fmt == "json":
                hist = np.bincount(gray.reshape(-1),
                                   minlength=cfg.classes).tolist()
                body = json.dumps(
                    {"shape": list(gray.shape), "classes": hist}
                ).encode()
                return self._send(200, body, "application/json")
            if fmt == "color":
                if colors is None:
                    return self._send(400, b"no colors_path configured",
                                      "text/plain")
                buf = io.BytesIO()
                colorize(gray, colors).save(buf, format="PNG")
                return self._send(200, buf.getvalue(), "image/png")
            ok, png = cv2.imencode(".png", gray)
            if not ok:
                return self._send(500, b"png encode failed", "text/plain")
            return self._send(200, png.tobytes(), "image/png")

    port = getattr(cfg, "serve_port", None) if port is None else port
    server = ThreadingHTTPServer(("127.0.0.1", int(port or 0)), Handler)
    logger.info("serving on http://127.0.0.1:%d (scales=%s, crop=%dx%d, %s)",
                server.server_address[1], list(cfg.scales),
                cfg.test_h, cfg.test_w, evaluator.device)
    return server


def main(argv=None):
    """Serve on ``cuda:{test_gpu[0]}`` (``cuda:0`` when the key is absent).
    Without a CUDA device it raises; ``make_server(cfg, device="cpu")``
    serves on the CPU explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "semseg_torch.serve needs a CUDA device and "
            "torch.cuda.is_available() is false; call "
            "make_server(cfg, device='cpu') to serve on the CPU")
    from semseg_torch.config import parse_config_args  # imports yaml

    cfg = parse_config_args(
        argv, default_config="config/cityscapes/cityscapes_pspnet50.yaml"
    )
    gpus = getattr(cfg, "test_gpu", None) or [0]
    make_server(cfg, device=f"cuda:{gpus[0]}").serve_forever()


if __name__ == "__main__":
    main()
