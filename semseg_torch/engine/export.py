"""Serving export: self-contained ``torch.export`` deployment artifacts.

Port of ``semseg_tpu/engine/export.py``. The JAX package serializes a
StableHLO program with the weights baked in; the port saves a
``torch.export`` program (``.pt2``): the traced ATen graph with the weights,
the normalisation and every constant of the pipeline (resize matrices,
window coverage) in the file. The artifact is

- **self-contained**: ``torch.export.load`` and ``.module()`` run it
  without this package, the model classes or the checkpoint; only an
  artifact that holds the PSA kernel's operator (below) needs the package
  imported first, to register it;
- **batch-polymorphic** (crop scope): traced over a symbolic leading
  ``Dim("batch")``, so one artifact serves any batch size;
- **portable or CUDA-targeted** (``platforms``, the counterpart of
  ``_export_kwargs``): ``["cuda"]`` traces on the card and keeps the PSA
  forward kernel as the registered operator ``semseg::psa_softmax_bmm``
  (``ops/psa.py``; the counterpart of a TPU-only list with
  ``allow_tpu_custom_calls``); ``["cpu"]`` traces on the CPU; both traces
  the plain path on the model's device and must hold no operator of this
  package: ``load_serving(path, device=...)`` moves it to either device
  (``torch.export.passes.move_to_device_pass``). ``"tpu"`` raises: TPU
  artifacts come from the JAX package. The stitch kernel is never in an
  artifact: exports build the model in float32, which takes the unfused
  stitch.

The float32 contract is process-wide, not part of the graph: cuDNN and
cuBLAS run TF32 unless ``torch.backends`` says otherwise
(``models/layers.py::set_precision``), so a float32 program loaded in a
fresh process would move by about 1e-3. :func:`save_serving` stores the
exporting process's TF32 flags in the artifact (``extra/semseg.json``) and
:func:`load_serving` sets them again, for the whole loading process.

The served function is the eval forward of the sliding-window engine (the
crop scope: raw RGB crops in [0, 255], NHWC float32 -> normalise on the
device -> eval forward -> softmax probabilities, logits or the uint8 argmax,
in JAX's NHWC layouts), or the engine's whole program for one image shape
(the full scope: uint8 ``[h, w, 3]`` -> uint8 ``[h, w]``).
"""

from __future__ import annotations

import contextlib
import json
import zipfile
from typing import Optional, Sequence

import torch
from torch import nn

META = "semseg.json"
OUTPUTS = ("probs", "logits", "pred")
PLATFORMS = ("cuda", "cpu")


class ServingModule(nn.Module):
    """The eval forward with the normalisation as buffers: NHWC float32
    crops in [0, 255] ``[B, h, w, 3]`` -> float32 ``probs`` or ``logits``
    ``[B, h, w, C]``, or uint8 ``pred`` ``[B, h, w]``."""

    def __init__(self, model: nn.Module, mean: Sequence[float],
                 std: Optional[Sequence[float]], output: str):
        super().__init__()
        if output not in OUTPUTS:
            raise ValueError(f"output must be one of {OUTPUTS}, got {output!r}")
        device = next(model.parameters()).device
        self.model = model
        self.output = output
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32, device=device))
        self.register_buffer("std", None if std is None else
                             torch.tensor(std, dtype=torch.float32, device=device))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = image - self.mean
        if self.std is not None:
            x = x / self.std
        logits = self.model(x.permute(0, 3, 1, 2).contiguous())
        if self.output == "pred":
            return torch.argmax(logits, dim=1).to(torch.uint8)
        if self.output == "logits":
            return logits.permute(0, 2, 3, 1).contiguous()
        return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1).contiguous()


def make_serving_fn(model: nn.Module, *, mean: Sequence[float],
                    std: Optional[Sequence[float]], output: str = "probs") -> ServingModule:
    """The eval forward with the normalisation baked in, as a module on the
    model's device (``output``: ``probs`` float32 softmax, ``logits``
    float32, or ``pred``, the uint8 argmax the evaluation pipeline returns
    to the host). The model is put in eval mode."""
    return ServingModule(model.eval(), mean, std, output).eval()


class SlidingWindowProgram(nn.Module):
    """An evaluator's whole program as a module (``predict_tensor``), its
    model registered as a submodule so that ``torch.export`` lifts the
    weights."""

    def __init__(self, evaluator):
        super().__init__()
        self.model = evaluator.model
        self.evaluator = evaluator  # not a module: a plain attribute

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.evaluator.predict_tensor(image)


def semseg_ops(exported) -> list:
    """The names of this package's operators (``semseg::...``) in an
    exported program's graph."""
    return sorted({n.target.name() for n in exported.graph.nodes
                   if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
                   and n.target.namespace == "semseg"})


def check_platforms(platforms: Optional[Sequence[str]], device=None) -> None:
    """Raise on a platform list the port cannot serve, or whose tracing
    device is not ``device`` (``None``: the list alone is checked)."""
    if platforms is None:
        return
    platforms = list(platforms)
    if "tpu" in platforms:
        raise ValueError(
            f"export_platforms {platforms}: the port exports for 'cuda' and 'cpu'; TPU "
            "artifacts (StableHLO, with the Pallas kernels as Mosaic custom calls) come from "
            "the JAX package: python tool/export.py --config ... export_platforms \"['tpu']\"")
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"export_platforms must name 'cuda' and/or 'cpu', got {platforms}")
    if device is None or len(set(platforms)) > 1:
        return
    if torch.device(device).type != platforms[0]:
        raise ValueError(f"a {platforms[0]}-targeted export traces on that device; the model "
                         f"is on {device}")


def _trace_device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """Eval mode, no parameter requiring grad and grad off for the
    trace; every submodule's mode and every flag are restored afterwards."""
    modes = [(m, m.training) for m in module.modules()]
    flags = [(p, p.requires_grad) for p in module.parameters()]
    module.eval()
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        with torch.no_grad():
            yield
    finally:
        for m, training in modes:
            m.training = training
        for p, flag in flags:
            p.requires_grad_(flag)


def _export(module: nn.Module, example, warm_up, dynamic_shapes, platforms):
    """Run ``module(warm_up)`` once eagerly, then trace it on ``example``.
    The eager call builds the pipeline's constant tensors on the device
    (``utils.misc.tensor_cache``), so the trace records them as constants
    of the program; a constant built during the trace would instead be
    recorded as a host tensor copied to the device at every call, which
    on CUDA waits for the device."""
    device = _trace_device(module)
    check_platforms(platforms, device)
    with _frozen(module):
        module(warm_up)
        exported = torch.export.export(module, (example,), dynamic_shapes=dynamic_shapes,
                                       strict=False)
    check_portable(exported, platforms)
    return exported


def check_portable(exported, platforms: Optional[Sequence[str]]) -> None:
    """Raise if an export for both platforms holds this package's operators
    (the CUDA kernel's): a portable artifact must load with bare torch."""
    ops = semseg_ops(exported)
    if platforms is not None and len(set(platforms)) > 1 and ops:
        raise ValueError(
            f"a portable export (platforms {list(platforms)}) holds {ops}, the CUDA kernel's "
            "operator: build PSANet with fused_attention False, or target ['cuda']")


def export_serving(model: nn.Module, *, crop_h: int, crop_w: int, mean: Sequence[float],
                   std: Optional[Sequence[float]], output: str = "probs",
                   platforms: Optional[Sequence[str]] = None):
    """Trace the serving function (:func:`make_serving_fn`) over a symbolic
    batch on the model's device, with the weights frozen and grad off,
    after one eager call at batch 1. Returns a
    ``torch.export.ExportedProgram`` holding the weights; save it with
    :func:`save_serving`. ``platforms``: see the module docstring (``None``:
    the model's device, no check)."""
    fn = make_serving_fn(model, mean=mean, std=std, output=output)
    # A dynamic dimension is traced at an example size other than 0 and 1.
    example = torch.zeros((2, crop_h, crop_w, 3), dtype=torch.float32,
                          device=_trace_device(fn))
    dims = {"image": {0: torch.export.Dim("batch")}}
    return _export(fn, example, example[:1], dims, platforms)


def export_sliding_window(evaluator, h: int, w: int, *,
                          platforms: Optional[Sequence[str]] = None):
    """Trace the evaluator's whole program for one input shape ``(h, w)``:
    per scale the long-side resize, mean pad, window chunks with flip,
    count-normalised stitch and resize back, the scales' float32 sum and
    the uint8 argmax (``SlidingWindowEvaluator.predict_tensor``). The
    artifact maps a uint8 ``image[h, w, 3]`` on the evaluator's device to
    uint8 ``[h, w]``; the window grid is static per shape, as in the JAX
    package. The fused stitch kernel cannot be traced (a ``ctypes`` call):
    export a float32 evaluator, which does not take it. The program runs
    once eagerly on a blank image before the trace."""
    if evaluator.fused_stitch and evaluator.device.type == "cuda":
        raise ValueError("the fused stitch kernel is a ctypes call that torch.export cannot "
                         "trace: export a float32 evaluator (fused_stitch False)")
    example = torch.zeros((h, w, 3), dtype=torch.uint8, device=evaluator.device)
    return _export(SlidingWindowProgram(evaluator), example, example, None, platforms)


def save_serving(path: str, exported) -> None:
    """``torch.export.save`` with the artifact's metadata in
    ``extra/semseg.json``: the operators of this package it holds and this
    process's TF32 flags, which ``set_precision`` set when the model was
    built (``{"cuda.matmul": bool, "cudnn": bool}``)."""
    allow_tf32 = {"cuda.matmul": torch.backends.cuda.matmul.allow_tf32,
                  "cudnn": torch.backends.cudnn.allow_tf32}
    meta = {"ops": semseg_ops(exported), "allow_tf32": allow_tf32,
            "torch": torch.__version__}
    torch.export.save(exported, path, extra_files={META: json.dumps(meta)})


def read_meta(path: str) -> Optional[dict]:
    """An artifact's ``extra/semseg.json``, read without loading the
    program (``None`` if it has none)."""
    with zipfile.ZipFile(path) as zf:
        names = [n for n in zf.namelist() if n.endswith(f"extra/{META}")]
        return json.loads(zf.read(names[0])) if names else None


def load_serving(path: str, device=None):
    """Load an artifact; returns the callable program ``fn(image) ->
    output`` on the device it was traced on, or moved to ``device``, with
    its weights frozen. Sets the artifact's TF32 flags for this process.
    Imports the PSA operator's registration (``semseg_torch.ops.psa``) only
    when the artifact holds it; a portable artifact needs nothing but
    torch."""
    meta = read_meta(path)
    if meta is None:
        raise ValueError(f"'{path}' has no extra/{META}: not an artifact of save_serving")
    if meta["ops"]:
        import semseg_torch.ops.psa  # noqa: F401  (registers semseg::psa_softmax_bmm)
    exported = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, torch.device(device))
    torch.backends.cuda.matmul.allow_tf32 = bool(meta["allow_tf32"]["cuda.matmul"])
    torch.backends.cudnn.allow_tf32 = bool(meta["allow_tf32"]["cudnn"])
    fn = exported.module()
    fn.requires_grad_(False)  # the weights are the artifact's constants
    return fn
