"""Weights into the port: JAX variables and reference ``.pth`` files.

``state_dict_from_jax`` is the counterpart of the JAX package's
``export_torch_state_dict(variables, arch, layers, ddp_prefix=False)``
(``semseg_tpu/models/convert.py:229-280``), which the port cannot import
(its package pulls in flax). It maps ``{"params", "batch_stats"}`` (nested
dicts of numpy arrays) onto the reference module naming that the port's
models carry:
- conv kernels HWIO -> OIHW;
- BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) ->
  ``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked``).
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))  # a copy: JAX arrays are read-only


def _oihw(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1))


def _convbn(out, params, stats, conv_key, bn_key):
    """One flax ConvBN subtree -> Conv2d + BatchNorm2d entries."""
    out[f"{conv_key}.weight"] = _oihw(params["conv"]["kernel"])
    out[f"{bn_key}.weight"] = _tensor(params["bn"]["scale"])
    out[f"{bn_key}.bias"] = _tensor(params["bn"]["bias"])
    out[f"{bn_key}.running_mean"] = _tensor(stats["bn"]["mean"])
    out[f"{bn_key}.running_var"] = _tensor(stats["bn"]["var"])
    out[f"{bn_key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


_STEM = (("stem_cb1", "layer0.0", "layer0.1"),
         ("stem_cb2", "layer0.3", "layer0.4"),
         ("stem_cb3", "layer0.6", "layer0.7"))
_BLOCK = re.compile(r"layer(\d)_block(\d+)$")


def _backbone(out, params, stats):
    for name, conv, bn in _STEM:
        if name in params:
            _convbn(out, params[name], stats[name], conv, bn)
    for name, block in params.items():
        m = _BLOCK.match(name)
        if m is None:
            continue
        key = f"layer{m.group(1)}.{m.group(2)}"
        for ci in (1, 2, 3):
            if f"cb{ci}" in block:
                _convbn(out, block[f"cb{ci}"], stats[name][f"cb{ci}"],
                        f"{key}.conv{ci}", f"{key}.bn{ci}")
        if "downsample" in block:
            _convbn(out, block["downsample"], stats[name]["downsample"],
                    f"{key}.downsample.0", f"{key}.downsample.1")


def _head(out, params, stats, name):
    if name not in params:
        return
    _convbn(out, params[name]["cb"], stats[name]["cb"], f"{name}.0", f"{name}.1")
    out[f"{name}.4.weight"] = _oihw(params[name]["conv_logits"]["kernel"])
    out[f"{name}.4.bias"] = _tensor(params[name]["conv_logits"]["bias"])


def _psa(out, params, stats):
    """The PSA subtree (JAX ``export_torch_state_dict``, ``convert.py:260-274``):
    ``reduce{,_p}`` -> ``psa.reduce{,_p}.{0,1}``, ``attention{,_p}_cb`` ->
    ``psa.attention{,_p}.{0,1}`` with the logits conv as ``.3``, ``proj``."""
    for suffix in ("", "_p"):
        if f"reduce{suffix}" in params:
            _convbn(out, params[f"reduce{suffix}"], stats[f"reduce{suffix}"],
                    f"psa.reduce{suffix}.0", f"psa.reduce{suffix}.1")
        if f"attention{suffix}_cb" in params:
            _convbn(out, params[f"attention{suffix}_cb"],
                    stats[f"attention{suffix}_cb"],
                    f"psa.attention{suffix}.0", f"psa.attention{suffix}.1")
            out[f"psa.attention{suffix}.3.weight"] = _oihw(
                params[f"attention{suffix}_conv"]["kernel"])
    _convbn(out, params["proj"], stats["proj"], "psa.proj.0", "psa.proj.1")


def backbone_state_dict_from_jax(variables):
    """A bare JAX ``ResNet``'s variables -> the port ``ResNet`` state_dict."""
    out = {}
    _backbone(out, variables["params"], variables["batch_stats"])
    return out


def state_dict_from_jax(variables, arch: str = "psp", layers: int = 50):
    """JAX segmentation-model variables -> the port's state_dict, key for
    key the reference naming (``layers`` is implied by the tree and kept
    for the JAX exporter's signature)."""
    if arch not in ("psp", "psa"):
        raise ValueError(f"architecture {arch!r} not supported")
    params, stats = variables["params"], variables["batch_stats"]
    out = {}
    _backbone(out, params["backbone"], stats["backbone"])
    if arch == "psp":
        for i in range(len(params.get("ppm", {}))):
            _convbn(out, params["ppm"][f"branch{i}"], stats["ppm"][f"branch{i}"],
                    f"ppm.features.{i}.1", f"ppm.features.{i}.2")
    elif "psa" in params:
        _psa(out, params["psa"], stats["psa"])
    _head(out, params, stats, "cls")
    _head(out, params, stats, "aux")
    return out


def load_pth(path: str):
    """A reference or DDP ``.pth`` -> state_dict with ``module.`` stripped
    (reference ``tool/test.py:112-113``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}
