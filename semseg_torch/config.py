"""Experiment configuration system of the port (a copy of
``semseg_tpu/config.py``, which the port does not import).

Schema-compatible with the reference YAML configs (reference:
``util/config.py:10-159``): a YAML file whose *top-level sections*
(DATA/TRAIN/Distributed/TEST) are flattened into one attribute-access
namespace, plus ``KEY VALUE`` positional CLI overrides where only the last
dotted component of KEY is matched and values are decoded with
``ast.literal_eval`` (with list<->tuple coercion against the existing value's
type).
"""

from __future__ import annotations

import copy
import os
from ast import literal_eval


class Config(dict):
    """A dict with attribute access. Missing attributes raise AttributeError."""

    def __init__(self, mapping=None):
        mapping = {} if mapping is None else dict(mapping)
        for key, value in mapping.items():
            if isinstance(value, dict):
                mapping[key] = Config(value)
        super().__init__(mapping)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def clone(self) -> "Config":
        return copy.deepcopy(self)

    def __str__(self):
        lines = []
        for key in sorted(self):
            value = self[key]
            lines.append(f"{key}: {value}")
        return "\n".join(lines)

    def __repr__(self):
        return f"{self.__class__.__name__}({dict.__repr__(self)})"


# Backwards-friendly alias mirroring the reference class name.
CfgNode = Config

# Framework extension keys accepted as CLI overrides even when absent from
# the experiment YAML (the reference rejects unknown keys,
# util/config.py:117; these are this framework's additional knobs,
# documented in README.md "Configuration extensions").
EXTENSION_KEYS = frozenset({
    "pretrained", "initmodel", "compute_dtype", "model_parallel",
    "native_loader", "eval_pipeline", "window_batch", "profile_dir",
    "remat", "image", "allow_random_weights", "image_wire_dtype",
    "eval_bucket", "matmul_precision", "fused_attention", "async_save",
    "eval_devices", "eval_partition",
    # tool/export.py (serving artifacts) / tool/serve.py (HTTP server)
    "export_path", "export_format", "export_output", "export_platforms",
    "export_scope", "export_h", "export_w",
    "serve_port",
})


def load_cfg(path: str) -> Config:
    """Load a YAML experiment file, flattening top-level sections.

    Every second-level key becomes a top-level attribute; section names are
    discarded (later sections win on key collision, matching the reference
    loader's dict-update order).
    """
    import yaml

    if not (os.path.isfile(path) and path.endswith(".yaml")):
        raise ValueError(f"{path} is not a yaml file")
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    flat = {}
    for section in raw:
        section_value = raw[section]
        if not isinstance(section_value, dict):
            raise ValueError(
                f"top-level key {section!r} must be a mapping of options"
            )
        for key, value in section_value.items():
            flat[key] = value
    return Config(flat)


# Alias with the reference's function name so ported scripts read naturally.
load_cfg_from_cfg_file = load_cfg


def merge_cfg_from_list(cfg: Config, override_list) -> Config:
    """Apply ``[KEY, VALUE, KEY, VALUE, ...]`` CLI overrides.

    Only the last dotted component of KEY is matched against the flattened
    namespace; VALUE strings are decoded via ``literal_eval`` and coerced
    between list and tuple to match the existing value's type. Unknown keys
    are an error.
    """
    new_cfg = cfg.clone()
    if len(override_list) % 2 != 0:
        raise ValueError(
            f"override list must have an even number of elements, got "
            f"{len(override_list)}: {override_list}"
        )
    for full_key, raw_value in zip(override_list[0::2], override_list[1::2]):
        subkey = full_key.split(".")[-1]
        if subkey not in cfg and subkey not in EXTENSION_KEYS:
            raise KeyError(f"Non-existent config key: {full_key}")
        value = _decode_value(raw_value)
        value = _coerce_value_type(value, cfg.get(subkey), full_key)
        setattr(new_cfg, subkey, value)
    return new_cfg


def _decode_value(value):
    """Decode a raw override string into a Python object when possible.

    Strings that parse as Python literals (numbers, lists, tuples, dicts,
    booleans, None) are converted; anything else (bare words, paths) passes
    through as the original string.
    """
    if not isinstance(value, str):
        return value
    try:
        return literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce_value_type(replacement, original, full_key):
    """Require type match between override and original, allowing a few casts.

    list<->tuple conversions are performed silently; if the original value is
    None (unset option) any replacement type is accepted.
    """
    if original is None or replacement is None:
        return replacement
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type is original_type:
        return replacement
    if replacement_type is tuple and original_type is list:
        return list(replacement)
    if replacement_type is list and original_type is tuple:
        return tuple(replacement)
    # int -> float widening is safe and common for CLI overrides.
    if replacement_type is int and original_type is float:
        return float(replacement)
    raise ValueError(
        f"Type mismatch ({original_type} vs. {replacement_type}) with values "
        f"({original!r} vs. {replacement!r}) for config key: {full_key}"
    )


def parse_config_args(argv=None, default_config=None):
    """Parse ``--config PATH [KEY VALUE ...]`` command lines into a Config."""
    import argparse

    parser = argparse.ArgumentParser(description="semantic segmentation")
    parser.add_argument(
        "--config", type=str, default=default_config, help="config file"
    )
    parser.add_argument(
        "opts",
        help="KEY VALUE pairs overriding config options",
        default=None,
        nargs=argparse.REMAINDER,
    )
    args = parser.parse_args(argv)
    if args.config is None:
        raise ValueError("--config is required")
    cfg = load_cfg(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    return cfg
