"""Model construction from experiment configs.

Port of ``semseg_tpu/models/build.py`` (``arch: psp`` and ``arch: psa``).
``cfg`` is any object with the config keys as attributes
(``semseg_torch.config.Config`` or a plain namespace); optional keys are read
with ``getattr``.
"""

from __future__ import annotations

import torch

from semseg_torch.models.layers import set_batchnorm_replicas, set_precision
from semseg_torch.models.psanet import PSANet
from semseg_torch.models.pspnet import PSPNet
from semseg_torch.utils.misc import resolve_device


def derive_psa_mask_dims(cfg):
    """Resolve (mask_h, mask_w) from the crop size and shrink factor (JAX
    ``build.py:15-39``, reference ``tool/train.py:63-77``): compact mode
    uses the feature extent, otherwise the full relative extent
    ``2*((crop-1)//(8*shrink)+1)-1`` by default; explicit values must be
    odd, >= 3 and no larger than the full extent. Reads ``train_h/w``."""
    shrink = cfg.shrink_factor
    feat_h = (cfg.train_h - 1) // (8 * shrink) + 1
    feat_w = (cfg.train_w - 1) // (8 * shrink) + 1
    if cfg.compact:
        return feat_h, feat_w
    mask_h, mask_w = getattr(cfg, "mask_h", None), getattr(cfg, "mask_w", None)
    if (mask_h is None) != (mask_w is None):
        raise ValueError("mask_h and mask_w must both be set or both unset")
    full_h, full_w = 2 * feat_h - 1, 2 * feat_w - 1
    if mask_h is None:
        return full_h, full_w
    if not (mask_h % 2 == 1 and 3 <= mask_h <= full_h):
        raise ValueError(f"mask_h={mask_h} invalid (odd, 3..{full_h})")
    if not (mask_w % 2 == 1 and 3 <= mask_w <= full_w):
        raise ValueError(f"mask_w={mask_w} invalid (odd, 3..{full_w})")
    return mask_h, mask_w


def validate_arch(cfg):
    """Architecture/shape invariants of the config (as in the JAX package)."""
    if cfg.classes <= 1:
        raise ValueError("classes must be > 1")
    if cfg.zoom_factor not in (1, 2, 4, 8):
        raise ValueError(f"zoom_factor={cfg.zoom_factor} not in (1,2,4,8)")
    if cfg.arch not in ("psp", "psa"):
        raise ValueError(f"architecture {cfg.arch!r} not supported")
    if (cfg.train_h - 1) % 8 != 0 or (cfg.train_w - 1) % 8 != 0:
        raise ValueError("(train_h-1) and (train_w-1) must be multiples of 8")


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg) -> torch.dtype:
    """The config's ``compute_dtype``: float32 by default (the reference
    recipe trains in f32), bfloat16 opt-in (``tool/train.py:123-138``)."""
    name = getattr(cfg, "compute_dtype", None) or "float32"
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {name!r}")
    return COMPUTE_DTYPES[name]


def build_model(cfg, dtype: torch.dtype = torch.float32, device=None,
                seed: int = 0, train: bool = False, replicas: int = 1,
                process_group=None, tp_group=None):
    """The model described by ``cfg`` on ``device`` (``None``: the CUDA
    device, raising without one; the CPU only as ``device="cpu"``), with
    seeded random weights (load a checkpoint over them to serve real ones), in eval mode,
    or in train mode with ``train``. float32 models run with TF32 off, or
    on for ``matmul_precision: high`` (``layers.set_precision``). ``remat``
    (default off) recomputes the backbone's residual blocks in the backward
    pass (``models/resnet.py``).

    Train-mode BatchNorm follows ``sync_bn`` (default True) as JAX's
    ``build_model(..., data_shards=replicas)`` does (``build.py:54-73``):
    - with a ``process_group`` (one DDP rank of the group; ``replicas``
      stays 1), ``sync_bn: True`` takes the moments over the batches of
      every rank, and ``sync_bn: False`` over the rank's own batch, whose
      running statistics DDP's ``broadcast_buffers`` replaces with rank
      0's before every forward (JAX's group-0 rule);
    - in one process, ``replicas`` is the number of equal batch slices the
      batch stands for: ``sync_bn: True`` takes the moments over the whole
      batch, ``sync_bn: False`` per slice (JAX's BN groups)."""
    if replicas < 1 or (replicas > 1 and process_group is not None):
        raise ValueError(f"replicas={replicas} with a process group: a DDP rank's model "
                         "holds one replica")
    validate_arch(cfg)
    device = resolve_device(device)
    set_precision(dtype, getattr(cfg, "matmul_precision", None))
    remat = bool(getattr(cfg, "remat", None) or False)  # JAX build.py:80,106
    if cfg.arch == "psp":
        model = PSPNet(layers=cfg.layers, classes=cfg.classes,
                       zoom_factor=cfg.zoom_factor, dtype=dtype, remat=remat)
    else:
        mask_h, mask_w = derive_psa_mask_dims(cfg)
        # An empty normalization_factor defaults to mask_h*mask_w
        # (reference model/psanet.py:20-22).
        norm = getattr(cfg, "normalization_factor", None)
        if norm is None:
            norm = float(mask_h * mask_w)
        model = PSANet(
            layers=cfg.layers, classes=cfg.classes, zoom_factor=cfg.zoom_factor,
            psa_type=cfg.psa_type, compact=bool(cfg.compact),
            shrink_factor=cfg.shrink_factor, mask_h=mask_h, mask_w=mask_w,
            normalization_factor=norm, psa_softmax=bool(cfg.psa_softmax),
            # None = auto (the CUDA kernels on CUDA); True/False force.
            fused_attention=getattr(cfg, "fused_attention", None), dtype=dtype,
            remat=remat)
    model.init_weights(torch.Generator().manual_seed(seed))
    if tp_group is not None:
        import torch.distributed as dist

        from semseg_torch.parallel.tensor import shard_model

        shard_model(model, tp_group, dist.get_rank(tp_group), dist.get_world_size(tp_group))
    sync_bn = getattr(cfg, "sync_bn", None)
    sync_bn = True if sync_bn is None else bool(sync_bn)
    if process_group is not None:
        set_batchnorm_replicas(model, process_group=process_group if sync_bn else None)
    elif not sync_bn:
        set_batchnorm_replicas(model, groups=replicas)
    return model.to(device).train(train)
