"""Tensor ops: bilinear resizes, pooling, the fused stitch kernel, the PSA
kernels and the inference-mode BatchNorm kernel."""


def launch_counters() -> dict:
    """Every wrapper of the port's kernels that counts its launches in
    ``.launches`` (kernels, routes and entry points), by name."""
    from semseg_torch.ops import batchnorm, psa, stitch

    return {name: fn for mod in (batchnorm, stitch, psa)
            for name, fn in sorted(vars(mod).items())
            if callable(fn) and hasattr(fn, "launches")}
