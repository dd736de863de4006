"""Tensor ops: bilinear resizes, pooling and the fused stitch kernel."""
