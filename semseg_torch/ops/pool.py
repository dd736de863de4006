"""Pooling with the semantics of ``semseg_tpu/ops/pool.py``, NCHW layout.

- ``adaptive_avg_pool2d``: ``nn.AdaptiveAvgPool2d`` regions
  (``start = floor(i*H/bins)``, ``end = ceil((i+1)*H/bins)``), averaged in
  float32 and cast back to the input dtype, as the JAX matmul form does
  (reference ``model/pspnet.py:14``).
- ``max_pool2d``: ``nn.MaxPool2d(kernel, stride, padding)``; padded
  positions never win (reference ``model/resnet.py:115``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x.float(), output_size).to(x.dtype)


def max_pool2d(x: torch.Tensor, kernel_size: int = 3, stride: int = 2,
               padding: int = 1) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size, stride, padding)


class AdaptiveAvgPool2d(nn.Module):
    """Module form of ``adaptive_avg_pool2d`` (the first entry of each
    reference PPM branch, ``ppm.features.{i}.0``)."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size)
