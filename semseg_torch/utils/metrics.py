"""Segmentation metrics: per-class intersection / union / target histograms.

Port of ``semseg_tpu/utils/metrics.py`` (copied, not imported: that
package's ``utils/__init__.py`` imports jax). mIoU = mean(intersection /
union), mAcc = mean(intersection / target), allAcc = sum(intersection) /
sum(target), as the reference (``util/util.py:40-67``). Pixels whose
target is ``ignore_index`` are left out by overwriting the prediction
with it before the histograms.
"""

from __future__ import annotations

import numpy as np
import torch


class AverageMeter:
    """Tracks current value, running sum and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / self.count


def intersection_and_union(output, target, num_classes: int, ignore_index: int = 255):
    """int64 ``[num_classes]`` histograms of integer class maps of one
    shape, on their device. Values outside ``[0, num_classes)`` count in no
    bin, as in the JAX one-hot version. ``scatter_add_`` rather than
    ``bincount``, which reads its input's max back to the host (a device
    sync in every train step)."""
    output = output.reshape(-1).long()
    target = target.reshape(-1).long()
    output = torch.where(target == ignore_index, ignore_index, output)

    def hist(values, keep):
        keep = keep & (values >= 0) & (values < num_classes)
        bins = torch.zeros(num_classes + 1, dtype=torch.int64, device=values.device)
        bins.scatter_add_(0, torch.where(keep, values, num_classes), torch.ones_like(values))
        return bins[:num_classes]

    area_intersection = hist(output, output == target)
    area_output = hist(output, torch.ones_like(output, dtype=torch.bool))
    area_target = hist(target, torch.ones_like(target, dtype=torch.bool))
    return area_intersection, area_output + area_target - area_intersection, area_target


def summarize(intersection_sum, union_sum, target_sum):
    """(mIoU, mAcc, allAcc) from accumulated histograms (numpy or CPU
    tensors)."""
    inter, union, target = (np.asarray(v, np.float64)
                            for v in (intersection_sum, union_sum, target_sum))
    iou = inter / (union + 1e-10)
    acc = inter / (target + 1e-10)
    return (float(np.mean(iou)), float(np.mean(acc)),
            float(np.sum(inter) / (np.sum(target) + 1e-10)))
