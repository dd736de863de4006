"""Losses: cross-entropy with ignore-label masking.

Port of ``semseg_tpu/engine/losses.py`` (``nn.CrossEntropyLoss(
ignore_index=...)``, reference ``tool/train.py:121``), channels-first:
``logits`` are ``[N, C, ...]`` and ``labels`` ``[N, ...]``. The JAX
package's logsumexp-dot form worked around per-pixel gathers on the TPU;
here ``F.cross_entropy`` is the natural form, with the same values.
"""

from __future__ import annotations

import torch.nn.functional as F


def nll_and_valid(logits, labels, ignore_index: int = 255):
    """Per-pixel negative log-likelihood (float32, 0 at ignored pixels)
    and the float32 valid mask, both shaped like ``labels``."""
    labels = labels.long()
    nll = F.cross_entropy(logits.float(), labels, ignore_index=ignore_index,
                          reduction="none")
    return nll, (labels != ignore_index).float()


def cross_entropy_sum(logits, labels, ignore_index: int = 255):
    """(sum of the per-pixel NLL over valid pixels, valid count)."""
    nll, valid = nll_and_valid(logits, labels, ignore_index)
    return (nll * valid).sum(), valid.sum()


def cross_entropy_mean(logits, labels, ignore_index: int = 255):
    """Valid-pixel mean CE (torch 'mean' reduction with ignore_index)."""
    loss_sum, count = cross_entropy_sum(logits, labels, ignore_index)
    return loss_sum / count.clamp_min(1.0)
