"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernel is built from
``semseg_torch/csrc`` at first use); without a card they skip. The file
imports no JAX, so it runs on a machine that has only the port's
dependencies: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from semseg_torch.ops import stitch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stitch kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("p,c,hs,out", [
    (4, 19, 90, 713),   # Cityscapes 713 crops (main path)
    (4, 150, 60, 473),  # ADE20K 473 crops
    (3, 5, 13, 97),
    (1, 2, 1, 1),
])
def test_stitch_kernel_matches_plain(cuda, p, c, hs, out):
    """max abs diff <= 2e-2 (bf16 output rounding, exp ulps, online vs
    two-pass softmax sums) and rows summing to 1 +- 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(0)
    lp = (torch.randn(p, 2, c, hs, hs, generator=g, device=cuda) * 3).to(torch.bfloat16)
    before = stitch.upsample_softmax_flip.launches
    got = stitch.upsample_softmax_flip(lp, (out, out))
    torch.cuda.synchronize()
    assert stitch.upsample_softmax_flip.launches == before + 1
    want = stitch.upsample_softmax_flip_reference(lp, (out, out))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert (got.float().sum(1) - 1).abs().max().item() <= 2e-2


def test_stitch_kernel_non_square(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    lp = torch.randn(2, 2, 7, 9, 13, generator=g, device=cuda).to(torch.bfloat16)
    got = stitch.upsample_softmax_flip(lp, (65, 97))
    want = stitch.upsample_softmax_flip_reference(lp, (65, 97))
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_stitch_kernel_rejects_what_it_does_not_take(cuda):
    lp = torch.zeros(1, 2, 3, 5, 5, device=cuda)
    with pytest.raises(ValueError):
        stitch.upsample_softmax_flip(lp, (9, 9))  # float32
    with pytest.raises(ValueError):
        stitch.upsample_softmax_flip(
            lp.to(torch.bfloat16).transpose(-1, -2), (9, 9))  # not contiguous
    with pytest.raises(ValueError):
        stitch.upsample_softmax_flip(lp[:, 0].to(torch.bfloat16), (9, 9))  # no pair axis


def test_fused_slice_on_cuda(cuda):
    """A small bf16 PSPNet50 through the evaluator: the fused path is
    picked automatically, launches the kernel once per chunk and agrees
    with the unfused path."""
    from types import SimpleNamespace

    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD, build_evaluator
    from semseg_torch.utils.misc import get_logger

    cfg = SimpleNamespace(arch="psp", layers=50, classes=19, zoom_factor=8,
                          train_h=97, train_w=97, test_h=97, test_w=97,
                          base_size=256, scales=[1.0], model_path="",
                          allow_random_weights=True, window_batch=8,
                          eval_pipeline="device")
    ev = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=cuda)
    assert ev.fused_stitch
    image = (np.random.RandomState(0).rand(128, 256, 3) * 255).astype(np.uint8)
    before = stitch.upsample_softmax_flip.launches
    fused = ev.predict_probs(image)
    n_chunks = len(ev._geometry(128, 256).chunks)
    assert stitch.upsample_softmax_flip.launches == before + n_chunks
    plain = SlidingWindowEvaluator(
        ev.model, classes=19, crop_h=97, crop_w=97, mean=IMAGENET_MEAN,
        std=IMAGENET_STD, base_size=256, scales=[1.0], window_batch=8,
        fused_stitch=False, device=cuda)
    other = plain.predict_probs(image)
    assert fused.shape == (128, 256, 19)
    assert np.abs(fused - other).max() <= 2e-2
    assert (fused.argmax(-1) == other.argmax(-1)).mean() >= 0.995
