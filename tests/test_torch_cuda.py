"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels are built
from ``semseg_torch/csrc`` at first use); without a card they skip. The file
imports no JAX, so it runs on a machine that has only the port's
dependencies: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from semseg_torch.ops import psa, stitch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
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


@pytest.mark.parametrize("n,c,hw,dtype", [
    (1, 5, 1, torch.float32),        # a single position
    (2, 7, 37, torch.float32),       # ragged C and hw, several column tiles
    (1, 130, 97, torch.bfloat16),    # two channel tiles, ragged stages
    (3, 16, 200, torch.bfloat16),
    (8, 512, 2025, torch.bfloat16),  # Cityscapes PSANet (resident on the path)
    (1, 512, 7921, torch.bfloat16),  # shrink 1 (flash on the path)
])
def test_psa_kernels_match_plain(cuda, n, c, hw, dtype):
    """Both kernels, whatever the rule picks: max abs diff <= 1e-4 *
    max|plain| + 1e-5 (f32 sums over up to hw terms in another order);
    flash m exact and l within 1e-5 relative."""
    g = torch.Generator(device=cuda).manual_seed(hw)
    x = torch.randn(n, c, hw, generator=g, device=cuda).to(dtype)
    a = (torch.randn(n, hw, hw, generator=g, device=cuda) * 3).to(dtype)
    want = psa.psa_softmax_bmm_reference(x, a, 1.3)
    m_ref, l_ref = psa.psa_softmax_stats(a)
    bar = 1e-4 * want.abs().max().item() + 1e-5
    before = (psa.psa_softmax_bmm.launches, psa.psa_softmax_bmm_flash.launches)
    res = psa.psa_softmax_bmm(x, a, 1.3)
    out, m, l = psa.psa_softmax_bmm_flash(x, a, 1.3, return_stats=True)
    torch.cuda.synchronize()
    assert (psa.psa_softmax_bmm.launches, psa.psa_softmax_bmm_flash.launches) == (
        before[0] + 1, before[1] + 1)
    assert res.dtype == out.dtype == torch.float32 and res.shape == want.shape
    assert (res - want).abs().max().item() <= bar
    assert (out - want).abs().max().item() <= bar
    assert torch.equal(m, m_ref)
    assert ((l - l_ref).abs() / l_ref).max().item() <= 1e-5


def test_psa_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 9, device=cuda)
    a = torch.zeros(1, 9, 9, device=cuda)
    for fn in (psa.psa_softmax_bmm, psa.psa_softmax_bmm_flash):
        with pytest.raises(ValueError, match="both"):
            fn(x, a.to(torch.bfloat16))  # mismatched dtypes
        with pytest.raises(ValueError, match="both"):
            fn(x.half(), a.half())
        with pytest.raises(ValueError, match="contiguous"):
            fn(x, a.transpose(1, 2))
        with pytest.raises(ValueError, match="HW"):
            fn(x, a[:, :8])
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, a.cpu())
        with pytest.raises(NotImplementedError, match="queue 2"):
            fn(x.requires_grad_(), a)
        x = x.detach()
        with torch.no_grad():
            fn(x.requires_grad_(), a)  # no graph is recorded: fine
        x = x.detach()


def test_psanet_slice_on_cuda(cuda):
    """A small bf16 PSANet50 through build_evaluator: per chunk the stitch
    kernel once and the resident PSA kernel twice (two directions); the
    probabilities agree with the plain attention."""
    from types import SimpleNamespace

    from semseg_torch.serve import build_evaluator
    from semseg_torch.utils.misc import get_logger

    cfg = SimpleNamespace(arch="psa", layers=50, classes=19, zoom_factor=8,
                          train_h=97, train_w=97, test_h=97, test_w=97,
                          base_size=256, scales=[1.0], model_path="",
                          allow_random_weights=True, window_batch=8,
                          eval_pipeline="device", psa_type=2, compact=0,
                          shrink_factor=2, normalization_factor=1.0, psa_softmax=1)
    ev = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=cuda)
    assert ev.fused_stitch
    image = (np.random.RandomState(0).rand(128, 256, 3) * 255).astype(np.uint8)
    before = (stitch.upsample_softmax_flip.launches, psa.psa_softmax_bmm.launches,
              psa.psa_softmax_bmm_flash.launches)
    fused = ev.predict_probs(image)
    n_chunks = len(ev._geometry(128, 256).chunks)
    assert (stitch.upsample_softmax_flip.launches, psa.psa_softmax_bmm.launches,
            psa.psa_softmax_bmm_flash.launches) == (
        before[0] + n_chunks, before[1] + 2 * n_chunks, before[2])
    ev.model.psa.fused_attention = False
    plain = ev.predict_probs(image)
    assert fused.shape == (128, 256, 19)
    assert np.abs(fused - plain).max() <= 2e-2
    assert (fused.argmax(-1) == plain.argmax(-1)).mean() >= 0.995
