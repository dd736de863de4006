"""The port's CUDA kernels on the card, against their plain PyTorch versions,
and a PSANet training step through them.

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
    # 150 classes: five chunks, the last of 22; 97^2 pixels end in a partial
    # 1024-pixel block; odd rows, 2-byte aligned
    (2, 150, 13, 97),
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


def test_stitch_kernel_plans_wide_rows(cuda):
    """A source row of 700 columns: the H pass of 32 classes would not fit
    the kernel's shared-memory budget, so it runs 4 classes a chunk (ten
    chunks, the statistics in shared memory)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    lp = (torch.randn(1, 2, 40, 5, 700, generator=g, device=cuda) * 3).to(torch.bfloat16)
    got = stitch.upsample_softmax_flip(lp, (33, 5593))
    want = stitch.upsample_softmax_flip_reference(lp, (33, 5593))
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert (got.float().sum(1) - 1).abs().max().item() <= 2e-2


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
    n_chunks = len(ev._geometry(128, 256, 1.0).chunks)
    assert stitch.upsample_softmax_flip.launches == before + n_chunks
    plain = SlidingWindowEvaluator(
        ev.model, classes=19, crop_h=97, crop_w=97, mean=IMAGENET_MEAN,
        std=IMAGENET_STD, base_size=256, scales=[1.0], window_batch=8,
        fused_stitch=False, device=cuda)
    other = plain.predict_probs(image)
    assert fused.shape == (128, 256, 19)
    assert np.abs(fused - other).max() <= 2e-2
    assert (fused.argmax(-1) == other.argmax(-1)).mean() >= 0.995


def _fwd_bars(x, a, norm):
    """The tensor-core forward's bar, element by element:

        |kernel - plain| <= 2^-8 (|x| @ p) / norm + 1e-6.

    The kernel rounds p to bf16 (2^-9 relative, the TPU's DEFAULT-precision
    pass), and the f32 sums run in another order; 2^-8 is that rounding
    with a factor 2 for the order. ``|x| @ p`` comes from the plain
    version."""
    p = torch.softmax(a.float(), dim=1)
    return 2.0 ** -8 * torch.bmm(x.float().abs(), p) / norm + 1e-6


def _dx_bars(a, g, m, l, dx32, norm):
    """The tensor-core dx's bar, element by element:

        |kernel - plain| <= 2^-7 (|g| @ p^T) / norm + ulp_bf16(|plain|).

    g and p are both rounded to bf16 (2^-9 each, a factor 2 for the order
    of the sums), and the result is returned in bf16 (one ulp)."""
    p = psa._probs(a, m, l)
    ulp = 2.0 ** (torch.floor(torch.log2(dx32.abs().clamp_min(1e-30))) - 7)
    return 2.0 ** -7 * torch.bmm(g.abs(), p.transpose(1, 2)) / norm + ulp


def _da_bars(x, a, g, m, l, da32, norm):
    """The tensor-core da's bar, element by element:

        |kernel - plain| <= p 2^-8 (|x|^T |g|) / norm + ulp_bf16(|plain|).

    da = p (dP - delta) with dP = x^T g / norm. x is bf16 already; the
    kernel rounds g to bf16 once (2^-9 relative per term), so dP moves by at
    most 2^-9 (|x|^T |g|) / norm; a factor 2 covers the order of the f32
    sums, and p (at most 1, recomputed in f32 from the same m and l, and
    delta, the same f32 tensor on both sides) scales it. The result is
    returned in bf16: one ulp of |plain|."""
    p = psa._probs(a, m, l)
    ulp = 2.0 ** (torch.floor(torch.log2(da32.abs().clamp_min(1e-30))) - 7)
    return p * 2.0 ** -8 * torch.bmm(x.float().abs().transpose(1, 2), g.abs()) / norm + ulp


@pytest.mark.parametrize("n,c,hw,dtype", [
    (1, 5, 1, torch.float32),        # a single position
    (2, 7, 37, torch.float32),       # ragged C and hw, several column tiles
    (1, 130, 97, torch.bfloat16),    # two channel tiles, ragged stages
    (3, 16, 200, torch.bfloat16),
    (8, 512, 2025, torch.bfloat16),  # Cityscapes PSANet (resident on the path)
    (1, 512, 7921, torch.bfloat16),  # shrink 1 (flash on the path)
])
def test_psa_kernels_match_plain(cuda, n, c, hw, dtype):
    """Both forward entry points, whatever the rule picks; both run the
    tensor-core forward of the dtype. f32 (3xTF32): max abs diff <= 1e-4 *
    max|plain| + 1e-5 (f32 sums over up to hw terms in another order). bf16:
    element by element within ``_fwd_bars``. m exact and l within 1e-5
    relative."""
    g = torch.Generator(device=cuda).manual_seed(hw)
    x = torch.randn(n, c, hw, generator=g, device=cuda).to(dtype)
    a = (torch.randn(n, hw, hw, generator=g, device=cuda) * 3).to(dtype)
    want = psa.psa_softmax_bmm_reference(x, a, 1.3)
    m_ref, l_ref = psa.psa_softmax_stats(a)
    bar = 1e-4 * want.abs().max().item() + 1e-5
    kernel = (psa.psa_softmax_bmm_wgmma if dtype == torch.bfloat16
              else psa.psa_softmax_bmm_tf32x3)
    counters = (psa.psa_softmax_bmm, psa.psa_softmax_bmm_wgmma, psa.psa_softmax_bmm_tf32x3,
                psa.psa_softmax_bmm_flash)
    before = {f: f.launches for f in counters}
    res = psa.psa_softmax_bmm(x, a, 1.3)
    out, m, l = psa.psa_softmax_bmm_flash(x, a, 1.3, return_stats=True)
    torch.cuda.synchronize()
    assert {f: f.launches - before[f] for f in counters} == {
        f: 2 if f is kernel else int(f in (psa.psa_softmax_bmm, psa.psa_softmax_bmm_flash))
        for f in counters}
    assert res.dtype == out.dtype == torch.float32 and res.shape == want.shape
    for got in (res, out):
        if dtype == torch.bfloat16:
            assert ((got - want).abs() <= _fwd_bars(x, a, 1.3)).all()
        else:
            assert (got - want).abs().max().item() <= bar
    assert torch.equal(m, m_ref)
    assert ((l - l_ref).abs() / l_ref).max().item() <= 1e-5


@pytest.mark.parametrize("n,c,hw", [
    (1, 130, 97),     # two channel tiles of 128, ragged stages
    (3, 16, 200),     # one M tile per warpgroup, four query tiles
    (8, 512, 49),     # the convergence license's 97x97 crops: less than one tile
    (8, 256, 2025),   # a TP rank's channels (model_parallel 2): two M tiles
    (8, 512, 2025),   # Cityscapes PSANet, served (4 launches an image)
    (16, 512, 2025),  # Cityscapes PSANet, trained at batch 16
])
def test_wgmma_kernels_match_plain(cuda, n, c, hw):
    """The tensor-core forward and dx on bf16 operands against the plain
    f32 versions: element by element within ``_fwd_bars`` and
    ``_dx_bars``, and within the JAX package's bf16 license (rtol = atol =
    1e-2, ``tests/test_psa_pallas.py``); m exact, l within 1e-5; two calls
    bit-identical; one launch each."""
    g0 = torch.Generator(device=cuda).manual_seed(hw + 2)
    x = torch.randn(n, c, hw, generator=g0, device=cuda).to(torch.bfloat16)
    a = (torch.randn(n, hw, hw, generator=g0, device=cuda) * 3).to(torch.bfloat16)
    g = torch.randn(n, c, hw, generator=g0, device=cuda)
    with torch.no_grad():
        before = (psa.psa_softmax_bmm_wgmma.launches, psa.psa_softmax_bmm_bwd_dx_wgmma.launches)
        out, m, l = psa.psa_softmax_bmm_wgmma(x, a, 1.3, return_stats=True)
        dx = psa.psa_softmax_bmm_bwd_dx_wgmma(x, a, g, m, l, 1.3)
        torch.cuda.synchronize()
        assert (psa.psa_softmax_bmm_wgmma.launches,
                psa.psa_softmax_bmm_bwd_dx_wgmma.launches) == (before[0] + 1, before[1] + 1)
        assert out.dtype == torch.float32 and dx.dtype == torch.bfloat16
        want = psa.psa_softmax_bmm_reference(x, a, 1.3)
        m_ref, l_ref = psa.psa_softmax_stats(a)
        assert torch.equal(m, m_ref) and ((l - l_ref).abs() / l_ref).max().item() <= 1e-5
        assert ((out - want).abs() <= _fwd_bars(x, a, 1.3)).all()
        torch.testing.assert_close(out, want, rtol=1e-2, atol=1e-2)
        dx32 = psa.psa_softmax_bmm_bwd_dx_reference(x.float(), a, g, m, l, 1.3)
        assert ((dx.float() - dx32).abs() <= _dx_bars(a, g, m, l, dx32, 1.3)).all()
        torch.testing.assert_close(dx.float(), dx32, rtol=1e-2, atol=1e-2)
        assert torch.equal(out, psa.psa_softmax_bmm_wgmma(x, a, 1.3))
        assert torch.equal(dx, psa.psa_softmax_bmm_bwd_dx_wgmma(x, a, g, m, l, 1.3))


@pytest.mark.parametrize("n,c,hw", [
    (1, 130, 97),     # three channel stages, one ragged; one ragged tile
    (3, 16, 200),     # one stage, two tiles each way
    (8, 512, 49),     # the convergence license's 97x97 crops: less than one tile
    (8, 256, 2025),   # a TP rank's channels (model_parallel 2)
    (8, 512, 2025),   # Cityscapes PSANet at batch 8
    (16, 512, 2025),  # Cityscapes PSANet, trained at batch 16
])
def test_wgmma_da_matches_plain(cuda, n, c, hw):
    """The tensor-core da on bf16 operands: element by element within
    ``_da_bars`` of the plain f32 da, within one bf16 ulp of max|plain|
    of its bf16 plain version (the same rounding of g, sums in another
    order); two calls bit-identical; one launch of it through one call of
    the entry point."""
    g0 = torch.Generator(device=cuda).manual_seed(hw + 5)
    x = torch.randn(n, c, hw, generator=g0, device=cuda).to(torch.bfloat16)
    a = (torch.randn(n, hw, hw, generator=g0, device=cuda) * 3).to(torch.bfloat16)
    g = torch.randn(n, c, hw, generator=g0, device=cuda)
    with torch.no_grad():
        out, m, l = psa.psa_softmax_bmm(x, a, 1.3, return_stats=True)
        before = (psa.psa_softmax_bmm_bwd_da_wgmma.launches, psa.psa_softmax_bmm_bwd_da.launches)
        da = psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out, 1.3)
        torch.cuda.synchronize()
        assert (psa.psa_softmax_bmm_bwd_da_wgmma.launches,
                psa.psa_softmax_bmm_bwd_da.launches) == (before[0] + 1, before[1] + 1)
        assert da.dtype == torch.bfloat16 and da.shape == a.shape
        da32 = psa.psa_softmax_bmm_bwd_da_reference(x.float(), a.float(), g, m, l, out, 1.3)
        assert ((da.float() - da32).abs() <= _da_bars(x, a, g, m, l, da32, 1.3)).all()
        da16 = psa.psa_softmax_bmm_bwd_da_bf16_reference(x, a, g, m, l, out, 1.3).float()
        mx = da16.abs().max().item()
        assert (da.float() - da16).abs().max().item() <= 2.0 ** (np.floor(np.log2(mx)) - 7)
        assert torch.equal(da, psa.psa_softmax_bmm_bwd_da_wgmma(x, a, g, m, l, out, 1.3))


def test_wgmma_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 9, device=cuda)
    a = torch.zeros(1, 9, 9, device=cuda)
    g = torch.zeros(1, 4, 9, device=cuda)
    m, l = torch.zeros(1, 9, device=cuda), torch.ones(1, 9, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        psa.psa_softmax_bmm_wgmma(x, a)  # f32 operands run the 3xTF32 kernels
    with pytest.raises(ValueError, match="bfloat16"):
        psa.psa_softmax_bmm_bwd_dx_wgmma(x, a, g, m, l)
    with pytest.raises(ValueError, match="bfloat16"):
        psa.psa_softmax_bmm_bwd_da_wgmma(x, a, g, m, l, g)
    xb, ab = x.to(torch.bfloat16), a.to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        psa.psa_softmax_bmm_wgmma(xb, ab.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        psa.psa_softmax_bmm_bwd_dx_wgmma(xb, ab, g.to(torch.bfloat16), m, l)
    with pytest.raises(ValueError, match="float32"):
        psa.psa_softmax_bmm_bwd_da_wgmma(xb, ab, g, m, l, g.to(torch.bfloat16))
    assert psa.psa_softmax_bmm_wgmma(xb, ab).shape == (1, 4, 9)
    assert psa.psa_softmax_bmm_bwd_dx_wgmma(xb, ab, g, m, l).dtype == torch.bfloat16
    assert psa.psa_softmax_bmm_bwd_da_wgmma(xb, ab, g, m, l, g).dtype == torch.bfloat16


@pytest.mark.parametrize("n,c,hw", [
    (2, 24, 100),    # one M tile per warpgroup (128 channels a block)
    (1, 130, 97),    # 256 channels a block, ragged stages
    (8, 512, 900),   # ADE20K PSANet: 512 channels a block
    (8, 512, 49),    # the convergence license's 97x97 crops: less than one tile
    (8, 256, 2025),  # a TP rank's channels (model_parallel 2)
    (8, 512, 2025),  # Cityscapes PSANet (an f32 train step at batch 8)
])
def test_tf32x3_kernels_match_plain(cuda, n, c, hw):
    """The 3xTF32 forward and dx on f32 operands against their plain
    versions (the same split, sums in another order) and the plain f32
    versions: within 1e-4 * max|plain| + 1e-5; element by element within
    the JAX package's f32 bars (forward rtol = atol = 1e-5, dx rtol 1e-4,
    atol 1e-5, ``tests/test_psa_pallas.py``) against the product in
    float64, since at hw 2025 the plain f32 versions' own rounding takes
    up to 0.64 of the forward's bar; m exact, l within 1e-5; two calls
    bit-identical; one launch each."""
    g0 = torch.Generator(device=cuda).manual_seed(hw + 11)
    x = torch.randn(n, c, hw, generator=g0, device=cuda)
    a = torch.randn(n, hw, hw, generator=g0, device=cuda) * 3
    g = torch.randn(n, c, hw, generator=g0, device=cuda)
    with torch.no_grad():
        before = (psa.psa_softmax_bmm_tf32x3.launches, psa.psa_softmax_bmm_bwd_dx_tf32x3.launches)
        out, m, l = psa.psa_softmax_bmm_tf32x3(x, a, 1.3, return_stats=True)
        dx = psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g, m, l, 1.3)
        torch.cuda.synchronize()
        assert (psa.psa_softmax_bmm_tf32x3.launches,
                psa.psa_softmax_bmm_bwd_dx_tf32x3.launches) == (before[0] + 1, before[1] + 1)
        assert out.dtype == dx.dtype == torch.float32
        m_ref, l_ref = psa.psa_softmax_stats(a)
        assert torch.equal(m, m_ref) and ((l - l_ref).abs() / l_ref).max().item() <= 1e-5
        for want in (psa.psa_softmax_bmm_reference(x, a, 1.3),
                     psa.psa_softmax_bmm_tf32x3_reference(x, a, 1.3)):
            assert (out - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
        for want in (psa.psa_softmax_bmm_bwd_dx_reference(x, a, g, m, l, 1.3),
                     psa.psa_softmax_bmm_bwd_dx_tf32x3_reference(x, a, g, m, l, 1.3)):
            assert (dx - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
        p64 = torch.softmax(a.double(), dim=1)
        torch.testing.assert_close(out.double(), torch.bmm(x.double(), p64) / 1.3,
                                   rtol=1e-5, atol=1e-5)
        p64 = torch.exp(a.double() - m.double()[:, None]) / l.double()[:, None]
        torch.testing.assert_close(dx.double(), torch.bmm(g.double(), p64.transpose(1, 2)) / 1.3,
                                   rtol=1e-4, atol=1e-5)
        assert torch.equal(out, psa.psa_softmax_bmm_tf32x3(x, a, 1.3))
        assert torch.equal(dx, psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g, m, l, 1.3))


def test_f32_entry_points_run_the_tf32x3_kernels(cuda):
    """float32 operands: the resident forward, dx and da entry points (and
    autograd through them, which calls them) launch the 3xTF32 kernels, once
    a call, never the bf16 ones."""
    g0 = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(2, 16, 70, generator=g0, device=cuda).requires_grad_()
    a = (torch.randn(2, 70, 70, generator=g0, device=cuda) * 3).requires_grad_()
    g = torch.randn(2, 16, 70, generator=g0, device=cuda)
    counters = (psa.psa_softmax_bmm_tf32x3, psa.psa_softmax_bmm_bwd_dx_tf32x3,
                psa.psa_softmax_bmm_bwd_da_tf32x3, psa.psa_softmax_bmm, psa.psa_softmax_bmm_bwd_da,
                psa.psa_softmax_bmm_bwd_dx, psa.psa_softmax_bmm_wgmma,
                psa.psa_softmax_bmm_bwd_dx_wgmma, psa.psa_softmax_bmm_bwd_da_wgmma)
    before = [f.launches for f in counters]
    torch.autograd.grad(psa.psa_softmax_bmm(x, a, 1.3), (x, a), g)
    with torch.no_grad():
        out, m, l = psa.psa_softmax_bmm(x, a, 1.3, return_stats=True)
        psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l, 1.3)
        psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out, 1.3)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 2, 2, 2, 2, 0, 0, 0]


def test_tf32x3_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 9, device=cuda)
    a = torch.zeros(1, 9, 9, device=cuda)
    g = torch.zeros(1, 4, 9, device=cuda)
    m, l = torch.zeros(1, 9, device=cuda), torch.ones(1, 9, device=cuda)
    xb, ab = x.to(torch.bfloat16), a.to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        psa.psa_softmax_bmm_tf32x3(xb, ab)  # bf16 operands run the bf16 tensor-core kernels
    with pytest.raises(ValueError, match="float32"):
        psa.psa_softmax_bmm_bwd_dx_tf32x3(xb, ab, g, m, l)
    with pytest.raises(ValueError, match="float32"):
        psa.psa_softmax_bmm_bwd_da_tf32x3(xb, ab, g, m, l, g)
    with pytest.raises(ValueError, match="contiguous"):
        psa.psa_softmax_bmm_bwd_da_tf32x3(x, a.transpose(1, 2), g, m, l, g)
    with pytest.raises(ValueError, match="float32"):
        psa.psa_softmax_bmm_bwd_da_tf32x3(x, a, g, m, l, g.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        psa.psa_softmax_bmm_tf32x3(x, a.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g.transpose(1, 2).contiguous().transpose(1, 2),
                                          m, l)
    with pytest.raises(ValueError, match="float32"):
        psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g.to(torch.bfloat16), m, l)
    assert psa.psa_softmax_bmm_tf32x3(x, a).shape == (1, 4, 9)
    assert psa.psa_softmax_bmm_bwd_dx_tf32x3(x, a, g, m, l).dtype == torch.float32
    assert psa.psa_softmax_bmm_bwd_da_tf32x3(x, a, g, m, l, g).dtype == torch.float32


def _da_f32_bars(x, a, g, m, l, out, norm):
    """``(want64, bar)``: the f32 da's float64 value and its bar, element
    by element:

        |kernel - want64| <= 1e-4 |want64| + 1e-5
                             + 2 p 2^-24 (|x|^T |g| / norm + sum_c |g out|).

    want64 = p (x^T g / norm - delta) in float64 (p from the same m and l,
    delta = sum_c g out from the same f32 forward output). The first two
    terms are the JAX package's f32 VJP bar (``tests/test_psa_pallas.py``).
    It sits at f32's own floor for da: where p is near 1 and dP ~ delta,
    |da| ~ 0 and the atol alone is left, while dP and delta are f32 sums of
    C terms, each rounding up to 2^-24 times the sum of the magnitudes; the
    plain f32 da takes up to 2.4 of that bar at (8, 512, 2025) on the card.
    The third term allows two such roundings of each sum, scaled by p. One
    TF32 pass (2^-11 per operand) fails it by far."""
    p64 = torch.exp(a.double() - m.double()[:, None]) / l.double()[:, None]
    d64 = (g.double() * out.double()).sum(1)
    want64 = p64 * (torch.bmm(x.double().transpose(1, 2), g.double()) / norm - d64[:, None])
    mag = (torch.bmm(x.double().abs().transpose(1, 2), g.double().abs()) / norm
           + (g.double() * out.double()).abs().sum(1)[:, None])
    return want64, 1e-4 * want64.abs() + 1e-5 + 2.0 * 2.0 ** -24 * p64 * mag


@pytest.mark.parametrize("n,c,hw", [
    (2, 16, 70),      # one channel stage, one ragged tile
    (1, 130, 97),     # five stages, the last ragged
    (3, 16, 200),     # two tiles each way
    (8, 512, 49),     # the convergence license's 97x97 crops: less than one tile
    (8, 256, 2025),   # a TP rank's channels (model_parallel 2)
    (8, 512, 2025),   # Cityscapes PSANet (an f32 train step at batch 8)
])
def test_f32_da_runs_the_tf32x3_kernel(cuda, n, c, hw):
    """float32 operands run da on the tensor cores as 3xTF32: its counter
    and the entry point's move, the bf16 one does not; within 1e-4 * max|plain| + 1e-5
    of the plain f32 da and of its own plain version; element by element
    within ``_da_f32_bars`` against float64, which a single TF32 pass
    (x and g rounded to TF32, f32 sums) fails; two calls bit-identical."""
    g0 = torch.Generator(device=cuda).manual_seed(hw + 9)
    x = torch.randn(n, c, hw, generator=g0, device=cuda)
    a = torch.randn(n, hw, hw, generator=g0, device=cuda) * 3
    g = torch.randn(n, c, hw, generator=g0, device=cuda)
    with torch.no_grad():
        out, m, l = psa.psa_softmax_bmm(x, a, 1.3, return_stats=True)
        counters = (psa.psa_softmax_bmm_bwd_da_tf32x3, psa.psa_softmax_bmm_bwd_da,
                    psa.psa_softmax_bmm_bwd_da_wgmma)
        before = [f.launches for f in counters]
        da = psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out, 1.3)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0]
        assert da.dtype == torch.float32 and da.shape == a.shape
        for want in (psa.psa_softmax_bmm_bwd_da_reference(x, a, g, m, l, out, 1.3),
                     psa.psa_softmax_bmm_bwd_da_tf32x3_reference(x, a, g, m, l, out, 1.3)):
            assert (da - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-5
        want64, bar = _da_f32_bars(x, a, g, m, l, out, 1.3)
        assert ((da.double() - want64).abs() <= bar).all()
        one_pass = psa.psa_softmax_bmm_bwd_da_reference(psa.tf32_split(x)[0], a,
                                                         psa.tf32_split(g)[0], m, l, out, 1.3)
        assert not ((one_pass.double() - want64).abs() <= bar).all()
        assert torch.equal(da, psa.psa_softmax_bmm_bwd_da_tf32x3(x, a, g, m, l, out, 1.3))


@pytest.mark.parametrize("n,c,hw", [
    (2, 7, 37),       # ragged C and hw
    (1, 512, 7921),   # shrink 1, the flash forward's path
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forward_routes_to_the_tensor_cores(cuda, n, c, hw, dtype):
    """The flash forward entry point on CUDA runs the tensor-core forward of
    the dtype: its own counter and that kernel's move once a call, the other
    kernel's not; out, m and l bit-identical to the resident entry point's,
    with and without the statistics, and under grad."""
    g0 = torch.Generator(device=cuda).manual_seed(hw + 3)
    x = torch.randn(n, c, hw, generator=g0, device=cuda).to(dtype)
    a = (torch.randn(n, hw, hw, generator=g0, device=cuda) * 3).to(dtype)
    bf16 = dtype == torch.bfloat16
    kernel, other = ((psa.psa_softmax_bmm_wgmma, psa.psa_softmax_bmm_tf32x3) if bf16
                     else (psa.psa_softmax_bmm_tf32x3, psa.psa_softmax_bmm_wgmma))
    with torch.no_grad():
        res, rm, rl = psa.psa_softmax_bmm(x, a, 1.3, return_stats=True)
        counters = (psa.psa_softmax_bmm_flash, kernel, other, psa.psa_softmax_bmm)
        before = [f.launches for f in counters]
        out, m, l = psa.psa_softmax_bmm_flash(x, a, 1.3, return_stats=True)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0]
        assert torch.equal(out, res) and torch.equal(m, rm) and torch.equal(l, rl)
        assert torch.equal(psa.psa_softmax_bmm_flash(x, a, 1.3), res)
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        assert torch.equal(psa.psa_softmax_bmm_flash(xr, a, 1.3).detach(), res)


class _ZoomStub(torch.nn.Module):
    """A bf16 model stub with a zoomed head (``tests/test_torch_evaluator.py``
    holds the same stub to JAX on the CPU)."""

    dtype = torch.bfloat16
    zoom_factor = 8

    def forward(self, x, zoom=True):
        from semseg_torch.ops.resize import resize_bilinear_align_corners_cf

        h, w = x.shape[-2], x.shape[-1]
        f = x[:, :, ::8, ::8].to(self.dtype)
        m = f.mean(dim=1, keepdim=True)
        logits = torch.cat([m, 0.5 - m, 0.25 * m + 0.1], dim=1)
        if zoom:
            logits = resize_bilinear_align_corners_cf(
                logits, ((h - 1) // 8 * 8 + 1, (w - 1) // 8 * 8 + 1))
        return logits


def test_multiscale_evaluator_on_cuda(cuda):
    """Two scales on CUDA with a bf16 stub: the fused stitch kernel once per
    chunk of each scale's grid (counted from ``_scaled_size`` and
    ``_grid_coords``), and ``predict_probs`` bit for bit the float32 mean of
    the single-scale evaluators' maps."""
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator, _grid_coords, _scaled_size

    kw = dict(classes=3, crop_h=33, crop_w=33, mean=[0.5, 0.5, 0.5], std=[1.0, 1.0, 1.0],
              base_size=97, flip=True, window_batch=4, device=cuda)
    image = (np.random.RandomState(4).rand(61, 97, 3) * 2.0).astype(np.float32)
    scales = [0.5, 1.25]
    ev = SlidingWindowEvaluator(_ZoomStub(), scales=scales, **kw)
    assert ev.fused_stitch
    chunks = 0
    for s in scales:
        nh, nw = _scaled_size(61, 97, s, 97)
        windows = len(_grid_coords(max(nh, 33), max(nw, 33), 33, 33, 2 / 3))
        chunks += -(-windows // 2)  # window_batch 4 under flip: 2 windows a chunk
    before = stitch.upsample_softmax_flip.launches
    probs = ev.predict_probs(image)
    torch.cuda.synchronize()
    assert stitch.upsample_softmax_flip.launches - before == chunks
    maps = [SlidingWindowEvaluator(_ZoomStub(), scales=[s], **kw).predict_probs(image)
            for s in scales]
    np.testing.assert_array_equal(probs, (maps[0] + maps[1]) / np.float32(2))
    np.testing.assert_array_equal(ev.predict(image), (maps[0] + maps[1]).argmax(-1))


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
        out = fn(x.requires_grad_(), a)  # under grad: the autograd Function
        assert out.grad_fn is not None
        with pytest.raises(ValueError, match="forward-only"):
            fn(x, a, return_stats=True)
        x = x.detach()
        with torch.no_grad():
            assert fn(x.requires_grad_(), a).grad_fn is None  # no graph is recorded
        x = x.detach()


def test_psanet_slice_on_cuda(cuda):
    """A small bf16 PSANet50 through build_evaluator: per chunk the stitch
    kernel once and the tensor-core resident forward twice (two
    directions, two calls of the entry point), the flash route never; the
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
    counters = (stitch.upsample_softmax_flip, psa.psa_softmax_bmm_wgmma, psa.psa_softmax_bmm,
                psa.psa_softmax_bmm_flash)
    before = [f.launches for f in counters]
    fused = ev.predict_probs(image)
    n_chunks = len(ev._geometry(128, 256, 1.0).chunks)
    assert [f.launches - b for f, b in zip(counters, before)] == [
        n_chunks, 2 * n_chunks, 2 * n_chunks, 0]
    ev.model.psa.fused_attention = False
    plain = ev.predict_probs(image)
    assert fused.shape == (128, 256, 19)
    assert np.abs(fused - plain).max() <= 2e-2
    assert (fused.argmax(-1) == plain.argmax(-1)).mean() >= 0.995


def test_partitions_launch_on_every_entry(cuda):
    """A small PSANet50 over two entries of the card. bf16 ``window``: the
    stitch kernel and the two-direction PSA forward run on each entry's
    pairs (two stitch and four PSA launches a chunk of four pairs), bit for
    bit the single-device evaluator that runs the same forward batch
    (``window_batch`` 4, two pairs with their flips). bf16 ``spatial``: the
    stitch once a chunk on the primary on the gathered logits and the PSA
    module whole there (its bf16 forward twice a chunk), held to the
    half-batch and f32 witnesses of ``chip_smoke.py::bf16_spatial_gate``
    (a bf16 convolution rounds by the summation order cuDNN picks for the
    shape). f32 ``spatial``: the 3xTF32 forward twice a chunk, within 1e-4
    of one device, argmax agreement >= 0.999. With a second card the bf16
    window partition runs on ``cuda:0`` and ``cuda:1``."""
    from types import SimpleNamespace

    from chip_smoke import bf16_spatial_gate
    from semseg_torch.serve import build_evaluator
    from semseg_torch.utils.misc import get_logger

    cfg = SimpleNamespace(arch="psa", layers=50, classes=19, zoom_factor=8,
                          train_h=97, train_w=97, test_h=97, test_w=97,
                          base_size=256, scales=[1.0], model_path="",
                          allow_random_weights=True, window_batch=8,
                          eval_pipeline="device", psa_type=2, compact=0,
                          shrink_factor=2, normalization_factor=1.0, psa_softmax=1)
    image = (np.random.RandomState(0).rand(128, 256, 3) * 255).astype(np.uint8)
    counters = (stitch.upsample_softmax_flip, psa.psa_softmax_bmm_wgmma,
                psa.psa_softmax_bmm_tf32x3)
    bf16 = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=cuda)
    f32 = build_evaluator(cfg, get_logger(), dtype=torch.float32, device=cuda)
    geometry = bf16._geometry(128, 256, 1.0)
    assert geometry.n_real == [4, 4]
    layouts = [(bf16, ["cuda:0", "cuda:0"], "window", (4, 8, 0)),
               (bf16, ["cuda:0", "cuda:0"], "spatial", (2, 4, 0)),
               (f32, ["cuda:0", "cuda:0"], "spatial", (0, 0, 4))]
    if torch.cuda.device_count() > 1:
        layouts.append((bf16, ["cuda:0", "cuda:1"], "window", (4, 8, 0)))
    half = bf16.with_options(window_batch=4).predict_probs(image)
    for single, devices, partition, want_counts in layouts:
        ev = single.with_options(devices=devices, partition=partition)
        assert ev.fused_stitch == (single is bf16)
        before = [f.launches for f in counters]
        got = ev.predict_probs(image)
        torch.cuda.synchronize()
        assert tuple(f.launches - b for f, b in zip(counters, before)) == want_counts, (
            devices, partition)
        if partition == "window":
            np.testing.assert_array_equal(got, half)
        elif single is bf16:
            bf16_spatial_gate(got, bf16.predict_probs(image), half, f32.predict_probs(image))
        else:
            want = single.predict_probs(image)
            assert np.abs(got - want).max() <= 1e-4
            assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def _bwd_bars(dtype, dx_plain, da_plain):
    """f32: 1e-4 * max|plain| + 1e-5 (sums over C or hw terms in another
    order). bf16: one bf16 ulp of max|plain| against the plain grads
    rounded to bf16, plus 1e-6 for the all-but-zero da of hw 1."""
    def bar(t):
        mx = t.abs().max().item()
        if dtype == torch.float32:
            return 1e-4 * mx + 1e-5
        return (2.0 ** (np.floor(np.log2(mx)) - 7) if mx > 0 else 0.0) + 1e-6
    return bar(dx_plain), bar(da_plain)


@pytest.mark.parametrize("n,c,hw", [
    (1, 5, 1), (2, 7, 37), (1, 130, 97), (3, 16, 200),
    (8, 512, 2025),  # Cityscapes PSANet (resident backward on the path)
    (1, 512, 7921),  # shrink 1 (flash backward on the path)
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_psa_backward_kernels_match_plain(cuda, n, c, hw, dtype):
    """da, dx and the flash backward against the plain backward (f32
    reference on the same operand values; bf16 grads against it rounded to
    bf16, but bf16 da and dx, which run on the tensor cores, against the f32
    ones within ``_da_bars`` and ``_dx_bars``), from the kernels' own
    forward statistics; grads in the primal dtypes; two calls
    bit-identical. The flash backward's route is the same tensor-core dx
    and da from the flash forward's statistics: their counters move twice
    (resident and route), the route's once, and the resident entry points'
    once each."""
    g0 = torch.Generator(device=cuda).manual_seed(hw + 1)
    x = torch.randn(n, c, hw, generator=g0, device=cuda).to(dtype)
    a = (torch.randn(n, hw, hw, generator=g0, device=cuda) * 3).to(dtype)
    g = torch.randn(n, c, hw, generator=g0, device=cuda)
    with torch.no_grad():
        out, m, l = psa.psa_softmax_bmm(x, a, 1.3, return_stats=True)
        fout, fm, fl = psa.psa_softmax_bmm_flash(x, a, 1.3, return_stats=True)
        m_ref, l_ref = psa.psa_softmax_stats(a)
        assert torch.equal(m, m_ref) and ((l - l_ref).abs() / l_ref).max().item() <= 1e-5
        dx32, da32 = psa.psa_softmax_bmm_bwd_reference(x.float(), a.float(), g, m_ref, l_ref,
                                                       fout, 1.3)
        bf16 = dtype == torch.bfloat16
        dx_counter = (psa.psa_softmax_bmm_bwd_dx_wgmma if bf16
                      else psa.psa_softmax_bmm_bwd_dx_tf32x3)
        da_counter = (psa.psa_softmax_bmm_bwd_da_wgmma if bf16
                      else psa.psa_softmax_bmm_bwd_da_tf32x3)
        counters = (da_counter, dx_counter, psa.psa_softmax_bmm_flash_bwd,
                    psa.psa_softmax_bmm_bwd_da, psa.psa_softmax_bmm_bwd_dx)
        before = tuple(f.launches for f in counters)
        da = psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out, 1.3)
        dx = psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l, 1.3)
        fdx, fda = psa.psa_softmax_bmm_flash_bwd(x, a, g, fm, fl, fout, 1.3)
        torch.cuda.synchronize()
        assert tuple(f.launches - b for f, b in zip(counters, before)) == (2, 2, 1, 1, 1)
        assert da.dtype == fda.dtype == dx.dtype == fdx.dtype == dtype
        want_dx, want_da = (dx32, da32) if dtype == torch.float32 else (
            dx32.to(dtype).float(), da32.to(dtype).float())
        bar_dx, bar_da = _bwd_bars(dtype, dx32, da32)
        if bf16:
            assert ((dx.float() - dx32).abs() <= _dx_bars(a, g, m, l, dx32, 1.3)).all()
            assert ((fdx.float() - dx32).abs() <= _dx_bars(a, g, fm, fl, dx32, 1.3)).all()
            # the bar holds da to the plain da from the same forward output
            rda = psa.psa_softmax_bmm_bwd_da_reference(x.float(), a.float(), g, m, l, out, 1.3)
            assert ((da.float() - rda).abs() <= _da_bars(x, a, g, m, l, rda, 1.3)).all()
            assert ((fda.float() - da32).abs() <= _da_bars(x, a, g, fm, fl, da32, 1.3)).all()
        else:
            for gdx, gda in ((dx, da), (fdx, fda)):
                assert (gdx.float() - want_dx).abs().max().item() <= bar_dx
                assert (gda.float() - want_da).abs().max().item() <= bar_da
        assert torch.equal(da, psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out, 1.3))
        assert torch.equal(dx, psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l, 1.3))
        again = psa.psa_softmax_bmm_flash_bwd(x, a, g, fm, fl, fout, 1.3)
        assert torch.equal(fdx, again[0]) and torch.equal(fda, again[1])


@pytest.mark.parametrize("entry", ["psa_softmax_bmm", "psa_softmax_bmm_flash"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_psa_autograd_on_cuda(cuda, entry, dtype):
    """Autograd through the kernels: both paths launch the tensor-core da
    and dx of the dtype once each (the resident path through the da entry
    point, which counts once; the flash path from the flash forward's
    statistics, through the route, which counts once); gradients in the
    primal dtypes. f32: within the f32 bars of autograd of
    the plain forward. bf16: within ``_da_bars`` and ``_dx_bars`` of the
    plain backward from the kernels' own forward output and statistics."""
    fn = getattr(psa, entry)
    bf16 = dtype == torch.bfloat16
    g0 = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 64, 150, generator=g0, device=cuda).to(dtype).requires_grad_()
    a = (torch.randn(2, 150, 150, generator=g0, device=cuda) * 3).to(dtype).requires_grad_()
    g = torch.randn(2, 64, 150, generator=g0, device=cuda)
    kind = "wgmma" if bf16 else "tf32x3"
    counters = (getattr(psa, f"psa_softmax_bmm_bwd_da_{kind}"),
                getattr(psa, f"psa_softmax_bmm_bwd_dx_{kind}"),
                psa.psa_softmax_bmm_bwd_da, psa.psa_softmax_bmm_flash_bwd)
    before = [f.launches for f in counters]
    dx, da = torch.autograd.grad(fn(x, a, 2.0), (x, a), g)
    route = int(entry == "psa_softmax_bmm_flash")
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1 - route, route]
    assert dx.dtype == da.dtype == dtype
    with torch.no_grad():
        if bf16:
            x, a = x.detach(), a.detach()
            out, m, l = fn(x, a, 2.0, return_stats=True)
            dx32, da32 = psa.psa_softmax_bmm_bwd_reference(x.float(), a.float(), g, m, l, out,
                                                           2.0)
            assert ((dx.float() - dx32).abs() <= _dx_bars(a, g, m, l, dx32, 2.0)).all()
            assert ((da.float() - da32).abs() <= _da_bars(x, a, g, m, l, da32, 2.0)).all()
            return
    rdx, rda = torch.autograd.grad(psa.psa_softmax_bmm_reference(x, a, 2.0), (x, a), g)
    bar_dx, bar_da = _bwd_bars(torch.float32, rdx, rda)
    assert (dx - rdx).abs().max().item() <= bar_dx
    assert (da - rda).abs().max().item() <= bar_da


def test_psa_backward_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 9, device=cuda)
    a = torch.zeros(1, 9, 9, device=cuda)
    g = torch.zeros(1, 4, 9, device=cuda)
    m, l = torch.zeros(1, 9, device=cuda), torch.ones(1, 9, device=cuda)
    calls = (lambda *t: psa.psa_softmax_bmm_bwd_da(*t, t[2]),
             lambda *t: psa.psa_softmax_bmm_bwd_dx(*t),
             lambda *t: psa.psa_softmax_bmm_flash_bwd(*t, t[2]))
    for call in calls:
        call(x, a, g, m, l)  # takes these
        with pytest.raises(ValueError, match="float32"):
            call(x, a, g.to(torch.bfloat16), m, l)  # g must be f32
        with pytest.raises(ValueError, match="float32"):
            call(x, a, g, m[:, :8], l)
        with pytest.raises(ValueError, match="contiguous"):
            call(x, a, g, torch.zeros(1, 18, device=cuda)[:, ::2], l)
        with pytest.raises(ValueError, match="both"):
            call(x, a.to(torch.bfloat16), g, m, l)
        with pytest.raises(ValueError, match="CUDA"):
            call(x, a.cpu(), g, m, l)


def test_entry_points_default_to_cuda(cuda):
    """With no device, build_model, build_evaluator, make_server and
    SlidingWindowEvaluator run on the current CUDA device."""
    from types import SimpleNamespace

    from semseg_torch.engine.evaluator import SlidingWindowEvaluator
    from semseg_torch.models.build import build_model
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD, build_evaluator, make_server
    from semseg_torch.utils.misc import get_logger

    cfg = SimpleNamespace(arch="psp", layers=50, classes=4, zoom_factor=8, train_h=25,
                          train_w=25, test_h=25, test_w=25, base_size=40, scales=[1.0],
                          model_path="", allow_random_weights=True, window_batch=4,
                          eval_pipeline="device")
    here = torch.device("cuda", torch.cuda.current_device())
    model = build_model(cfg)
    assert next(model.parameters()).device == here
    ev = SlidingWindowEvaluator(model, classes=4, crop_h=25, crop_w=25, mean=IMAGENET_MEAN,
                                std=IMAGENET_STD, base_size=40, scales=[1.0])
    assert ev.device == here
    assert ev.predict(np.zeros((30, 40, 3), np.uint8)).shape == (30, 40)
    assert build_evaluator(cfg, get_logger()).device == here
    server = make_server(cfg, port=0)
    server.server_close()


def test_psanet_train_step_on_cuda(cuda):
    """One bf16 PSANet50 train step at 97x97 crops through the Trainer:
    per step the tensor-core forward, da and dx twice each (two
    directions, through two calls of each resident entry point), no flash
    and no stitch kernel; finite losses; every parameter moved."""
    from types import SimpleNamespace

    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model

    cfg = SimpleNamespace(arch="psa", layers=50, classes=19, zoom_factor=8, train_h=97,
                          train_w=97, psa_type=2, compact=0, shrink_factor=2,
                          normalization_factor=1.0, psa_softmax=1)
    model = build_model(cfg, dtype=torch.bfloat16, device=cuda, train=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    tr = Trainer(model, make_sgd(model, 0.01), classes=19, ignore_label=255,
                 aux_weight=0.4, base_lr=0.01, max_iter=10, power=0.9, zoom_factor=8,
                 normalize=([123.675, 116.28, 103.53], [58.395, 57.12, 57.375]))
    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.randint(0, 256, (2, 97, 97, 3)).astype(np.uint8))
    labels = torch.from_numpy(rs.randint(0, 19, (2, 97, 97)).astype(np.uint8))
    counters = {"fwd": psa.psa_softmax_bmm_wgmma, "da": psa.psa_softmax_bmm_bwd_da_wgmma,
                "dx": psa.psa_softmax_bmm_bwd_dx_wgmma, "entry_fwd": psa.psa_softmax_bmm,
                "entry_da": psa.psa_softmax_bmm_bwd_da, "entry_dx": psa.psa_softmax_bmm_bwd_dx,
                "flash": psa.psa_softmax_bmm_flash, "flash_bwd": psa.psa_softmax_bmm_flash_bwd,
                "stitch": stitch.upsample_softmax_flip}
    start = {k: f.launches for k, f in counters.items()}
    metrics = tr.step(images, labels)
    torch.cuda.synchronize()
    got = {k: f.launches - start[k] for k, f in counters.items()}
    assert got == {"fwd": 2, "da": 2, "dx": 2, "entry_fwd": 2, "entry_da": 2, "entry_dx": 2,
                   "flash": 0, "flash_bwd": 0, "stitch": 0}
    assert np.isfinite(metrics["loss"].item()) and metrics["union"].sum().item() > 0
    for k, v in model.named_parameters():
        assert v.grad is not None and not torch.equal(v.detach(), before[k]), k


def _psanet_trainer(cuda, seed=0):
    """A bf16 PSANet50 Trainer at 97x97 crops on the card, and a batch."""
    from types import SimpleNamespace

    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model

    cfg = SimpleNamespace(arch="psa", layers=50, classes=19, zoom_factor=8, train_h=97,
                          train_w=97, psa_type=2, compact=0, shrink_factor=2,
                          normalization_factor=1.0, psa_softmax=1)
    model = build_model(cfg, dtype=torch.bfloat16, device=cuda, seed=seed, train=True)
    tr = Trainer(model, make_sgd(model, 0.01), classes=19, ignore_label=255,
                 aux_weight=0.4, base_lr=0.01, max_iter=10, power=0.9, zoom_factor=8,
                 normalize=([123.675, 116.28, 103.53], [58.395, 57.12, 57.375]))
    rs = np.random.RandomState(seed)
    images = torch.from_numpy(rs.randint(0, 256, (2, 97, 97, 3)).astype(np.uint8))
    labels = torch.from_numpy(rs.randint(0, 19, (2, 97, 97)).astype(np.uint8))
    return tr, images, labels


def test_checkpoint_of_cuda_tensors_round_trips(cuda, tmp_path):
    """A checkpoint saved from a trainer on the card (weights, BN
    statistics, momentum, step) loads with ``map_location="cpu"`` and
    back into a trainer on the card, bit for bit; the next step then
    matches the original's loss exactly."""
    from semseg_torch.engine import checkpoint as ckpt

    tr, images, labels = _psanet_trainer(cuda)
    tr.step(images, labels)
    path = ckpt.save_checkpoint(str(tmp_path), 1, tr.state_dict())
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for k, v in tr.model.state_dict().items():
        assert payload["state_dict"][k].device.type == "cpu"
        assert torch.equal(payload["state_dict"][k], v.cpu()), k
    other, _, _ = _psanet_trainer(cuda, seed=1)
    other.load_state_dict(payload)
    assert other.step_count == 1
    for k, v in tr.model.state_dict().items():
        assert other.model.state_dict()[k].device == v.device and torch.equal(
            other.model.state_dict()[k], v), k
    ours, theirs = tr.optimizer.state_dict()["state"], other.optimizer.state_dict()["state"]
    for k in ours:
        assert torch.equal(theirs[k]["momentum_buffer"], ours[k]["momentum_buffer"]), k
    assert tr.step(images, labels)["loss"].item() == other.step(images, labels)["loss"].item()


def test_async_save_holds_the_snapshotted_step(cuda, tmp_path):
    """An async save taken before the next step runs on the card holds the
    state of the step it snapshotted, not of the step after it."""
    from semseg_torch.engine import checkpoint as ckpt

    tr, images, labels = _psanet_trainer(cuda)
    tr.step(images, labels)
    want = ckpt.host_snapshot(tr.state_dict())
    path = ckpt.save_checkpoint_async(str(tmp_path), 1, tr.state_dict())
    tr.step(images, labels)  # runs while the write is in flight
    torch.cuda.synchronize()
    ckpt.wait_pending()
    got = ckpt.load_checkpoint(path)
    assert got["step"] == 1 and tr.step_count == 2
    moved = 0
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
        moved += not torch.equal(tr.model.state_dict()[k].cpu(), v)
    assert moved > 0


@pytest.mark.parametrize("dtype,per_step", [
    ("float32", {"psa_softmax_bmm_tf32x3": 2, "psa_softmax_bmm_bwd_da_tf32x3": 2,
                 "psa_softmax_bmm_bwd_dx_tf32x3": 2}),
    ("bfloat16", {"psa_softmax_bmm_wgmma": 2, "psa_softmax_bmm_bwd_da_wgmma": 2,
                  "psa_softmax_bmm_bwd_dx_wgmma": 2})])
def test_ddp_step_on_the_card_matches_one_process(cuda, dtype, per_step):
    """One PSANet50 train step at 97x97 crops, global batch 4, as 2 DDP
    ranks sharing the card over gloo against the one-process
    ``Trainer(num_replicas=2)`` (``semseg_torch.parallel.parity``): the
    reduced losses equal on both ranks and within 1e-5 (f32) or 1e-2
    (bf16) relative of one process; each rank launches the tensor-core
    forward, da and dx of the dtype twice and nothing else; the state
    after the step within 3 times (max and median over the entries) the
    distance of two one-process runs whose images differ by one ulp of
    the model's dtype (float32: ``np.nextafter``; bfloat16: a factor 1 +
    2^-7, which its cast keeps)."""
    import dataclasses
    from types import SimpleNamespace

    from semseg_torch.ops import launch_counters
    from semseg_torch.parallel import parity

    cfg = SimpleNamespace(arch="psa", layers=50, classes=19, zoom_factor=8, train_h=97,
                          train_w=97, psa_type=2, compact=0, shrink_factor=2,
                          normalization_factor=1.0, psa_softmax=1)
    rs = np.random.RandomState(3)
    images = rs.randn(4, 97, 97, 3).astype(np.float32)
    labels = rs.randint(0, 19, (4, 97, 97))
    spec = parity.StepSpec(cfg=cfg, batches=[(images, labels)], dtype=dtype, base_lr=0.01,
                           device="cuda")
    ref = parity.one_process_steps(spec, 2)
    ranks = parity.ddp_steps(spec, 2, timeout_s=300)
    want = {k: per_step.get(k, 0) for k in launch_counters() if k.endswith(("_wgmma", "_tf32x3"))}
    for r in ranks:
        assert {k: r["launches"][0][k] for k in want} == want
        assert r["losses"] == ranks[0]["losses"]
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(ranks[0]["losses"][0], ref["losses"][0], rtol=rtol)
    moved = (np.nextafter(images, np.float32(np.inf)) if dtype == "float32"
             else images * np.float32(1 + 2 ** -7))
    floor = parity.one_process_steps(dataclasses.replace(spec, batches=[(moved, labels)]), 2)
    d_ddp = parity.relative_distances(ranks[0]["state"], ref["state"], ref["init"])
    d_floor = parity.relative_distances(floor["state"], ref["state"], ref["init"])
    assert max(d_ddp.values()) <= 3 * max(d_floor.values())
    assert np.median(list(d_ddp.values())) <= 3 * np.median(list(d_floor.values()))


def test_tp_step_on_the_card_matches_one_process(cuda):
    """One f32 PSANet50 train step at 97x97 crops, global batch 2, as 1 x 2
    (data x model) ranks sharing the card over gloo, the head split by
    output channel (``semseg_torch.parallel.tensor``), against the
    one-process ``Trainer(num_replicas=1)``: the losses bit-identical on
    both ranks and within 1e-5 relative of one process; each rank launches
    the 3xTF32 forward, da and dx twice, on its 256 channels of ``reduce``,
    and nothing else; the gathered state within 3 times (max and median
    over the entries) the distance of two one-process runs whose images
    differ by one float32 ulp."""
    import dataclasses
    from types import SimpleNamespace

    from semseg_torch.ops import launch_counters
    from semseg_torch.parallel import parity

    cfg = SimpleNamespace(arch="psa", layers=50, classes=19, zoom_factor=8, train_h=97,
                          train_w=97, psa_type=2, compact=0, shrink_factor=2,
                          normalization_factor=1.0, psa_softmax=1)
    rs = np.random.RandomState(4)
    images = rs.randn(2, 97, 97, 3).astype(np.float32)
    labels = rs.randint(0, 19, (2, 97, 97))
    spec = parity.StepSpec(cfg=cfg, batches=[(images, labels)], base_lr=0.01, device="cuda")
    ref = parity.one_process_steps(spec, 1)
    ranks = parity.tp_steps(spec, 2, 2, timeout_s=300)
    per_step = {"psa_softmax_bmm_tf32x3": 2, "psa_softmax_bmm_bwd_da_tf32x3": 2,
                "psa_softmax_bmm_bwd_dx_tf32x3": 2}
    want = {k: per_step.get(k, 0) for k in launch_counters() if k.endswith(("_wgmma", "_tf32x3"))}
    for r in ranks:
        assert {k: r["launches"][0][k] for k in want} == want
        assert r["losses"] == ranks[0]["losses"]
        assert r["shard_rows"]["psa.reduce.0.weight"] == 256
    np.testing.assert_allclose(ranks[0]["losses"][0], ref["losses"][0], rtol=1e-5)
    moved = np.nextafter(images, np.float32(np.inf))
    floor = parity.one_process_steps(dataclasses.replace(spec, batches=[(moved, labels)]), 1)
    d_tp = parity.relative_distances(ranks[0]["state"], ref["state"], ref["init"])
    d_floor = parity.relative_distances(floor["state"], ref["state"], ref["init"])
    assert max(d_tp.values()) <= 3 * max(d_floor.values())
    assert np.median(list(d_tp.values())) <= 3 * np.median(list(d_floor.values()))


# Run by test_cuda_export_keeps_the_psa_kernel in a fresh interpreter: TF32
# on (cuDNN's default) until the artifact's contract turns it off.
_LOAD_SCRIPT = """
import sys
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
from semseg_torch.engine.export import load_serving
path, inputs, outputs = sys.argv[1:4]
serve = load_serving(path)
from semseg_torch.ops import psa
counts, results = [], {}
for key, x in np.load(inputs).items():
    before = psa.psa_softmax_bmm_tf32x3.launches
    with torch.no_grad():
        results[key] = serve(torch.from_numpy(x).cuda()).cpu().numpy()
    counts.append(psa.psa_softmax_bmm_tf32x3.launches - before)
np.savez(outputs, **results)
print("RESULT", counts, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
"""


def test_cuda_export_keeps_the_psa_kernel(cuda, tmp_path):
    """A CUDA-targeted PSANet50 crop export (33x33, float32) holds the
    operator ``semseg::psa_softmax_bmm``. A fresh process reloads it: every
    call launches the 3xTF32 forward exactly twice (two directions), TF32 is
    off there afterwards, and the probabilities at batch 1 and 3 are within
    1e-6 of the in-framework module's."""
    import os
    import subprocess
    import sys

    from semseg_torch.engine.export import (
        export_serving,
        make_serving_fn,
        save_serving,
        semseg_ops,
    )
    from semseg_torch.models.layers import set_precision
    from semseg_torch.models.psanet import PSANet
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    set_precision(torch.float32)
    model = PSANet(layers=50, classes=4, zoom_factor=8, mask_h=5, mask_w=5)
    model.init_weights(torch.Generator().manual_seed(1))
    model = model.to(cuda).eval()
    before = psa.psa_softmax_bmm_tf32x3.launches
    exported = export_serving(model, crop_h=33, crop_w=33, mean=IMAGENET_MEAN,
                              std=IMAGENET_STD, platforms=["cuda"])
    # one eager call at batch 1 before the trace; the trace launches nothing
    assert psa.psa_softmax_bmm_tf32x3.launches == before + 2
    assert semseg_ops(exported) == ["semseg::psa_softmax_bmm"]
    path = str(tmp_path / "psa.pt2")
    save_serving(path, exported)
    rs = np.random.RandomState(0)
    inputs = {f"b{b}": (rs.rand(b, 33, 33, 3) * 255).astype(np.float32) for b in (1, 3)}
    np.savez(tmp_path / "in.npz", **inputs)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_SCRIPT, path, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True, cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT [2, 2] False False" in proc.stdout
    direct = make_serving_fn(model, mean=IMAGENET_MEAN, std=IMAGENET_STD)
    got = np.load(tmp_path / "out.npz")
    for key, x in inputs.items():
        with torch.no_grad():
            want = direct(torch.from_numpy(x).to(cuda)).cpu().numpy()
        np.testing.assert_allclose(got[key], want, rtol=1e-6, atol=1e-6)


def test_portable_export_moves_to_the_card(cuda, tmp_path):
    """A portable PSPNet50 crop artifact traced on the CPU, loaded onto the
    card (``move_to_device_pass``), equals the in-framework module on the
    card within 1e-6 and launches no kernel of the port."""
    from semseg_torch.engine.export import (
        export_serving,
        load_serving,
        make_serving_fn,
        save_serving,
    )
    from semseg_torch.models.layers import set_precision
    from semseg_torch.models.pspnet import PSPNet
    from semseg_torch.ops import launch_counters
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD

    set_precision(torch.float32)
    model = PSPNet(layers=50, classes=4, zoom_factor=8)
    model.init_weights(torch.Generator().manual_seed(2))
    path = str(tmp_path / "psp.pt2")
    save_serving(path, export_serving(model.eval(), crop_h=25, crop_w=25, mean=IMAGENET_MEAN,
                                      std=IMAGENET_STD, platforms=["cpu", "cuda"]))
    serve = load_serving(path, device=cuda)
    x = torch.from_numpy((np.random.RandomState(1).rand(3, 25, 25, 3) * 255).astype(np.float32))
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    got = serve(x.to(cuda))
    assert {k: fn.launches for k, fn in launch_counters().items()} == counts
    with torch.no_grad():
        want = make_serving_fn(model.to(cuda), mean=IMAGENET_MEAN, std=IMAGENET_STD)(x.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "tf32x3"), (torch.bfloat16, "wgmma")])
def test_remat_step_on_the_card_equals_no_remat(cuda, dtype, kind):
    """PSANet50 at 321x321 crops, batch 4, 2 Trainer steps from the same
    seed-0 weights and batch with and without ``remat`` (each residual
    block of layer1..layer4 recomputed in the backward pass),
    ``cudnn.deterministic`` on: the losses, every parameter, momentum buffer
    and running statistic equal bit for bit, ``num_batches_tracked`` 2 in
    both; each step launches the PSA forward, da and dx of the dtype twice
    and nothing else of the PSA family. The memory the forward leaves for
    the backward (allocated when the model returns) is lower with
    ``remat``, and so is the bf16 step's peak. The f32 step's peak at this
    size is not the activations': it measured 5.404 GB with ``remat`` and
    5.403 GB without on an H100 80GB HBM3 (700 W), a spike both arms share
    under the deterministic cuDNN algorithms."""
    from types import SimpleNamespace

    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer
    from semseg_torch.models.build import build_model

    rs = np.random.RandomState(5)
    images = torch.from_numpy(rs.randint(0, 256, (4, 321, 321, 3)).astype(np.uint8)).to(cuda)
    labels = torch.from_numpy(rs.randint(0, 19, (4, 321, 321)).astype(np.uint8)).to(cuda)
    counters = {"fwd": getattr(psa, f"psa_softmax_bmm_{kind}"),
                "da": getattr(psa, f"psa_softmax_bmm_bwd_da_{kind}"),
                "dx": getattr(psa, f"psa_softmax_bmm_bwd_dx_{kind}"),
                "flash": psa.psa_softmax_bmm_flash, "flash_bwd": psa.psa_softmax_bmm_flash_bwd}
    arms = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            cfg = SimpleNamespace(arch="psa", layers=50, classes=19, zoom_factor=8,
                                  train_h=321, train_w=321, psa_type=2, compact=0,
                                  shrink_factor=2, normalization_factor=1.0, psa_softmax=1,
                                  remat=remat)
            model = build_model(cfg, dtype=dtype, device=cuda, seed=0, train=True)
            held = []
            model.register_forward_hook(
                lambda *_: held.append(torch.cuda.memory_allocated(cuda)))
            tr = Trainer(model, make_sgd(model, 0.01), classes=19, ignore_label=255,
                         aux_weight=0.4, base_lr=0.01, max_iter=10, power=0.9, zoom_factor=8,
                         normalize=([123.675, 116.28, 103.53], [58.395, 57.12, 57.375]))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(cuda)
            losses = []
            for _ in range(2):
                start = {k: f.launches for k, f in counters.items()}
                losses.append(tr.step(images, labels)["loss"])
                torch.cuda.synchronize()
                got = {k: f.launches - start[k] for k, f in counters.items()}
                assert got == {"fwd": 2, "da": 2, "dx": 2, "flash": 0, "flash_bwd": 0}, got
            # On the host: the next arm's peak holds none of this arm's tensors.
            arms[remat] = (torch.stack(losses).cpu(),
                           {k: v.cpu() for k, v in model.state_dict().items()},
                           [s["momentum_buffer"].cpu()
                            for s in tr.optimizer.state_dict()["state"].values()],
                           torch.cuda.max_memory_allocated(cuda), max(held))
            del tr, model
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l0, s0, m0, peak0, held0), (l1, s1, m1, peak1, held1) = arms[False], arms[True]
    assert torch.isfinite(l0).all() and torch.equal(l1, l0)
    assert list(s1) == list(s0)
    for k, v in s0.items():
        assert torch.equal(s1[k], v), k
        if k.endswith("num_batches_tracked"):
            assert int(v) == 2 and int(s1[k]) == 2, k
    assert len(m1) == len(m0) and all(torch.equal(a, b) for a, b in zip(m1, m0))
    assert held1 < held0, (held1, held0)
    assert peak1 < peak0 or dtype == torch.float32, (peak1, peak0)


def test_f32_train_run_on_the_card_repeats_itself(cuda, tmp_path):
    """``semseg_torch.train.run`` twice, float32, PSANet50 at 97x97 crops
    (13x13 features, where cuDNN's default f32 algorithms part two runs
    from one init after one step, ``chip_probes/convergence_determinism.py``),
    batch 2, 2 steps on 4 seeded images: every weight, BN statistic,
    momentum buffer and the step equal bit for bit, because ``run`` trains
    under cuDNN's deterministic algorithms; the caller's flags come back."""
    from pathlib import Path

    import cv2

    from semseg_torch import train
    from semseg_torch.engine.checkpoint import host_snapshot

    rs = np.random.RandomState(0)
    (tmp_path / "img").mkdir()
    lines = []
    for k in range(4):
        img = rs.randint(0, 256, (128, 160, 3)).astype(np.uint8)
        img[:, :80] //= 3
        cv2.imwrite(str(tmp_path / "img" / f"{k}.png"), img)
        cv2.imwrite(str(tmp_path / "img" / f"{k}_label.png"),
                    rs.randint(0, 5, (128, 160)).astype(np.uint8))
        lines.append(f"img/{k}.png img/{k}_label.png")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    states = []
    for run in ("a", "b"):
        cfg = train.parse_args([
            "--config", str(Path(__file__).resolve().parents[1] / "config" / "cityscapes"
                            / "cityscapes_psanet50.yaml"),
            "data_root", str(tmp_path), "train_list", str(tmp_path / "train.txt"),
            "classes", "5", "train_h", "97", "train_w", "97", "batch_size", "2", "epochs", "1",
            "workers", "2", "compute_dtype", "float32", "train_gpu", "[0]",
            "save_path", str(tmp_path / run), "manual_seed", "0"])
        res = train.run(cfg, cuda)
        assert res["trainer"].step_count == 2
        states.append(host_snapshot(res["trainer"].state_dict()))
        assert not torch.backends.cudnn.deterministic  # the caller's flag, back
    a, b = states
    assert a["step"] == b["step"] == 2 and list(a["state_dict"]) == list(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(b["state_dict"][k], v), k
    for k, v in a["optimizer"]["state"].items():
        assert torch.equal(b["optimizer"]["state"][k]["momentum_buffer"], v["momentum_buffer"]), k


def _seeded_batchnorm(c, g, dev):
    """An eval ``BatchNorm2d`` with affine parameters and running
    statistics drawn from ``g`` (variances from 0.05 to 2.05, not the
    initial 1)."""
    from semseg_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(c).to(dev).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g, device=dev) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g, device=dev) * 0.3)
        bn.running_mean.copy_(torch.randn(c, generator=g, device=dev) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g, device=dev) * 2 + 0.05)
    return bn


@pytest.mark.parametrize("variant", ["plain", "relu", "residual"])
@pytest.mark.parametrize("shape", [
    (8, 64, 357, 357),   # the deep stem (odd planes: vectors straddle channels)
    (8, 256, 179, 179),  # layer1
    (8, 2048, 90, 90),   # layer4
    (8, 512, 1, 1),      # the pyramid pooling's bins
    (8, 512, 6, 6),
    (3, 5, 7, 3),        # ragged: 315 elements, a tail after the last vector
])
def test_batchnorm_kernel_matches_plain_bit_for_bit(cuda, shape, variant):
    from semseg_torch.ops.batchnorm import batchnorm_eval, batchnorm_eval_reference

    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    bn = _seeded_batchnorm(shape[1], g, cuda)
    x = (torch.randn(shape, generator=g, device=cuda) * 2).to(torch.bfloat16)
    res = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
           if variant == "residual" else None)
    relu = variant != "plain"
    with torch.inference_mode():
        before = batchnorm_eval.launches
        got = batchnorm_eval(x, bn, residual=res, relu=relu)
        torch.cuda.synchronize()
        assert batchnorm_eval.launches == before + 1
        want = batchnorm_eval_reference(x, bn, residual=res, relu=relu)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("variant", ["plain", "relu", "residual"])
def test_batchnorm_kernel_special_values_and_offsets(cuda, variant):
    """NaN, infinities, a -0.0 result (x at the mean, weight -1, bias
    -0.0) and a view that starts off a 16-byte boundary (the scalar form),
    bit for bit against the plain version."""
    from semseg_torch.ops.batchnorm import batchnorm_eval, batchnorm_eval_reference

    g = torch.Generator(device=cuda).manual_seed(5)
    bn = _seeded_batchnorm(4, g, cuda)
    with torch.no_grad():
        bn.weight[0], bn.bias[0] = -1.0, -0.0
    base = (torch.randn(3 * 4 * 11 * 5 + 1, generator=g, device=cuda) * 2).to(torch.bfloat16)
    x = base[1:].view(3, 4, 11, 5)  # storage offset of 2 bytes: contiguous, unaligned
    x[0, 0, 0, :3] = bn.running_mean[0].to(torch.bfloat16)
    x[1, 0, 2, :3] = bn.running_mean[0].to(torch.bfloat16)
    x[0, 1, 0, 0], x[0, 2, 0, 0], x[0, 3, 0, 0] = float("nan"), float("inf"), -float("inf")
    res = (torch.randn(x.shape, generator=g, device=cuda).to(torch.bfloat16)
           if variant == "residual" else None)
    if res is not None:
        res[0, 0, 0, 0] = -0.0
    for inp in (x, x.contiguous()):  # the scalar form, then the vectors
        with torch.inference_mode():
            got = batchnorm_eval(inp, bn, residual=res, relu=variant != "plain")
            want = batchnorm_eval_reference(inp, bn, residual=res, relu=variant != "plain")
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("variant", ["plain", "relu", "residual"])
def test_batchnorm_kernel_channels_last_bit_for_bit(cuda, variant):
    """Channels-last activations, which cuDNN's convolutions give for a
    channels-last input (an NHWC batch permuted to NCHW), run the kernel
    with their order kept, bit for bit against the plain version."""
    from semseg_torch.ops.batchnorm import batchnorm_eval, batchnorm_eval_reference

    for shape in ((4, 256, 45, 45), (3, 5, 7, 3)):
        g = torch.Generator(device=cuda).manual_seed(sum(shape))
        bn = _seeded_batchnorm(shape[1], g, cuda)
        x = (torch.randn(shape, generator=g, device=cuda) * 2).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        res = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) if variant == "residual" else None)
        assert not x.is_contiguous()
        with torch.inference_mode():
            before = batchnorm_eval.launches
            got = batchnorm_eval(x, bn, residual=res, relu=variant != "plain")
            torch.cuda.synchronize()
            assert batchnorm_eval.launches == before + 1
            want = batchnorm_eval_reference(x, bn, residual=res, relu=variant != "plain")
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_batchnorm_kernel_invstd_sweep(cuda):
    """The kernel's ``rsqrtf(var + eps)`` against the plain version's
    ``torch.rsqrt(running_var + eps)`` over 4096 channels of variances
    spread over eight decades: every output bit for bit (a one-ulp
    difference in a channel's invstd turns some of its 16 K outputs)."""
    from semseg_torch.ops.batchnorm import batchnorm_eval, batchnorm_eval_reference

    g = torch.Generator(device=cuda).manual_seed(17)
    c = 4096
    bn = _seeded_batchnorm(c, g, cuda)
    with torch.no_grad():
        bn.running_var.copy_(10.0 ** (torch.rand(c, generator=g, device=cuda) * 8 - 4))
        bn.running_mean.mul_(1e-2)
    x = (torch.randn(4, c, 64, 64, generator=g, device=cuda) * 1e-2).to(torch.bfloat16)
    for eps in (1e-5, 1e-3):
        bn.eps = eps
        with torch.inference_mode():
            got = batchnorm_eval(x, bn)
            want = batchnorm_eval_reference(x, bn)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), eps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_kernel_follows_statistics_that_training_moves(cuda, dtype):
    """Train-mode steps on the card (cuDNN updates the running statistics
    in place) between bf16 eval calls: each eval call normalises with the
    statistics of the moment, bit for bit the plain version."""
    from semseg_torch.ops.batchnorm import batchnorm_eval, batchnorm_eval_reference

    g = torch.Generator(device=cuda).manual_seed(19)
    bn = _seeded_batchnorm(64, g, cuda)
    x = (torch.randn(4, 64, 33, 33, generator=g, device=cuda) * 2).to(torch.bfloat16)
    for _ in range(3):
        bn.train()
        with torch.no_grad():
            bn((torch.randn(8, 64, 17, 17, generator=g, device=cuda) * 3 + 1).to(dtype))
        bn.eval()
        with torch.inference_mode():
            got = batchnorm_eval(x, bn, relu=True)
            want = batchnorm_eval_reference(x, bn, relu=True)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_batchnorm_kernel_rejects_what_it_does_not_take(cuda):
    from semseg_torch.ops.batchnorm import batchnorm_eval

    bn = _seeded_batchnorm(4, torch.Generator(device=cuda).manual_seed(0), cuda)
    x = torch.zeros(2, 4, 6, 6, device=cuda, dtype=torch.bfloat16)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            batchnorm_eval(x.transpose(2, 3), bn)
        with pytest.raises(ValueError, match="contiguous"):
            batchnorm_eval(x, bn, residual=x.transpose(2, 3), relu=True)
        with pytest.raises(ValueError, match="residual"):
            batchnorm_eval(x, bn, residual=x.float())
        with pytest.raises(ValueError):
            batchnorm_eval(x[0], bn)  # no batch axis


def _psp_bf16(cuda, seed=0):
    """A bf16 PSPNet50 on the card with seeded weights and BN statistics."""
    from semseg_torch.models.layers import BatchNorm2d
    from semseg_torch.models.pspnet import PSPNet

    model = PSPNet(layers=50, classes=19, zoom_factor=8, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g, device=cuda) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g, device=cuda) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=g, device=cuda) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g, device=cuda) + 0.5)
    return model


def test_pspnet50_bf16_eval_runs_one_kernel_per_batchnorm(cuda, monkeypatch):
    """A bf16 eval forward launches the BN kernel once for each of the 60
    BatchNorms it runs, and its logits equal those of the eager path (the
    dispatch rule turned off) bit for bit."""
    from semseg_torch.ops import batchnorm
    from semseg_torch.utils.misc import deterministic_cudnn

    model = _psp_bf16(cuda).eval()
    x = torch.randn(2, 3, 129, 129, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    with deterministic_cudnn(), torch.inference_mode():
        before = batchnorm.batchnorm_eval.launches
        got = model(x)
        torch.cuda.synchronize()
        assert batchnorm.batchnorm_eval.launches - before == 60
        monkeypatch.setattr(batchnorm, "supported", lambda dtype: False)
        want = model(x)
        assert batchnorm.batchnorm_eval.launches - before == 60
    assert got.dtype == torch.float32 and torch.equal(got.view(torch.int32),
                                                      want.view(torch.int32))


def test_bf16_eval_step_runs_the_kernel_bit_for_bit(cuda, monkeypatch):
    """The training driver's validation step (``eval_step``: an NHWC batch
    normalised on the card, so channels-last activations) runs the BN
    kernel once a BatchNorm and gives the eager path's sums bit for bit."""
    from semseg_torch.engine.trainer import eval_step
    from semseg_torch.ops import batchnorm
    from semseg_torch.serve import IMAGENET_MEAN, IMAGENET_STD
    from semseg_torch.utils.misc import deterministic_cudnn

    model = _psp_bf16(cuda).eval()
    g = torch.Generator().manual_seed(4)
    images = torch.randint(0, 256, (2, 129, 129, 3), generator=g, dtype=torch.uint8)
    labels = torch.randint(0, 19, (2, 129, 129), generator=g)
    kw = dict(classes=19, ignore_label=255, zoom_factor=8,
              normalize=(IMAGENET_MEAN, IMAGENET_STD))
    with deterministic_cudnn():
        before = batchnorm.batchnorm_eval.launches
        got = eval_step(model, images, labels, **kw)
        torch.cuda.synchronize()
        assert batchnorm.batchnorm_eval.launches - before == 60
        monkeypatch.setattr(batchnorm, "supported", lambda dtype: False)
        want = eval_step(model, images, labels, **kw)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_batchnorm_kernel_stays_off_f32_training_and_autograd(cuda):
    """No launch in a float32 eval forward, in a bf16 train step, or in a
    bf16 eval forward that autograd records (its gradients flow)."""
    from semseg_torch.models.pspnet import PSPNet
    from semseg_torch.ops.batchnorm import batchnorm_eval

    x = torch.randn(2, 3, 65, 65, generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda)
    before = batchnorm_eval.launches
    f32 = PSPNet(layers=50, classes=3, zoom_factor=8).to(cuda).eval()
    with torch.inference_mode():
        f32(x)
    del f32
    model = _psp_bf16(cuda).train()
    logits, aux = model(x)
    (logits.mean() + aux.mean()).backward()
    model.eval()
    model.zero_grad()
    model(x).float().mean().backward()
    torch.cuda.synchronize()
    assert batchnorm_eval.launches == before
    assert model.layer1[0].conv1.weight.grad is not None
