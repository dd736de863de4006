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
    bf16), from the kernels' own forward statistics; grads in the primal
    dtypes; two calls bit-identical; one launch each."""
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
        before = (psa.psa_softmax_bmm_bwd_da.launches, psa.psa_softmax_bmm_bwd_dx.launches,
                  psa.psa_softmax_bmm_flash_bwd.launches)
        da = psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out, 1.3)
        dx = psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l, 1.3)
        fdx, fda = psa.psa_softmax_bmm_flash_bwd(x, a, g, fm, fl, fout, 1.3)
        torch.cuda.synchronize()
        assert (psa.psa_softmax_bmm_bwd_da.launches, psa.psa_softmax_bmm_bwd_dx.launches,
                psa.psa_softmax_bmm_flash_bwd.launches) == tuple(b + 1 for b in before)
        assert da.dtype == fda.dtype == dx.dtype == fdx.dtype == dtype
        want_dx, want_da = (dx32, da32) if dtype == torch.float32 else (
            dx32.to(dtype).float(), da32.to(dtype).float())
        bar_dx, bar_da = _bwd_bars(dtype, dx32, da32)
        assert (dx.float() - want_dx).abs().max().item() <= bar_dx
        assert (fdx.float() - want_dx).abs().max().item() <= bar_dx
        assert (da.float() - want_da).abs().max().item() <= bar_da
        assert (fda.float() - want_da).abs().max().item() <= bar_da
        assert torch.equal(da, psa.psa_softmax_bmm_bwd_da(x, a, g, m, l, out, 1.3))
        assert torch.equal(dx, psa.psa_softmax_bmm_bwd_dx(x, a, g, m, l, 1.3))
        again = psa.psa_softmax_bmm_flash_bwd(x, a, g, fm, fl, fout, 1.3)
        assert torch.equal(fdx, again[0]) and torch.equal(fda, again[1])


@pytest.mark.parametrize("entry,bwd", [("psa_softmax_bmm", 2), ("psa_softmax_bmm_flash", 1)])
def test_psa_autograd_on_cuda(cuda, entry, bwd):
    """Autograd through the kernels: gradients of the plain forward within
    the f32 bars; the resident path launches da and dx, the flash path its
    fused backward once."""
    fn = getattr(psa, entry)
    g0 = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 64, 150, generator=g0, device=cuda).requires_grad_()
    a = (torch.randn(2, 150, 150, generator=g0, device=cuda) * 3).requires_grad_()
    g = torch.randn(2, 64, 150, generator=g0, device=cuda)
    counters = (psa.psa_softmax_bmm_bwd_da, psa.psa_softmax_bmm_bwd_dx,
                psa.psa_softmax_bmm_flash_bwd)
    before = [f.launches for f in counters]
    dx, da = torch.autograd.grad(fn(x, a, 2.0), (x, a), g)
    added = sum(f.launches for f in counters) - sum(before)
    assert added == bwd
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


def test_psanet_train_step_on_cuda(cuda):
    """One bf16 PSANet50 train step at 97x97 crops through the Trainer:
    per step the resident forward, da and dx twice each (two directions),
    no flash and no stitch kernel; finite losses; every parameter moved."""
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
    counters = {"fwd": psa.psa_softmax_bmm, "da": psa.psa_softmax_bmm_bwd_da,
                "dx": psa.psa_softmax_bmm_bwd_dx, "flash": psa.psa_softmax_bmm_flash,
                "flash_bwd": psa.psa_softmax_bmm_flash_bwd,
                "stitch": stitch.upsample_softmax_flip}
    start = {k: f.launches for k, f in counters.items()}
    metrics = tr.step(images, labels)
    torch.cuda.synchronize()
    got = {k: f.launches - start[k] for k, f in counters.items()}
    assert got == {"fwd": 2, "da": 2, "dx": 2, "flash": 0, "flash_bwd": 0, "stitch": 0}
    assert np.isfinite(metrics["loss"].item()) and metrics["union"].sum().item() > 0
    for k, v in model.named_parameters():
        assert v.grad is not None and not torch.equal(v.detach(), before[k]), k
