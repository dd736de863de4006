"""The work counted from shapes: FLOPs against hand counts, the least times
against ``chip_smoke.py``'s published bounds."""

import pytest
import torch
from torch import nn

from bench_h100.harness import manifest, work
from bench_h100.reference import models, quant


def test_conv_flops_hand_count():
    conv = nn.Sequential(models.Conv2d(64, 128, 3, padding=1, bias=False)).to("meta")
    got = work._forward_flops(conv, (2, 64, 10, 10), train=False)
    assert got == 2 * (2 * 10 * 10) * 128 * (64 * 9)


def test_psa_product_flops_hand_count():
    class Product(nn.Module):
        def forward(self, x):
            n, c, hw = x.shape
            return quant.bmm(x, torch.empty(n, hw, hw, device=x.device))

    got = work._forward_flops(Product(), (16, 512, 2025), train=False)
    assert got == 2 * 16 * 512 * 2025 * 2025


def test_model_flops_in_range():
    psp = manifest.cell("city_pspnet50_serve_ss").config
    psa = manifest.cell("city_psanet50_train_bf16").config
    assert 0.70e12 < work.forward_flops(psp, 1, 713, train=False) < 0.76e12
    fwd = work.forward_flops(psa, 16, 705, train=True)
    step = work.train_step_flops(psa, 16, 705)
    assert step == 3 * fwd - 2 * 16 * 353 * 353 * 64 * 27
    assert 38e12 < step < 42e12


@pytest.mark.parametrize("fn,dtype,ms,by", [
    (work.psa_fwd_bound, torch.bfloat16, 0.0689, "bytes"),
    (work.psa_dx_bound, torch.bfloat16, 0.0690, "bytes"),
    (work.psa_da_bound, torch.bfloat16, 0.1279, "bytes"),
    (work.psa_fwd_bound, torch.float32, 0.4072, "operations"),
])
def test_psa_bounds_match_published(fn, dtype, ms, by):
    got, bound_by = fn(16, 512, 2025, dtype)
    assert round(got, 4) == ms and bound_by == by


def test_stitch_bound_matches_published():
    assert round(work.stitch_bound(4, 19, 89, 705)[0], 4) == 0.0233
    assert work.stitch_bound(4, 19, 90, 713)[1] == "bytes"


def test_peaks():
    assert work.peak_flops(torch.bfloat16) == 989e12
    assert work.peak_flops(torch.float32) == 165e12
