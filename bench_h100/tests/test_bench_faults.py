"""``correct`` comes out false when the timed path is broken underneath
(``tools/faults.py``): the whole run but the look for a card, at the
rehearsal's tiny size on the CPU. And the control, the reference in the
next lower precision in the program's place, fails the cell's limits at
the cell's own size on the card (``cuda``; at the tiny size its errors are
too small to say anything about the limits set at full size)."""

import time

import pytest

from bench_h100.harness import manifest, runner
from bench_h100.rehearse import tiny
from bench_h100.tools import faults

SEED = 2 ** 31 + 17


def run(workload, control=None, device="cpu", seed=SEED, **mix):
    cell = manifest.cell(workload)
    if device == "cpu":
        cell = tiny(cell)
    cell.traffic.update(mix)
    return runner.execute(cell, seed, 0.5, False, device, time.perf_counter(), control)


def beyond_limits(numbers, limits):
    return [n for n, v in numbers.items() if n in limits and v > limits[n]["limit"]]


def test_sound_serving_is_correct():
    # float32 at the tiny size: the limits were set for bf16 at full size
    result, _ = run("city_pspnet50_serve_ss", dtype="float32")
    assert result["correct"], result["compared"]
    assert result["compared"]["gap_ratio"]["value"] < 0.1  # far closer than plain bf16


@pytest.mark.parametrize("workload,fault", [
    ("city_pspnet50_serve_ss", "altered"),
    ("city_psanet50_train_f32", "frozen"),
    ("city_psanet50_train_f32", "half_batch"),
    ("city_psanet50_train_bf16", "frozen"),
    ("city_psanet50_train_bf16", "half_batch"),
])
def test_fault_is_not_correct(workload, fault):
    mix = {"dtype": "float32"} if workload.startswith("city_pspnet50_serve") else {}
    with faults.FAULTS[fault]():
        result, _ = run(workload, **mix)
    assert not result["correct"], result["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", [
    ("city_pspnet50_serve_ss", "fp8"), ("city_pspnet50_serve_ms", "fp8"),
    ("city_psanet50_train_bf16", "fp8"), ("city_psanet50_train_f32", "tf32")])
def test_control_is_not_correct(cuda, workload, control):
    limits = manifest.cell(workload).limits
    for seed in (SEED, SEED + 1):
        result, extra = run(workload, control=control, device=cuda, seed=seed)
        assert result["correct"], result["compared"]
        assert beyond_limits(extra["control"], limits), (seed, extra["control"])
