"""What a run loads and where it may run: no JAX, no semseg_tpu, a
reference free of the program, no result without a card or without the
program beside the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_h100.harness import manifest

ROOT = manifest.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "semseg_tpu"}


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    code = ("from bench_h100.harness import manifest, runner\n"
            "from bench_h100.rehearse import tiny\n"
            "import time\n"
            "cell = tiny(manifest.cell('city_pspnet50_serve_ss'))\n"
            "cell.traffic.update(pool=1, check_images=1)\n"
            "runner.execute(cell, 1, 0.5, True, 'cpu', time.perf_counter())\n"
            "for m in manifest.load_json(manifest.ROOT / 'BENCHMARK.json')['per_layer']:\n"
            "    manifest.reader(m['name'])\n"
            "import bench_h100.drivers.train, bench_h100.tools.calibrate")
    top = loaded_after(code)
    assert "semseg_torch" in top
    assert not top & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    top = loaded_after("import bench_h100.reference.models, bench_h100.reference.pipeline, "
                       "bench_h100.reference.train, bench_h100.reference.quant, "
                       "bench_h100.harness.weights, bench_h100.harness.work")
    assert "semseg_torch" not in top and not top & FORBIDDEN


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                        "city_pspnet50_serve_ss", "--seed", str(2 ** 31 + 9), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench_h100/run.py", "--workload",
                        "city_pspnet50_serve_ss", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
