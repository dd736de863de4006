"""CPU rehearsal: every cell of ``BENCHMARK.json`` end to end at a tiny
size, the kernels' plain versions, ``--trace 0`` and ``1``.

    python3 bench_h100/rehearse.py [--workload NAME ...] [--seconds 2]

Not the benchmark's command and no measurement: it runs the drivers, the
reference, the comparison, the trace's reduction and every metric's reader
on 33x33 crops of 48x96 images (batch 2), so a wrong path, shape or key
shows here before a chip call. The chip command is ``python3
bench_h100/run.py`` (``README.md``).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TINY_MODEL = {"train_h": 33, "train_w": 33, "test_h": 33, "test_w": 33, "base_size": 96}
TINY_SERVE = {"image_h": 48, "image_w": 96, "pool": 4, "warmup_requests": 1,
              "check_images": 2}
TINY_TRAIN = {"batch": 2, "image_h": 48, "image_w": 96, "crops_per_image": 2}


def tiny(cell):
    """The cell at the rehearsal's size: every width as published, the
    crops, images and batch cut."""
    cell = copy.deepcopy(cell)
    cell.config["model"].update(TINY_MODEL)
    cell.traffic.update(TINY_SERVE if cell.driver == "serve" else TINY_TRAIN)
    return cell


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", nargs="*")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seed", type=int, default=2 ** 31 + 5)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_h100.harness import manifest, runner

    torch.set_num_threads(4)
    names = args.workload or [w["name"] for w in
                              manifest.load_json(ROOT / "BENCHMARK.json")["workloads"]]
    for name in names:
        for trace in (0, 1):
            cell = tiny(manifest.cell(name))
            t0 = time.perf_counter()
            result, extra = runner.execute(cell, args.seed, args.seconds, bool(trace), "cpu", t0)
            print(json.dumps({"workload": name, "trace": trace,
                              "seconds": round(time.perf_counter() - t0, 3), **result}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
