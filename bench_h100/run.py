"""Run one cell of the H100 benchmark once and print its result line.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``semseg_torch``. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``compared``: each number that decides
``correct`` beside its limit); the last lines of standard error repeat the
compared numbers. Exits non-zero, printing no result, without the CUDA
devices the cell asks for, without ``semseg_torch`` beside this folder, or
when ``jax``, ``jaxlib``, ``flax`` or ``semseg_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "semseg_tpu")
# Fixed cache directories inside the checkout: a run's kernels built by
# nvcc (``build/semseg_torch_kernels``, the program's own choice) and any
# Triton, extension or CUDA JIT cache persist from the first run on.
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_jit"}


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    if not (ROOT / "semseg_torch" / "__init__.py").is_file():
        print(f"no semseg_torch package beside {Path(__file__).parent.name}/: "
              "nothing to measure", file=sys.stderr)
        return 2
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_h100" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_h100.harness import manifest, runner

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine shows "
              f"{count}", file=sys.stderr)
        return 3
    result, _ = runner.execute(cell, args.seed, args.seconds, bool(args.trace),
                               "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark and the port import "
              "none of them", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r} ({c['at']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
