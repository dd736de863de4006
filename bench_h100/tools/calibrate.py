"""Readings that set the limits of ``correct``, on the chip, in one process:
for each seed a run of the cell (a short window), the numbers it compares,
and with ``--control`` the same numbers of the reference computed in the
lower precision in the program's place (``bf16``: the witness, a plain
bfloat16 run of the reference, read the same way); ``--fault`` plants one of
``tools/faults.py`` under the timed path instead.

    python3 bench_h100/tools/calibrate.py --workload NAME --seeds 1 2 3 \
        [--control fp8|tf32|bf16] [--fault NAME] [--seconds 5] [--out FILE]

One JSON line a seed on standard output (and appended to ``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", choices=("fp8", "tf32", "bf16"))
    p.add_argument("--fault")
    p.add_argument("--out")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_h100.harness import manifest, runner
    from bench_h100.tools.faults import FAULTS

    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        fault = FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
        with fault:
            result, extra = runner.execute(cell, seed, args.seconds, False, args.device, t0,
                                           control=args.control)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": result["correct"],
                "numbers": {k: v for k, (v, _) in extra["numbers"].items()},
                "at": {k: at for k, (_, at) in extra["numbers"].items()},
                "control": extra["control"], "control_kind": args.control,
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                "attempted": result["attempted"], "device": result["device"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
