"""Where ``chip_smoke.py``'s wall time goes, phase by phase, for one or
more checkouts in one call.

For each ``--root`` in the order given (this checkout, or an older commit
unpacked with ``git archive`` under ``build/``), it runs ``python3 -u
chip_smoke.py`` from that directory and stamps every line of its standard
output with the host clock as the line arrives. Lines carry their phase's
tag (``[21 ddp] ...``); an untagged line belongs to the phase before it. A
phase's seconds run from the last line of the phase before it (the
process start for the first) to its own last line, summed over the
phase's stretches (the ``kernels`` and ``ok`` lines fall to the last
phase, ``summary``); ``exit`` runs from the last line to the exit. Each
run's output goes to ``<out>/<n>_<label>.{out,err}`` (``--out``, default
``build/smoke_phases``), where ``<label>`` is the root's last path
component. Prints one JSON line a run (``root``,
``rc``, ``wall_s``, ``phases``) and exits non-zero if any run failed.

Usage, from the repository root, on the card:
    python3 chip_probes/smoke_phases.py --root build/parent --root build/proof \
        [--out DIR]
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = re.compile(r"^\[(\d+|[a-z]+)\b")


def phase_seconds(stamped, wall):
    """``{phase: seconds}`` from ``[(seconds since start, line)]`` and the
    run's ``wall`` seconds."""
    phases, key, last = {}, None, 0.0
    for t, line in stamped:
        m = TAG.match(line)
        if m and m.group(1) != key:
            key = m.group(1)
        if key is None:
            continue
        phases[key] = phases.get(key, 0.0) + (t - last)
        last = t
    phases["exit"] = wall - last
    return phases


def run(root: Path, n: int, out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    label = f"{n}_{root.resolve().name}"
    err = open(out_dir / f"{label}.err", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=root,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    stamped = []
    with open(out_dir / f"{label}.out", "w") as out:
        for line in proc.stdout:
            stamped.append((time.perf_counter() - t0, line.rstrip("\n")))
            out.write(f"{stamped[-1][0]:10.3f} {line}")
            out.flush()
    rc = proc.wait()
    wall = time.perf_counter() - t0
    err.close()
    return {"root": str(root), "rc": rc, "wall_s": round(wall, 3),
            "phases": {k: round(v, 3) for k, v in phase_seconds(stamped, wall).items()},
            "last_line": stamped[-1][1] if stamped else ""}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True, type=Path,
                    help="a checkout holding chip_smoke.py; repeat to run several in turn")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "smoke_phases",
                    help="where each run's stamped output and its errors go")
    args = ap.parse_args()
    rcs = []
    for n, root in enumerate(args.root):
        res = run(root, n, args.out)
        rcs.append(res["rc"])
        print(json.dumps(res), flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
