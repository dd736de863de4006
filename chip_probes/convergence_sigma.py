"""Paired replicas of the convergence license, on the card, and the
equivalence verdict on their mean gap: the port's counterpart of the
replica runs of ``CONVERGENCE_r05.jsonl``.

A replica is one (arch, seed, stream offset): the float32 arm and the
bfloat16 arm of ``semseg_torch.convergence.run``, both from the one float32
init of the seed, with the dropout and batch-index streams shifted by the
offset. Offset 0 is what ``python3 -m semseg_torch.convergence --seed S``
runs. The replicas are listed in a fixed order (seed, then offset, then
arch) and dealt round-robin to ``--jobs`` worker processes that share the
card; a worker starts no replica once ``--deadline`` seconds have passed
since the launch, so a call ends inside its time limit with every finished
replica kept.

Prints one JSON line per replica (``within_arm_replica``: both finals, the
gap f32 - bf16 in points, the trajectories), one per (arch, seed)
with several offsets (``within_arm_sigma_points``: the sample standard deviations, ddof 1, of
the float32 finals, the bfloat16 finals and the gaps, and the mean gap),
and one per arch over every finished replica (``pooled_gap_points``: the
mean gap, its standard error σ_gap / √n, the interval mean ± 2·SE and the
verdict of the equivalence rule at the JAX tool's 1-point resolution:
``holds`` if the interval lies inside (-1, 1) points, ``fails`` if it lies
wholly outside, else ``inconclusive``), each with the card's name and power
limit. With ``--out DIR`` every worker's lines also go to
``DIR/worker_<k>.txt`` as they come.

Usage, from the repository root:
``python3 chip_probes/convergence_sigma.py --arch psp psa --seeds 3 4 5 --offsets 0 1 2 3 --jobs 4``
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semseg_torch import convergence as conv  # noqa: E402

BAR_POINTS = 1.0  # the JAX tool's criterion, tool/convergence.py:198


def sd(values):
    return float(np.std(values, ddof=1)) if len(values) > 1 else None


def pooled(gaps):
    """Mean gap, σ_gap, standard error, the interval mean ± 2·SE and the
    equivalence verdict against ``BAR_POINTS``."""
    mean = float(np.mean(gaps))
    sigma = sd(gaps)
    out = {"n": len(gaps), "mean_gap_points": mean, "sigma_gap_points": sigma,
           "standard_error_points": None, "interval_points": None, "verdict": "inconclusive"}
    if sigma is None:
        return out
    se = sigma / np.sqrt(len(gaps))
    lo, hi = mean - 2 * se, mean + 2 * se
    out.update(standard_error_points=float(se), interval_points=[float(lo), float(hi)])
    if -BAR_POINTS < lo and hi < BAR_POINTS:
        out["verdict"] = "holds"
    elif lo >= BAR_POINTS or hi <= -BAR_POINTS:
        out["verdict"] = "fails"
    return out


def report(replicas, smi):
    """The per-seed and pooled lines of finished replica lines."""
    lines = []
    for arch in sorted({r["arch"] for r in replicas}):
        mine = [r for r in replicas if r["arch"] == arch]
        for seed in sorted({r["seed"] for r in mine}):
            rs = sorted((r for r in mine if r["seed"] == seed), key=lambda r: r["stream_offset"])
            if len(rs) < 2:
                continue
            gaps = [r["gap_points"] for r in rs]
            lines.append({"metric": "within_arm_sigma_points", "arch": arch, "seed": seed,
                          "steps": rs[0]["steps"], "offsets": [r["stream_offset"] for r in rs],
                          "f32_finals": [r["f32_final"] for r in rs],
                          "bf16_finals": [r["bf16_final"] for r in rs],
                          "gaps_points": gaps, "mean_gap_points": float(np.mean(gaps)),
                          "sigma_f32_points": sd([r["f32_final"] * 100 for r in rs]),
                          "sigma_bf16_points": sd([r["bf16_final"] * 100 for r in rs]),
                          "sigma_gap_points": sd(gaps), "device": smi})
        line = {"metric": "pooled_gap_points", "arch": arch,
                "seeds": sorted({r["seed"] for r in mine}), "steps": mine[0]["steps"]}
        line.update(pooled([r["gap_points"] for r in mine]))
        line["device"] = smi
        lines.append(line)
    return lines


def worker(spec):
    """Run the replicas of ``spec`` in order; print each replica's line."""
    torch.set_num_threads(spec["threads"])
    device = torch.device("cuda", 0)
    # the workers' caching allocators together must fit the card
    torch.cuda.set_per_process_memory_fraction(spec["memory_fraction"], device)
    train_set, val_set = conv.make_dataset(0, conv.N_TRAIN), conv.make_dataset(1, conv.N_VAL)
    inits = {}
    for arch, seed, offset in spec["replicas"]:
        if time.time() > spec["stop_at"]:
            break
        if (arch, seed) not in inits:
            inits[arch, seed] = conv.initial_state(arch, seed, device)
        t0 = time.perf_counter()
        results = {name: conv.run(name, spec["steps"], train_set, val_set, arch=arch,
                                  seed=seed, init_state=inits[arch, seed],
                                  stream_offset=offset, device=device)
                   for name in ("float32", "bfloat16")}
        line = conv.summary(arch, spec["steps"], seed, results, spec["smi"])
        line.update(metric="within_arm_replica", stream_offset=offset,
                    seconds=round(time.perf_counter() - t0, 1))
        print(json.dumps(line), flush=True)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", choices=("psp", "psa"), nargs="+", default=["psp"])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--offsets", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--jobs", type=int, default=1,
                        help="worker processes sharing the card")
    parser.add_argument("--deadline", type=float, default=float("inf"),
                        help="seconds after which no replica is started")
    parser.add_argument("--out", help="directory for each worker's lines")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        return worker(json.loads(args.worker))
    if not torch.cuda.is_available():
        print("convergence_sigma: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = conv.device_line(0)
    if "psa" in args.arch:  # build once, before the workers load it
        from semseg_torch.ops import _build
        _build.build_library("psa")
    replicas = [(arch, seed, offset) for seed in args.seeds for offset in args.offsets
                for arch in args.arch]
    stop_at = time.time() + args.deadline
    threads = max(1, (os.cpu_count() or 1) // args.jobs)
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in range(args.jobs):
        spec = {"replicas": replicas[k::args.jobs], "steps": args.steps, "smi": smi,
                "stop_at": stop_at, "threads": threads, "memory_fraction": 0.9 / args.jobs}
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", json.dumps(spec)]
        log = open(out / f"worker_{k}.txt", "w") if out is not None else subprocess.PIPE
        procs.append((subprocess.Popen(cmd, stdout=log, text=True), log))
    finished, rc = [], 0
    for proc, log in procs:
        text = proc.communicate()[0]
        rc = rc or proc.returncode
        if log is not subprocess.PIPE:
            log.close()
            text = Path(log.name).read_text()
        finished += [json.loads(ln) for ln in text.splitlines()
                     if ln.startswith('{"metric": "within_arm_replica"')]
    order = {r: i for i, r in enumerate(replicas)}
    finished.sort(key=lambda r: order[r["arch"], r["seed"], r["stream_offset"]])
    for line in finished + report(finished, smi):
        print(json.dumps(line), flush=True)
    print(json.dumps({"metric": "replicas_finished", "listed": len(replicas),
                      "finished": len(finished), "jobs": args.jobs}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
