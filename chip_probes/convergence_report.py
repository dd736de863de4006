"""The convergence license's verdicts from the JSON lines of its runs (no
device needed): for each arch, the summary lines of ``python3 -m
semseg_torch.convergence`` (``bf16_vs_f32_val_mIoU_gap``), judged seed by
seed and on their mean by the JAX tool's criterion (|gap| < 1 point), and
the replica lines of ``chip_probes/convergence_sigma.py``
(``within_arm_replica``), pooled and judged by its equivalence rule (the
interval mean ± 2·SE inside (-1, 1) points). ``--seeds`` keeps the replicas
of those seeds only. Lines from the same (arch, seed) or (arch, seed,
offset) count once (a rerun of the deterministic tool repeats them).

Usage: ``python3 chip_probes/convergence_report.py OUTPUT_FILE ... [--seeds S ...]``
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402

from convergence_sigma import report  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+")
    parser.add_argument("paths", nargs="+")
    args = parser.parse_args(argv)
    runs, replicas = {}, {}
    for path in args.paths:
        with open(path) as f:
            for ln in f:
                try:
                    rec = json.loads(ln)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                if rec.get("metric") == "bf16_vs_f32_val_mIoU_gap":
                    runs.setdefault(rec["arch"], {})[rec["seed"]] = rec
                elif rec.get("metric") == "within_arm_replica" and (
                        args.seeds is None or rec["seed"] in args.seeds):
                    replicas[rec["arch"], rec["seed"], rec["stream_offset"]] = rec
    pooled = {ln["arch"]: ln for ln in report(list(replicas.values()), None)
              if ln["metric"] == "pooled_gap_points"}
    for arch in sorted(set(runs) | set(pooled)):
        seeds = runs.get(arch, {})
        gaps = [seeds[s]["gap_points"] for s in sorted(seeds)]
        line = {"arch": arch, "seeds": sorted(seeds), "gaps_points": gaps,
                "per_seed_pass": [seeds[s]["pass"] for s in sorted(seeds)],
                "f32_finals": [seeds[s]["f32_final"] for s in sorted(seeds)],
                "bf16_finals": [seeds[s]["bf16_final"] for s in sorted(seeds)]}
        if gaps:
            mean = float(np.mean(gaps))
            line.update(mean_gap_points=mean, mean_pass=abs(mean) < 1.0)
        if arch in pooled:
            line["pooled"] = {k: pooled[arch][k] for k in (
                "seeds", "n", "mean_gap_points", "sigma_gap_points", "standard_error_points",
                "interval_points", "verdict")}
        line["device"] = next((r["device"] for r in [*seeds.values(), *replicas.values()]
                               if r["arch"] == arch), None)
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
