"""Where the TP step test's bars come from: the one-ulp floor.

Runs on the CPU; no card needed (torch and the port only). For each case
of ``tests/test_torch_parallel_tp.py`` (PSPNet50 and PSANet50 at 49x49
crops, 5 classes, global batch 4, two f32 steps, dropout off; ``world x
model_parallel`` of 2 x 2 or 4 x 2) it runs:
- the one-process ``Trainer(num_replicas=world / model_parallel)``: the
  reference;
- the same with every image moved by one float32 ulp (``np.nextafter``
  towards +inf): the floor;
- the ranks of ``semseg_torch.parallel.parity.tp_steps`` over gloo in
  spawned processes,
and prints, for the floor and for TP, the relative L2 distance of each
state entry to the reference over the change the reference made (max,
with its key, and median over the entries), the losses, and the seconds.

Usage, from the repository root (2 intra-op threads a process, as the
test):
    env OMP_NUM_THREADS=2 python3 chip_probes/tp_floor.py
"""

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semseg_torch.parallel import parity  # noqa: E402
from test_torch_parallel_ddp import _ddp_spec  # noqa: E402
from test_torch_parallel_tp import TP_CASES  # noqa: E402


def summary(d):
    worst = max(d, key=d.get)
    return f"max {d[worst]:.4f} ({worst}), median {np.median(list(d.values())):.4f}"


def main():
    torch.set_num_threads(2)
    for arch, world, model_parallel, sync_bn in TP_CASES:
        spec = _ddp_spec(arch, sync_bn)
        replicas = world // model_parallel
        ref = parity.one_process_steps(spec, replicas)
        moved = dataclasses.replace(spec, batches=[
            (np.nextafter(im, np.float32(np.inf)), lb) for im, lb in spec.batches])
        floor = parity.one_process_steps(moved, replicas)
        t0 = time.perf_counter()
        ranks = parity.tp_steps(spec, world, model_parallel)
        seconds = time.perf_counter() - t0
        print(f"{arch} {replicas} x {model_parallel} sync_bn {sync_bn}: tp_steps {seconds:.1f} s")
        print(f"  losses: one process {ref['losses']}, one ulp {floor['losses']}, "
              f"TP rank 0 {ranks[0]['losses']}")
        print("  one-ulp floor: "
              + summary(parity.relative_distances(floor["state"], ref["state"], ref["init"])))
        print("  TP:            "
              + summary(parity.relative_distances(ranks[0]["state"], ref["state"], ref["init"])))


if __name__ == "__main__":
    main()
