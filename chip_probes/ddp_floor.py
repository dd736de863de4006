"""Where the DDP step test's bars come from: the one-ulp floor.

Runs on the CPU; no card needed (torch and the port only). For each case
of ``tests/test_torch_parallel_ddp.py`` (PSPNet50 and PSANet50 at 49x49
crops, 5 classes, global batch 4, two f32 steps, dropout off) it runs:
- the one-process ``Trainer(num_replicas=2)``: the reference;
- the same with every image moved by one float32 ulp (``np.nextafter``
  towards +inf): the floor;
- 2 gloo DDP ranks in spawned processes, 2 samples each.
and prints, for the floor and for DDP, the relative L2 distance of each
state entry to the reference over the change the reference made (max,
with its key, and median over the entries) and the losses.

Usage, from the repository root (2 intra-op threads a process, as the
test):
    env OMP_NUM_THREADS=2 python3 chip_probes/ddp_floor.py
"""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semseg_torch.parallel import parity  # noqa: E402
from test_torch_parallel_ddp import _ddp_spec  # noqa: E402


def summary(d):
    worst = max(d, key=d.get)
    return f"max {d[worst]:.4f} ({worst}), median {np.median(list(d.values())):.4f}"


def main():
    torch.set_num_threads(2)
    for arch, sync_bn in (("psp", True), ("psa", True), ("psa", False)):
        spec = _ddp_spec(arch, sync_bn)
        ref = parity.one_process_steps(spec, 2)
        moved = dataclasses.replace(spec, batches=[
            (np.nextafter(im, np.float32(np.inf)), lb) for im, lb in spec.batches])
        floor = parity.one_process_steps(moved, 2)
        ddp = parity.ddp_steps(spec, 2)
        print(f"{arch} sync_bn {sync_bn}:")
        print(f"  losses: one process {ref['losses']}, one ulp {floor['losses']}, "
              f"DDP {ddp[0]['losses']}")
        print("  one-ulp floor: "
              + summary(parity.relative_distances(floor["state"], ref["state"], ref["init"])))
        print("  DDP:           "
              + summary(parity.relative_distances(ddp[0]["state"], ref["state"], ref["init"])))


if __name__ == "__main__":
    main()
