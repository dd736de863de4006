"""The 2-rank DDP train step against the one-process
``Trainer(num_replicas=2)`` on the CPU (``semseg_torch.parallel.parity``):
gloo ranks in spawned processes, two intra-op threads each
(``OMP_NUM_THREADS``, which they inherit), as in this process.
``tests/test_torch_lockstep_replicas.py`` holds the one-process step to
``make_train_step(num_replicas=2)``. Inputs are made from seeds with
numpy."""

from types import SimpleNamespace

import numpy as np
import pytest

from driver_data import threads  # noqa: F401  (2 intra-op threads here too)
from semseg_torch.parallel import parity


@pytest.fixture(autouse=True)
def rank_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


DDP_CROP, DDP_CLASSES = 49, 5
# The largest relative distance to the one-process run (the L2 distance of
# a state entry over the L2 change the one-process run made) after two
# steps, and its median over the entries; see the test's docstring.
DDP_BARS = {"psp": (0.4, 0.23), "psa": (0.6, 0.38)}


def _ddp_spec(arch, sync_bn):
    keys = dict(arch=arch, layers=50, classes=DDP_CLASSES, zoom_factor=8, train_h=DDP_CROP,
                train_w=DDP_CROP, sync_bn=sync_bn)
    if arch == "psa":
        keys.update(psa_type=2, compact=0, shrink_factor=2, normalization_factor=1.0,
                    psa_softmax=1)
    rs = np.random.RandomState(4)
    batches = []
    for _ in range(2):
        labels = rs.randint(0, DDP_CLASSES, (4, DDP_CROP, DDP_CROP))
        labels[:, : DDP_CROP // 4] = 255
        labels[1, DDP_CROP // 2:] = 255
        batches.append((rs.randn(4, DDP_CROP, DDP_CROP, 3).astype(np.float32), labels))
    return parity.StepSpec(cfg=SimpleNamespace(**keys), batches=batches, device="cpu")


@pytest.mark.parametrize("arch,sync_bn", [("psp", True), ("psa", True), ("psa", False)],
                         ids=["psp-sync_bn", "psa-sync_bn", "psa-replica_bn"])
def test_ddp_matches_one_process(arch, sync_bn):
    """Two f32 steps as 2 gloo DDP ranks (2 samples each, 49 crops, dropout
    off) against the one-process ``Trainer(num_replicas=2)`` from the same
    seeded weights on the same global batches. The two differ in the order
    of their sums only: the synchronised BN's moments from all-reduced sums
    against PyTorch's batch norm over the whole batch (with ``sync_bn``
    False, each rank's batch norm against JAX's per-group arithmetic),
    convolutions at batch 2 against batch 4, gradients averaged over the
    ranks against one backward over the batch. The losses agree within
    1e-5 relative at step 0 (a forward from identical weights) and 5e-3 at
    step 1, after the first update (measured at most 4.0e-4, the one-ulp
    floor below at most 4.1e-4; the one-process run alone moves its step-1
    main loss by up to 1.8e-3 between 1, 2, 4 and 8 intra-op threads);
    both ranks log the same reduced losses.

    The state after two steps is held to the one-process run by the
    relative L2 distance of each entry, over the change the one-process
    run made. At this random init that is chaotic, so the bar comes from
    the one-ulp floor: the one-process run against itself with every image
    moved by one float32 ulp. Measured on the CPU, 2 threads a process
    (``chip_probes/ddp_floor.py``), max / median over the entries, DDP
    against the floor: PSPNet50 0.2704 / 0.1505 against 0.2635 / 0.1511;
    PSANet50 0.4110 / 0.2564 against 0.3992 / 0.2496, and with per-rank
    BN 0.3160 / 0.2213 against 0.2799 / 0.1885. The order of the sums
    sits at the floor; the bars ``DDP_BARS`` are about 1.5 times it. A
    gradient summed instead of averaged over the ranks would move every
    entry by its whole update (1.0)."""
    spec = _ddp_spec(arch, sync_bn)
    one = parity.one_process_steps(spec, 2)
    ranks = parity.ddp_steps(spec, 2, timeout_s=300)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for step, (got, want) in enumerate(zip(ranks[0]["losses"], one["losses"])):
        np.testing.assert_allclose(got, want, rtol=1e-5 if step == 0 else 5e-3,
                                   err_msg=f"step {step}")
    assert all(not any(c.values()) for r in ranks for c in r["launches"])  # CPU: plain ops
    assert sorted(ranks[0]["state"]) == sorted(one["state"])
    dist_ = parity.relative_distances(ranks[0]["state"], one["state"], one["init"])
    worst, median = max(dist_.values()), float(np.median(list(dist_.values())))
    assert len(dist_) > 300
    bar_max, bar_median = DDP_BARS[arch]
    assert worst <= bar_max and median <= bar_median, (max(dist_, key=dist_.get), worst,
                                                       median)
