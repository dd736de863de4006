"""The port's tensor-parallel training on the CPU (``model_parallel``,
``semseg_torch/parallel/tensor.py``): gloo ranks in spawned processes, two
intra-op threads each (``OMP_NUM_THREADS``, which they inherit), as in
this process.

- The train step on a ``data x model`` grid of ranks against the
  one-process ``Trainer(num_replicas=data)``
  (``semseg_torch.parallel.parity``); ``tests/test_torch_lockstep_replicas.py``
  and ``tests/test_torch_train.py`` hold that Trainer to JAX's
  ``make_train_step``, whose TP step JAX's own slow test holds to the
  unsharded one (``tests/test_parallel.py::test_tp_step_matches_unsharded_step``).
- The PSA module at an odd attention width (289 channels, split 145 / 144)
  against the unsharded module, forward and backward.
- The driver through ``semseg_torch.train.spawn`` with ``model_parallel
  2``: training, validation, one full checkpoint, exact resume.

Inputs are made from seeds with numpy."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ranks
from driver_data import REPO, argv as _argv, cfg as _cfg, threads  # noqa: F401
from driver_data import write_dataset
from semseg_torch import train
from semseg_torch.engine import checkpoint as ckpt
from semseg_torch.utils.misc import find_free_port
from semseg_torch.engine.optim import param_groups
from semseg_torch.models.build import build_model
from semseg_torch.parallel import dist as pdist
from semseg_torch.parallel import parity
from test_torch_parallel_ddp import _ddp_spec


@pytest.fixture(autouse=True)
def rank_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


# (arch, world, model_parallel, sync_bn): 1 x 2 and 2 x 2 grids.
TP_CASES = [("psp", 2, 2, True), ("psa", 2, 2, True), ("psa", 4, 2, True),
            ("psa", 4, 2, False)]
# The largest relative distance to the one-process run (the L2 distance of
# a state entry over the L2 change the one-process run made) after two
# steps, and its median over the entries, by case; see the test.
TP_BARS = {("psp", 1): (0.05, 0.03), ("psa", 1): (0.07, 0.04), ("psa", 2, True): (0.6, 0.38),
           ("psa", 2, False): (0.45, 0.3)}


def _bar(arch, data, sync_bn):
    return TP_BARS[(arch, data)] if data == 1 else TP_BARS[(arch, data, sync_bn)]


@pytest.mark.parametrize("arch,world,model_parallel,sync_bn", TP_CASES,
                         ids=["psp-1x2", "psa-1x2", "psa-2x2-sync_bn", "psa-2x2-replica_bn"])
def test_tp_matches_one_process(arch, world, model_parallel, sync_bn):
    """Two f32 steps on a ``world / model_parallel`` x ``model_parallel``
    grid of gloo ranks (each TP group on its slice of the global batch of
    4, the head's wide layers split by output channel) against the
    one-process ``Trainer(num_replicas=world / model_parallel)`` from the
    same seeded weights. The losses are equal on every rank (TP peers
    compute the same replicated layers on gathered channels) and agree
    with one process within 1e-5 relative at step 0 and 5e-3 at step 1.

    The full state, gathered on rank 0, is held to the one-process run by
    the relative L2 distance of each entry over the change the one-process
    run made, against bars from the one-ulp floor (the one-process run
    against itself with every image moved by one float32 ulp), measured by
    ``chip_probes/tp_floor.py`` on the CPU, 2 threads a process, max /
    median over the entries, TP against the floor: PSPNet50 1 x 2 0.0177 /
    0.0046 against 0.2824 / 0.1692; PSANet50 1 x 2 0.0224 / 0.0073
    against 0.3582 / 0.2207; 2 x 2 0.4118 / 0.2556 against 0.3992 /
    0.2496, and with per-rank BN 0.3159 / 0.2214 against 0.2799 / 0.1885.
    At 1 x 2 the sums run in another order only in the sharded head, a
    sixteenth of the floor or less: the bars ``TP_BARS`` are a fifth of
    the floor, and a head computing another function (a wrong channel
    order, a missing all-reduce) moves its entries by their whole update
    (1.0). At 2 x 2 DDP's order of the sums sits at the floor, as in
    ``tests/test_torch_parallel_ddp.py``: the bars are about 1.5 times it."""
    spec = _ddp_spec(arch, sync_bn)  # 49x49 crops, 5 classes, batch 4, two f32 steps
    data = world // model_parallel
    one = parity.one_process_steps(spec, data)
    ranks = parity.tp_steps(spec, world, model_parallel, timeout_s=300)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    for step, (got, want) in enumerate(zip(ranks[0]["losses"], one["losses"])):
        np.testing.assert_allclose(got, want, rtol=1e-5 if step == 0 else 5e-3,
                                   err_msg=f"step {step}")
    assert all(not any(c.values()) for r in ranks for c in r["launches"])  # CPU: plain ops
    assert sorted(ranks[0]["state"]) == sorted(one["state"])
    assert all(ranks[0]["state"][k].shape == v.shape for k, v in one["state"].items())
    dist_ = parity.relative_distances(ranks[0]["state"], one["state"], one["init"])
    worst, median = max(dist_.values()), float(np.median(list(dist_.values())))
    bar_max, bar_median = _bar(arch, data, sync_bn)
    assert worst <= bar_max and median <= bar_median, (max(dist_, key=dist_.get), worst,
                                                       median)


def test_psa_module_with_an_odd_attention_width():
    """The PSA module at a 17x17 feature map, shrink 2, a 17x17 mask: the
    attention logits conv has 289 output channels, split 145 / 144 over 2
    ranks and gathered unevenly. Each rank's sharded module, on the same
    input in train mode, against the unsharded module (built from the same
    seed): output within 1e-5 and input gradient within 1e-4 of max|whole|
    (the sharded head sums its channels' products in other orders: the
    input gradient all-reduced over the ranks), and every parameter's
    gradient (the rank's shard of a sharded one) within 1e-4 of its max."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 2048, 17, 17).astype(np.float32)
    cot = rs.randn(2, 4096, 17, 17).astype(np.float32)
    out = pdist.spawn(torch_ranks.tp_psa_module, 2,
                      (f"tcp://127.0.0.1:{find_free_port()}", x, cot), timeout_s=300)
    for r, res in enumerate(out):
        assert res["sizes"] == [145, 144]
        for key, rtol in (("y", 1e-5), ("dx", 1e-4)):
            want, got = res["whole"][key], res["tp"][key]
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= rtol * scale, (r, key)
        assert len(res["grads"]) == 17
        for name, (got, want) in res["grads"].items():
            assert got.shape == want.shape, name
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-12, (r, name)
    np.testing.assert_array_equal(out[0]["tp"]["y"], out[1]["tp"]["y"])
    np.testing.assert_array_equal(out[0]["tp"]["dx"], out[1]["tp"]["dx"])


# --------------------------------------------------------------- driver

# Run by the module fixture in a fresh interpreter whose path shadows jax,
# jaxlib, flax and semseg_tpu with packages that raise when imported: the
# spawned ranks, which inherit the path, must not import them either.
_SPAWN_SCRIPT = """
import json, sys
import semseg_torch.parallel.tensor
from semseg_torch.train import parse_args, spawn
out = spawn(parse_args(sys.argv[1:]), "cpu", timeout_s=300)
print("RESULT", json.dumps([{k: r[k] for k in ("rank", "steps", "checkpoints", "val")}
                            for r in out]))
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "flax", "semseg_tpu")))
"""
TP_RANKS = ("train_gpu", "[0, 0]", "dist_backend", "gloo", "model_parallel", "2", "epochs", "1")


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """4 images, global batch 2 (both TP ranks load the same 2: one data
    rank), 2 steps, dropout on, validation (3 images, global batch 2),
    through ``spawn`` with ``model_parallel 2`` in a fresh process."""
    root = tmp_path_factory.mktemp("tp")
    write_dataset(root, n=4)
    shadow = root / "shadow"
    for name in ("jax", "jaxlib", "flax", "semseg_tpu"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(f"raise ImportError('{name} imported')\n")
    env = dict(os.environ, PYTHONPATH=f"{shadow}{os.pathsep}{REPO}", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _SPAWN_SCRIPT,
                           *_argv(root, *TP_RANKS, "evaluate", "True")],
                          capture_output=True, text=True, cwd=str(root), env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, proc


def test_tp_driver_trains_and_writes_a_full_checkpoint(tp_run):
    """Both ranks take the 2 steps and report the same validation; no
    process imported jax, flax or ``semseg_tpu`` (``semseg_torch.parallel.
    tensor`` and the TP spawn path included); rank 0 alone logs and writes
    one epoch file, which holds the full, unsharded state (weights, BN
    statistics and momentum) and loads strictly into a one-process model."""
    import json

    root, proc = tp_run
    lines = proc.stdout.splitlines()
    result = json.loads([ln for ln in lines if ln.startswith("RESULT")][0][len("RESULT "):])
    assert [(r["rank"], r["steps"]) for r in result] == [(0, 2), (1, 2)]
    assert result[0]["val"] == result[1]["val"] and len(result[0]["val"]) == 1
    assert "LOADED []" in lines
    assert "data x model = 1 x 2" in proc.stderr
    assert proc.stderr.count("MainLoss") == 2 and proc.stderr.count("Saving checkpoint to") == 1
    assert sorted(os.listdir(root / "exp")) == ["scalars.jsonl", "train_epoch_1.pth"]
    payload = ckpt.load_checkpoint(str(root / "exp" / "train_epoch_1.pth"))
    assert payload["step"] == 2
    model = build_model(_cfg(root, *TP_RANKS), device="cpu", train=True)
    model.load_state_dict(payload["state_dict"], strict=True)
    assert payload["state_dict"]["psa.reduce.0.weight"].shape[0] == 512
    momentum = payload["optimizer"]["state"]
    params = [p for g in param_groups(model, 0.01) for p in g["params"]]  # the SGD's order
    assert len(momentum) == len(params)
    for p, entry in zip(params, momentum.values()):
        assert entry["momentum_buffer"].shape == p.shape


def test_tp_driver_resumes_exactly(tp_run):
    """Stopped by the preemption hook after step 1, rank 0 writes a full
    snapshot; ``resume auto`` on the 2 TP ranks shards it again and ends
    bit for bit where the uninterrupted run ends (weights, BN statistics,
    momentum, step). A one-process checkpoint resumes under TP too."""
    root, _ = tp_run
    save = str(root / "pre")
    pre = train.spawn(_cfg(root, *TP_RANKS, "save_path", save, _preempt_after_step=1), "cpu",
                      timeout_s=300)
    assert [(r["steps"], r["preempt"]) for r in pre] == [(1, os.path.join(
        save, "train_preempt.pth"))] * 2
    snap = ckpt.load_checkpoint(pre[0]["preempt"])
    assert snap["step"] == 1 and snap["state_dict"]["psa.proj.0.weight"].shape[0] == 2048
    res = train.spawn(_cfg(root, *TP_RANKS, "save_path", save, "resume", "auto"), "cpu",
                      timeout_s=300)
    assert [r["steps"] for r in res] == [2, 2]
    got = ckpt.load_checkpoint(os.path.join(save, "train_epoch_1.pth"))
    want = ckpt.load_checkpoint(str(root / "exp" / "train_epoch_1.pth"))
    assert got["step"] == want["step"] == 2
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    for k, v in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][k]["momentum_buffer"],
                           v["momentum_buffer"]), k
    # The TP run's epoch file, resumed by one process for a second epoch,
    # and that one-process file resumed by the TP ranks for a third.
    one = str(root / "one")
    cfg = _cfg(root, "save_path", one, "epochs", "2", "resume",
               str(root / "exp" / "train_epoch_1.pth"))
    assert train.run(cfg, "cpu")["trainer"].step_count == 4
    back = train.spawn(_cfg(root, *TP_RANKS, "save_path", one, "epochs", "3", "resume", "auto"),
                       "cpu", timeout_s=300)
    assert [r["steps"] for r in back] == [6, 6]
    assert ckpt.load_checkpoint(os.path.join(one, "train_epoch_3.pth"))["step"] == 6
