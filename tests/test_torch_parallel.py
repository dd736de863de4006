"""The port's data-parallel training on the CPU, over 2-rank gloo groups
in spawned processes (``semseg_torch.parallel``): the synchronised and the
grouped BatchNorm against the JAX ``BatchNorm`` (output, running
statistics and the VJP), the collective helpers and the launcher, and the
training driver through its spawn entry point. The DDP train step is held
to one process in ``tests/test_torch_parallel_ddp.py``, and one process to
JAX in ``tests/test_torch_lockstep_replicas.py``. Inputs are made from seeds with numpy; JAX results are
materialised before any torch compute. Each rank runs two intra-op threads
(``OMP_NUM_THREADS``, which the spawned processes inherit)."""

import functools
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from driver_data import REPO, argv as _argv, cfg as _cfg, threads  # noqa: F401
from driver_data import write_dataset
from semseg_tpu.models.layers import BatchNorm as JBatchNorm
from semseg_torch import train
from semseg_torch.engine import checkpoint as ckpt
from semseg_torch.models.build import build_model
from semseg_torch.models.layers import BatchNorm2d, set_batchnorm_replicas
from semseg_torch.parallel import dist as pdist
from semseg_torch.utils.misc import find_free_port


@pytest.fixture(autouse=True)
def rank_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


# ------------------------------------------------------------- BatchNorm

BN_SHAPE = (4, 6, 5, 4)  # NHWC: two ranks or groups of two samples


def _bn_inputs(seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*BN_SHAPE) * 2 + 1).astype(np.float32)
    g = rs.randn(*BN_SHAPE).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, BN_SHAPE[-1]).astype(np.float32)
    bias = rs.randn(BN_SHAPE[-1]).astype(np.float32)
    return x, g, scale, bias


def _jax_bn(x, g, scale, bias, groups, dtype):
    """JAX ``BatchNorm(groups=...)`` in train mode: output, the VJP of the
    float32 output at ``g`` and the running statistics after the step."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    bn = JBatchNorm(groups=groups, dtype=jdt)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def f(p, xx):
        return bn.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                        use_running_average=False, mutable=["batch_stats"])

    xj = jnp.asarray(x).astype(jdt)
    y, upd = f(params, xj)
    _, pull = jax.vjp(lambda p, xx: f(p, xx)[0].astype(jnp.float32), params, xj)
    gp, gx = pull(jnp.asarray(g))
    return {k: np.asarray(t, np.float32) for k, t in (
        ("y", y), ("dx", gx), ("dscale", gp["scale"]), ("dbias", gp["bias"]),
        ("mean", upd["batch_stats"]["mean"]), ("var", upd["batch_stats"]["var"]))}


def _check_bn(got, want, dtype):
    """Output and running statistics within rtol = atol = 1e-5; the input,
    scale and bias gradients within 1e-5 of their largest magnitude. bf16
    activations: the output and the input gradient within one bf16 ulp of
    their scale (both sides round the same float32 values)."""
    for name in ("y", "mean", "var"):
        tol = 1e-5
        if dtype == "bf16" and name == "y":
            tol = 2.0 ** (np.floor(np.log2(np.abs(want[name]).max())) - 7)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=tol, err_msg=name)
    for name in ("dx", "dscale", "dbias"):
        scale = np.abs(want[name]).max()
        tol = 1e-5 * scale
        if dtype == "bf16" and name == "dx":
            tol = 2.0 ** (np.floor(np.log2(scale)) - 7)
        err = np.abs(got[name] - want[name]).max()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_synced_batchnorm_on_two_ranks_matches_jax(dtype):
    """The synchronised BatchNorm on 2 gloo ranks (each with 2 of the 4
    samples) against JAX ``BatchNorm`` (groups 1) on the whole batch: the
    outputs and the input gradients concatenated over the ranks, the scale
    and bias gradients summed over them (each rank returns its own, which
    DDP averages), the running statistics on every rank. Also the
    helpers: a flag raised on rank 1 alone reaches rank 0, rank 0's object
    reaches rank 1, sums and means in one collective, int64 exact."""
    x, g, scale, bias = _bn_inputs(1)
    want = _jax_bn(x, g, scale, bias, 1, dtype)
    ranks = pdist.spawn(torch_ranks.batchnorm_and_collectives, 2,
                        (f"tcp://127.0.0.1:{find_free_port()}", x, g, scale, bias, dtype),
                        timeout_s=120)
    got = {"y": np.concatenate([r["y"] for r in ranks]),
           "dx": np.concatenate([r["dx"] for r in ranks]),
           "dscale": ranks[0]["dscale"] + ranks[1]["dscale"],
           "dbias": ranks[0]["dbias"] + ranks[1]["dbias"]}
    for r in ranks:
        _check_bn({**got, "mean": r["mean"], "var": r["var"]}, want, dtype)
        assert r["tracked"] == 1 and r["world"] == 2
        assert r["any"] is True and r["object"] == {"from": 0}
        np.testing.assert_array_equal(r["sum"][0], [2.0])
        np.testing.assert_array_equal(r["sum"][1], [6, 2 ** 41 + 1])
        assert r["sum"][1].dtype == np.int64
        np.testing.assert_array_equal(r["avg"], [0.5, 0.5])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grouped_batchnorm_matches_jax(dtype):
    """``groups=2`` (one process, ``sync_bn: False`` over two replicas)
    against JAX ``BatchNorm(groups=2)``: per-group moments, running
    statistics from group 0 with its unbiased count; the same bars. A
    batch the groups do not divide raises."""
    x, g, scale, bias = _bn_inputs(2)
    want = _jax_bn(x, g, scale, bias, 2, dtype)
    bn = BatchNorm2d(BN_SHAPE[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    set_batchnorm_replicas(bn, groups=2)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).requires_grad_()
    y = bn(xt)
    assert y.dtype == tdt
    y.float().backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    got = {"y": y.float().permute(0, 2, 3, 1), "dx": xt.grad.float().permute(0, 2, 3, 1),
           "dscale": bn.weight.grad, "dbias": bn.bias.grad, "mean": bn.running_mean,
           "var": bn.running_var}
    _check_bn({k: v.detach().numpy() for k, v in got.items()}, want, dtype)
    with pytest.raises(ValueError, match="divisible"):
        bn(torch.zeros(3, BN_SHAPE[-1], 2, 2))
    with pytest.raises(ValueError, match="not both"):
        set_batchnorm_replicas(bn, groups=2, process_group=object())


def test_build_model_sets_the_batchnorm_form():
    """``sync_bn`` True: the whole batch's moments in one process, the
    group's over DDP ranks; False: per-replica groups in one process,
    each rank's own under DDP; a DDP rank's model holds one replica."""
    cfg = SimpleNamespace(arch="psp", layers=50, classes=3, zoom_factor=8, train_h=17,
                          train_w=17)
    group = object()  # stands for a process group: build_model only stores it

    def forms(sync_bn, **kw):
        cfg.sync_bn = sync_bn
        m = build_model(cfg, device="cpu", **kw)
        return {(b.groups, b.process_group) for b in m.modules() if isinstance(b, BatchNorm2d)}

    assert forms(True, replicas=2) == {(1, None)}
    assert forms(False, replicas=2) == {(2, None)}
    assert forms(True, process_group=group) == {(1, group)}
    assert forms(False, process_group=group) == {(1, None)}
    with pytest.raises(ValueError, match="one replica"):
        build_model(cfg, device="cpu", replicas=2, process_group=group)


# ------------------------------------------------------ process helpers


def test_ranks_config_and_backend():
    """Global ranks and the world from ``train_gpu``, ``world_size`` and
    ``rank``; the backend names; devices the machine lacks."""
    cfg = SimpleNamespace(train_gpu=[0, 1, 2], world_size=2, rank=1, dist_backend="xla",
                          dist_url="tcp://10.0.0.1:6789")
    assert pdist.local_processes(cfg) == 3 and pdist.world_size(cfg) == 6
    assert [pdist.global_rank(cfg, r) for r in range(3)] == [3, 4, 5]
    assert pdist.rendezvous_url(cfg) == "tcp://10.0.0.1:6789"
    one = SimpleNamespace(train_gpu=[0, 0], world_size=1, rank=0, dist_url="tcp://x:1")
    assert pdist.rendezvous_url(one).startswith("tcp://127.0.0.1:")
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        pdist.backend_name(cfg, "cpu")
    assert pdist.backend_name(SimpleNamespace(dist_backend="gloo"), "cpu") == "gloo"
    with pytest.raises(ValueError, match="dist_backend"):
        pdist.backend_name(SimpleNamespace(dist_backend="mpi"), "cpu")
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="no NCCL"):
            pdist.backend_name(cfg, "cuda")
    lacking = SimpleNamespace(train_gpu=[0, torch.cuda.device_count()])
    with pytest.raises(ValueError, match=r"train_gpu\[1\]"):
        pdist.rank_device(lacking, 1)


def test_nccl_needs_a_device_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = SimpleNamespace(train_gpu=[0, 0])
    with pytest.raises(ValueError, match="NCCL needs a device per rank"):
        pdist.check_devices(cfg, "nccl", "cuda")
    pdist.check_devices(cfg, "gloo", "cuda")
    assert pdist.rank_device(cfg, 1) == torch.device("cuda", 0)


def test_shard_batch():
    a = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(pdist.shard_batch(a, 1, 3), a[2:4])
    x, y = pdist.shard_batch((torch.arange(4), np.arange(4)), 1, 2)
    assert x.tolist() == [2, 3] and y.tolist() == [2, 3]
    with pytest.raises(ValueError, match="divisible"):
        pdist.shard_batch(a, 0, 4)


def test_spawn_returns_by_rank_and_fails_with_a_rank():
    """Results come back by local rank (no deadline); a rank that raises
    fails the call at once with its error (the other is stopped); so does
    a deadline."""
    out = pdist.spawn(torch_ranks.returns_rank, 2, (2.0,), timeout_s=None)
    np.testing.assert_array_equal(out[1], [2.0, 2.0, 2.0])
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        pdist.spawn(torch_ranks.fails_on_rank_one, 2, timeout_s=60)
    with pytest.raises(TimeoutError):
        pdist.spawn(torch_ranks.sleeps, 1, timeout_s=1)


# --------------------------------------------------------------- driver

# Run by the module fixture in a fresh interpreter whose path shadows jax,
# jaxlib, flax and semseg_tpu with packages that raise when imported: the
# spawned ranks, which inherit the path, must not import them either.
_SPAWN_SCRIPT = """
import json, sys
from semseg_torch.train import parse_args, spawn
out = spawn(parse_args(sys.argv[1:]), "cpu", timeout_s=300)
print("RESULT", json.dumps([{k: r[k] for k in ("rank", "steps", "checkpoints", "preempt",
                                               "val")} for r in out]))
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "flax", "semseg_tpu")))
"""
TWO_RANKS = ("train_gpu", "[0, 0]", "dist_backend", "gloo", "batch_size", "4")


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """8 images, global batch 4 over 2 ranks (2 steps an epoch), 2 epochs,
    dropout on, validation after each epoch (3 images, global batch 2),
    through ``spawn`` in a fresh process."""
    root = tmp_path_factory.mktemp("ranks")
    write_dataset(root, n=8)
    shadow = root / "shadow"
    for name in ("jax", "jaxlib", "flax", "semseg_tpu"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(f"raise ImportError('{name} imported')\n")
    env = dict(os.environ, PYTHONPATH=f"{shadow}{os.pathsep}{REPO}", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", _SPAWN_SCRIPT,
                           *_argv(root, *TWO_RANKS, "evaluate", "True")],
                          capture_output=True, text=True, cwd=str(root), env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, proc


def test_spawned_ranks_train_and_rank_zero_alone_writes(two_rank_run):
    """Both ranks take the 4 steps and report the same validation (their
    shards' sums all-reduced); no process imported jax, flax or
    ``semseg_tpu``; rank 0 alone logs (4 step lines, 2 saves, 2
    validations), writes the scalars (one writer's 32 lines) and the two
    epoch files."""
    import json

    root, proc = two_rank_run
    lines = proc.stdout.splitlines()
    result = json.loads([ln for ln in lines if ln.startswith("RESULT")][0][len("RESULT "):])
    assert [(r["rank"], r["steps"], r["preempt"]) for r in result] == [(0, 4, None),
                                                                       (1, 4, None)]
    assert result[0]["checkpoints"] == result[1]["checkpoints"]
    assert result[0]["val"] == result[1]["val"] and len(result[0]["val"]) == 2
    assert all(np.isfinite(v) for val in result[0]["val"] for v in val.values())
    assert "LOADED []" in lines
    assert proc.stderr.count("MainLoss") == 4
    assert proc.stderr.count("Saving checkpoint to") == 2
    assert proc.stderr.count("Val result: mIoU/mAcc/allAcc") == 2
    exp = root / "exp"
    assert sorted(os.listdir(exp)) == ["scalars.jsonl", "train_epoch_1.pth", "train_epoch_2.pth"]
    assert len((exp / "scalars.jsonl").read_text().splitlines()) == 4 * 4 + 2 * 4 + 2 * 4


def test_two_rank_checkpoint_loads_into_one_process_model(two_rank_run):
    """The epoch file holds the model's own state_dict names (no DDP
    ``module.``), the optimizer and the step; it loads strictly into a
    one-process model and into a one-process Trainer."""
    root, _ = two_rank_run
    payload = ckpt.load_checkpoint(str(root / "exp" / "train_epoch_2.pth"))
    assert (payload["epoch"], payload["step"]) == (2, 4)
    cfg = _cfg(root, *TWO_RANKS)
    model = build_model(cfg, device="cpu", train=True)
    assert sorted(payload["state_dict"]) == sorted(model.state_dict())
    model.load_state_dict(payload["state_dict"], strict=True)
    assert not any(k.startswith("module.") for k in payload["state_dict"])


def test_two_rank_preemption_resumes_exactly(two_rank_run, capfd):
    """Stopped by the preemption hook after global step 3, both ranks stop
    at that step and rank 0 writes the snapshot; ``resume auto`` (resolved
    on rank 0) on 2 ranks ends bit for bit where the uninterrupted 2-rank
    run ends: weights, BN statistics, momentum and step."""
    root, _ = two_rank_run
    save = str(root / "pre")
    pre = train.spawn(_cfg(root, *TWO_RANKS, "save_path", save, _preempt_after_step=3), "cpu",
                      timeout_s=300)
    assert [(r["steps"], r["preempt"]) for r in pre] == [(3, os.path.join(save,
                                                                          "train_preempt.pth"))] * 2
    assert ckpt.load_checkpoint(pre[0]["preempt"])["step"] == 3
    res = train.spawn(_cfg(root, *TWO_RANKS, "save_path", save, "resume", "auto"), "cpu",
                      timeout_s=300)
    assert [r["steps"] for r in res] == [4, 4]
    assert sorted(os.listdir(save)) == ["scalars.jsonl", "train_epoch_1.pth",
                                        "train_epoch_2.pth"]
    got = ckpt.load_checkpoint(os.path.join(save, "train_epoch_2.pth"))
    want = ckpt.load_checkpoint(str(root / "exp" / "train_epoch_2.pth"))
    assert got["step"] == want["step"] == 4
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    for k, v in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][k]["momentum_buffer"],
                           v["momentum_buffer"]), k
    assert "mid-epoch resume: skipping 1 consumed batches of epoch 2" in capfd.readouterr().err


# The launcher of a signalled run: ``spawn`` in a fresh interpreter, whose
# rank 1 sends SIGTERM to this process after global step 1.
_SIGNAL_SCRIPT = """
import functools, json, sys
sys.path.insert(0, sys.argv[1])
import torch_ranks
from semseg_torch.train import parse_args, spawn
out = spawn(parse_args(sys.argv[2:]), "cpu", timeout_s=300,
            step_hook=functools.partial(torch_ranks.signal_after, 1, "launcher"))
print("RESULT", json.dumps([[r["steps"], r["preempt"]] for r in out]))
"""


@pytest.mark.parametrize("target", ["launcher", "one_rank"])
def test_two_rank_signal_preempts_every_rank(two_rank_run, target):
    """A real SIGTERM after global step 1, sent by rank 1 to the launching
    process (which passes it on to both ranks) or to rank 1 alone (whose
    flag reaches rank 0 through the step boundary's all-reduce): both ranks
    stop after step 1, rank 0 writes the snapshot, and ``resume auto`` on 2
    ranks ends bit for bit where the uninterrupted 2-rank run ends."""
    root, _ = two_rank_run
    save = str(root / f"signal_{target}")
    try:
        _signal_and_resume(root, save, target)
    finally:
        shutil.rmtree(save, ignore_errors=True)  # the snapshot and two epoch files


def _signal_and_resume(root, save, target):
    import json

    if target == "launcher":
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        proc = subprocess.run(
            [sys.executable, "-c", _SIGNAL_SCRIPT, os.path.dirname(__file__),
             *_argv(root, *TWO_RANKS, "save_path", save)],
            capture_output=True, text=True, cwd=str(root), env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][0]
        stops = [tuple(r) for r in json.loads(line[len("RESULT "):])]
        assert "received signal" in proc.stderr
    else:
        pre = train.spawn(_cfg(root, *TWO_RANKS, "save_path", save), "cpu", timeout_s=300,
                          step_hook=functools.partial(torch_ranks.signal_after, 1, "self"))
        stops = [(r["steps"], r["preempt"]) for r in pre]
    snapshot = os.path.join(save, "train_preempt.pth")
    assert stops == [(1, snapshot)] * 2
    assert ckpt.load_checkpoint(snapshot)["step"] == 1
    res = train.spawn(_cfg(root, *TWO_RANKS, "save_path", save, "resume", "auto"), "cpu",
                      timeout_s=300)
    assert [r["steps"] for r in res] == [4, 4]
    got = ckpt.load_checkpoint(os.path.join(save, "train_epoch_2.pth"))
    want = ckpt.load_checkpoint(str(root / "exp" / "train_epoch_2.pth"))
    assert got["step"] == want["step"] == 4
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    for k, v in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][k]["momentum_buffer"],
                           v["momentum_buffer"]), k


# One node's launcher of a two-node run: ``spawn`` with the node's rank.
_NODE_SCRIPT = """
import json, sys
from semseg_torch.train import parse_args, spawn
out = spawn(parse_args(sys.argv[1:]), "cpu", timeout_s=120)
print("RESULT", json.dumps([[r["rank"], r["steps"]] for r in out]))
"""


def test_two_node_rendezvous_matches_one_node(two_rank_run):
    """Two launchers, one process each (``world_size 2``, node ``rank`` 0
    and 1, ``train_gpu [0]``), meet at a localhost ``dist_url`` over gloo
    (``parallel/dist.py::rendezvous_url`` takes the url only for several
    nodes): global ranks 0 and 1 take the 4 steps, node 0 alone writes
    the epoch files, and the final weights, BN statistics and momentum
    equal the one-node two-rank run's bit for bit."""
    import json

    root, _ = two_rank_run
    save = root / "two_nodes"
    url = f"tcp://127.0.0.1:{find_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NODE_SCRIPT,
         *_argv(root, "train_gpu", "[0]", "world_size", "2", "rank", str(node), "dist_url", url,
                "dist_backend", "gloo", "batch_size", "4", "save_path", str(save))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(root), env=env)
        for node in (0, 1)]
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    results = [json.loads([ln for ln in out.splitlines()
                           if ln.startswith("RESULT")][0][len("RESULT "):]) for out, _ in outs]
    assert results == [[[0, 4]], [[1, 4]]]
    assert sorted(os.listdir(save)) == ["scalars.jsonl", "train_epoch_1.pth",
                                        "train_epoch_2.pth"]
    got = ckpt.load_checkpoint(str(save / "train_epoch_2.pth"))
    want = ckpt.load_checkpoint(str(root / "exp" / "train_epoch_2.pth"))
    assert got["step"] == want["step"] == 4
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    for k, v in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][k]["momentum_buffer"],
                           v["momentum_buffer"]), k
    shutil.rmtree(save, ignore_errors=True)


def test_spawn_refuses_before_starting_ranks(tmp_path):
    """A global batch the ranks do not divide, a device the machine lacks
    and an NCCL run on the CPU raise before any rank starts; a rank's
    loader takes its shard at its share of the batch."""
    write_dataset(tmp_path, n=4)
    with pytest.raises(ValueError, match="batch_size 3 not divisible by 2 ranks"):
        train.spawn(_cfg(tmp_path, *TWO_RANKS[:4], "batch_size", "3"), "cpu")
    with pytest.raises(ValueError, match="batch_size_val 3 not divisible"):
        train.spawn(_cfg(tmp_path, *TWO_RANKS, "evaluate", "True", "batch_size_val", "3"),
                    "cpu")
    with pytest.raises(ValueError, match="train_gpu"):
        train.spawn(_cfg(tmp_path, *TWO_RANKS[:4], "train_gpu",
                         f"[0, {torch.cuda.device_count()}]"), "cuda")
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        train.spawn(_cfg(tmp_path, "train_gpu", "[0, 0]", "batch_size", "4"), "cpu")
    loader, _ = train.build_train_loader(_cfg(tmp_path, *TWO_RANKS), rank=1, world=2)
    assert loader.batch_size == 2 and loader.sampler.shard_index == 1
    assert loader.sampler.num_shards == 2
