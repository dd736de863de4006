"""The port's convergence tool (``semseg_torch/convergence.py``) against the
JAX package's (``tool/convergence.py``), on the CPU, without compiling a
JAX train step.

The JAX tool's ``run`` is driven with recorders in place of
``create_train_state``, ``make_train_step`` and ``make_eval_step`` (module
attributes of ``semseg_tpu.engine.trainer``, patched for the test only):
what it hands them is its recipe, and the batches its fake steps receive
are its data order. The port's ``run`` is driven the same way and must
hand over the same. Then the port's own pieces: the coupled arms (one
init, one dropout mask stream), its validation mIoU against
``make_eval_step`` + ``summarize`` from JAX-initialised weights, a short
PSANet50 run, and a fresh process that loads no JAX.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semseg_tpu.engine.trainer as jtrainer
from semseg_torch import convergence as conv
from semseg_torch.models import layers

REPO = Path(__file__).resolve().parents[1]


class _Stop(Exception):
    """Raised by a recorder once it has what the test needs."""


@pytest.fixture(autouse=True, scope="module")
def threads():
    """Two intra-op threads: the suite runs in several pytest workers that
    share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tool():
    """``tool/convergence.py`` as a module (``tool/`` is not a package)."""
    spec = importlib.util.spec_from_file_location("jax_tool_convergence",
                                                  REPO / "tool" / "convergence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    """A small train set (the index stream draws from its length) and one
    validation batch."""
    return conv.make_dataset(0, 16), conv.make_dataset(1, 8)


@pytest.mark.parametrize("seed,n", [(0, 16), (1, 8)])
def test_dataset_is_the_jax_tools(jax_tool, seed, n):
    """``make_dataset`` is a copy: byte-identical images and labels."""
    got, want = conv.make_dataset(seed, n), jax_tool.make_dataset(seed, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("arch", ["psp", "psa"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_recipe_matches_the_jax_tool(jax_tool, data, monkeypatch, arch, dtype_name):
    """The model, init, train-step and eval-step arguments of the JAX
    tool's ``run`` (``CONVERGENCE_ARCH`` selects its arch) against what the
    port's ``run`` hands to ``build_model``, ``make_sgd`` (SGD over
    ``optim.param_groups``) and ``Trainer``."""
    from semseg_tpu.engine.optim import NEW_MODULE_PREFIXES as JAX_PREFIXES
    from semseg_torch.engine.optim import NEW_MODULE_PREFIXES
    from semseg_torch.models.build import derive_psa_mask_dims

    jax_rec = {}

    def create_train_state(model, rng, sample_input):
        jax_rec.update(model=model, rng=np.asarray(rng), sample_shape=sample_input.shape)
        return SimpleNamespace(params={}, batch_stats={})

    def make_train_step(model, **kw):
        jax_rec["train"] = kw
        return None

    def make_eval_step(model, **kw):
        jax_rec["eval"] = kw
        raise _Stop

    monkeypatch.setattr(jtrainer, "create_train_state", create_train_state)
    monkeypatch.setattr(jtrainer, "make_train_step", make_train_step)
    monkeypatch.setattr(jtrainer, "make_eval_step", make_eval_step)
    monkeypatch.setenv("CONVERGENCE_ARCH", arch)
    with pytest.raises(_Stop):
        jax_tool.run(dtype_name, 3, *data)

    port_rec = {"builds": []}
    real_build, real_sgd = conv.build_model, conv.make_sgd

    def build_model(cfg, dtype, device, seed, train):
        port_rec["builds"].append((cfg, dtype, seed, train))
        return real_build(cfg, dtype=dtype, device=device, seed=seed, train=train)

    def make_sgd(model, base_lr, momentum, weight_decay):
        port_rec["sgd"] = (base_lr, momentum, weight_decay)
        port_rec["optimizer"] = opt = real_sgd(model, base_lr, momentum, weight_decay)
        port_rec["new"] = {n.split(".")[0] for n, p in model.named_parameters()
                           if any(p is q for q in opt.param_groups[1]["params"])}
        return opt

    def trainer(model, optimizer, **kw):
        port_rec["trainer"] = kw
        raise _Stop

    monkeypatch.setattr(conv, "build_model", build_model)
    monkeypatch.setattr(conv, "make_sgd", make_sgd)
    monkeypatch.setattr(conv, "Trainer", trainer)
    with pytest.raises(_Stop):
        conv.run(dtype_name, 3, *data, arch=arch, device="cpu")

    # The model: the f32 init, then the arm's dtype, both from seed 0.
    jmodel = jax_rec["model"]
    (init_cfg, init_dtype, init_seed, _), (cfg, dtype, seed, train) = port_rec["builds"]
    assert init_dtype == torch.float32 and init_cfg == cfg and train
    assert type(jmodel).__name__ == {"psp": "PSPNet", "psa": "PSANet"}[cfg.arch]
    fields = ["layers", "classes", "zoom_factor"]
    if arch == "psa":
        fields += ["psa_type", "compact", "shrink_factor", "mask_h", "mask_w",
                   "normalization_factor", "psa_softmax"]
        assert derive_psa_mask_dims(cfg) == (jmodel.mask_h, jmodel.mask_w) == (13, 13)
    for f in fields:
        assert getattr(cfg, f) == getattr(jmodel, f), f
    assert str(dtype).split(".")[-1] == jnp.dtype(jmodel.dtype).name == dtype_name
    assert init_seed == seed == 0
    np.testing.assert_array_equal(jax_rec["rng"], np.asarray(jax.random.PRNGKey(0)))
    assert jax_rec["sample_shape"] == (conv.BATCH, conv.CROP, conv.CROP, 3)

    # The train step: SGD with the 10x head group, the loss, the schedule.
    jt, pt = jax_rec["train"], port_rec["trainer"]
    assert port_rec["sgd"] == (jt["base_lr"], jt["momentum"], jt["weight_decay"])
    assert [g["lr_mult"] for g in port_rec["optimizer"].param_groups] == [1.0, 10.0]
    assert NEW_MODULE_PREFIXES == JAX_PREFIXES
    assert port_rec["new"] == {"ppm" if arch == "psp" else "psa", "cls", "aux"}
    for k in ("classes", "ignore_label", "aux_weight", "base_lr", "max_iter", "power",
              "zoom_factor", "num_replicas", "rng_seed"):
        assert pt[k] == jt[k], k
    assert [list(v) for v in pt["normalize"]] == [list(v) for v in jt["normalize"]]
    assert jt["max_iter"] == 3 and jt["rng_seed"] == 0

    # The eval step's arguments are the module constants val_miou passes.
    je = jax_rec["eval"]
    assert (conv.CLASSES, conv.IGNORE_LABEL, conv.ZOOM) == (
        je["classes"], je["ignore_label"], je["zoom_factor"])
    assert [list(v) for v in conv.NORMALIZE] == [list(v) for v in je["normalize"]]


@pytest.mark.parametrize("stream_offset", [0, 7919])
def test_batch_and_eval_order_match_the_jax_tool(jax_tool, data, monkeypatch, capsys,
                                                  stream_offset):
    """Both tools' loops, with fake steps, over 5 steps with an eval every
    2: the same training batches in the same order (the index stream
    ``RandomState(seed + 1 + stream_offset)``), evals after steps 2, 4
    and 5, each over the validation set in batches of 8 in order, and one
    printed line per eval with the JAX tool's keys. The port's arm trains
    with cuDNN's deterministic flag on, and ``run`` restores it."""
    train_set, val_set = data
    key = {img.tobytes(): i for i, img in enumerate(train_set[0])}

    def recorder():
        return {"train": [], "eval": []}

    jrec, prec = recorder(), recorder()

    def jax_step(state, images, labels):
        jrec["train"].append([key[im.tobytes()] for im in np.asarray(images)])
        return state, {"loss": 0.0}

    def jax_eval(variables, images, labels):
        jrec["eval"].append(np.asarray(labels).copy())
        return {k: np.zeros(conv.CLASSES, np.int64) for k in ("intersection", "union",
                                                              "target")}

    monkeypatch.setattr(jtrainer, "create_train_state",
                        lambda *a: SimpleNamespace(params={}, batch_stats={}))
    monkeypatch.setattr(jtrainer, "make_train_step", lambda model, **kw: jax_step)
    monkeypatch.setattr(jtrainer, "make_eval_step", lambda model, **kw: jax_eval)
    monkeypatch.setattr(jax_tool, "EVAL_EVERY", 2)
    monkeypatch.delenv("CONVERGENCE_ARCH", raising=False)
    jax_traj = jax_tool.run("float32", 5, train_set, val_set, stream_offset=stream_offset)
    jax_lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]

    class FakeTrainer:
        module = torch.nn.Identity()

        def step(self, images, labels):
            prec["train"].append([key[im.tobytes()] for im in images.numpy()])
            prec["deterministic"] = torch.backends.cudnn.deterministic
            return {"loss": torch.tensor(0.0)}

    def port_eval(model, images, labels, **kw):
        prec["eval"].append(labels.numpy().copy())
        return {k: torch.zeros(conv.CLASSES, dtype=torch.int64)
                for k in ("intersection", "union", "target")}

    arm = {}
    monkeypatch.setattr(conv, "build_arm", lambda *a, **kw: arm.update(kw) or FakeTrainer())
    monkeypatch.setattr(conv, "eval_step", port_eval)
    monkeypatch.setattr(conv, "EVAL_EVERY", 2)
    port_traj = conv.run("float32", 5, train_set, val_set, stream_offset=stream_offset,
                         device="cpu")
    port_lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]

    assert arm["stream_offset"] == stream_offset and arm["seed"] == 0
    # cuDNN's deterministic algorithms while the arm trains, the flag restored after.
    assert prec["deterministic"] and not torch.backends.cudnn.deterministic
    assert len(prec["train"]) == 5 and prec["train"] == jrec["train"]
    assert port_traj == jax_traj and [s for s, _ in port_traj] == [2, 4, 5]
    assert len(prec["eval"]) == len(jrec["eval"]) == 3
    for got, want in zip(prec["eval"], jrec["eval"]):
        np.testing.assert_array_equal(got, want)
    assert [sorted(ln) for ln in port_lines] == [sorted(ln) for ln in jax_lines]
    assert [ln["step"] for ln in port_lines] == [2, 4, 5]


@pytest.fixture(scope="module")
def arms():
    """Both PSPNet50 arms as ``run`` builds them (seed 0, CPU), with copies
    of their initial state."""
    trainers = {name: conv.build_arm(name, 3, device="cpu")
                for name in ("float32", "bfloat16")}
    initial = {name: {k: v.clone() for k, v in t.module.state_dict().items()}
               for name, t in trainers.items()}
    return trainers, initial


def test_arms_start_from_one_float32_init(arms):
    """The bf16 arm's model holds the float32 init bit for bit (parameters
    and BatchNorm buffers, float32 in both); the float32 arm's build left
    TF32 off (process-wide flags, the bf16 build leaves them alone)."""
    trainers, initial = arms
    f32, bf16 = initial["float32"], initial["bfloat16"]
    assert list(f32) == list(bf16)
    for k in f32:
        assert f32[k].dtype == bf16[k].dtype and torch.equal(f32[k], bf16[k]), k
    assert f32["cls.4.weight"].dtype == torch.float32
    assert trainers["bfloat16"].module.dtype == torch.bfloat16
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    other = conv.initial_state("psp", 1, "cpu")
    assert not torch.equal(other["cls.4.weight"], f32["cls.4.weight"])


def test_arms_draw_the_same_dropout_masks(arms, data, monkeypatch):
    """Steps 0-2 of both arms (batch 2 of the training images): every
    ``Dropout2d`` draws the same channel mask in both, the one it applies
    (re-drawn from the generator state it started from), new at each step."""
    trainers, _ = arms
    train_set, _ = data
    forward = layers.Dropout2d.forward
    masks = []

    def recording(self, x):
        state = self.generator.get_state()
        out = forward(self, x)
        g = torch.Generator(device=x.device)
        g.set_state(state)
        keep = torch.rand(x.shape[0], x.shape[1], 1, 1, generator=g) >= self.p
        assert torch.equal(out, x * (keep.to(x.dtype) / (1.0 - self.p)))
        masks.append(keep.flatten())
        return out

    monkeypatch.setattr(layers.Dropout2d, "forward", recording)
    drawn = {}
    for name, t in trainers.items():
        masks.clear()
        for k in range(3):
            metrics = t.step(torch.from_numpy(train_set[0][2 * k:2 * k + 2]),
                             torch.from_numpy(train_set[1][2 * k:2 * k + 2]))
            assert np.isfinite(metrics["loss"].item())
        drawn[name] = list(masks)
    assert len(drawn["float32"]) == 6  # cls and aux heads, 3 steps
    for a, b in zip(drawn["float32"], drawn["bfloat16"]):
        assert torch.equal(a, b)
    cls = drawn["float32"][0::2]
    assert not torch.equal(cls[0], cls[1]) and 0 < (~cls[0]).sum() < cls[0].numel()


def test_val_miou_matches_jax_from_jax_weights(data):
    """PSPNet50 (6 classes, 97x97) with JAX-initialised weights loaded
    through ``state_dict_from_jax``: the port's ``val_miou`` over 8
    validation images against ``make_eval_step`` + ``summarize`` over the
    same. mIoU within 1e-3 and each histogram within 0.1 % of the 75272
    pixels. Measured on this CPU path: mIoU 0.07708 on both sides, 2.2e-9
    apart (JAX's histograms come back as float32), every histogram equal,
    and the CE sums 261089.797 and 261089.688."""
    from semseg_tpu.models import PSPNet as JPSPNet
    from semseg_tpu.utils.metrics import summarize as jsummarize
    from semseg_torch.models.convert import state_dict_from_jax

    _, (images, labels) = data
    jmodel = JPSPNet(layers=50, classes=conv.CLASSES, zoom_factor=8, dtype=jnp.float32)
    v = jax.jit(lambda k, x: jmodel.init({"params": k, "dropout": k}, x, train=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, conv.CROP, conv.CROP, 3), jnp.float32))
    v = jax.tree.map(np.asarray, v)
    eval_step = jtrainer.make_eval_step(jmodel, classes=conv.CLASSES, ignore_label=255,
                                        zoom_factor=8, normalize=conv.NORMALIZE)
    want = jax.device_get(eval_step(v, jnp.asarray(images), jnp.asarray(labels.astype(np.int32))))
    want_miou = jsummarize(want["intersection"], want["union"], want["target"])[0]

    hist = {}
    real_eval = conv.eval_step

    def recording(*a, **kw):
        out = real_eval(*a, **kw)
        hist.update({k: out[k].numpy() for k in ("intersection", "union", "target")})
        return out

    model = conv.build_model(conv.model_cfg("psp"), dtype=torch.float32, device="cpu",
                             seed=0, train=True)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    conv.eval_step, saved = recording, conv.eval_step
    try:
        got_miou = conv.val_miou(model, (images, labels))
    finally:
        conv.eval_step = saved
    assert model.training  # val_miou puts the mode back
    assert abs(got_miou - float(want_miou)) <= 1e-3
    pixels = labels.size
    for k in ("intersection", "union", "target"):
        assert np.abs(hist[k] - np.asarray(want[k])).sum() <= 1e-3 * pixels, k


# Run by test_fresh_process_psanet_run_loads_no_jax in a fresh interpreter.
_SCRIPT = """
import runpy, sys
sys.argv = ["semseg_torch.convergence", "2", "--arch", "psa"]
try:
    runpy.run_module("semseg_torch.convergence", run_name="__main__")
except RuntimeError as exc:
    print("MAIN RAISED", "torch.cuda.is_available() is false" in str(exc))
from semseg_torch import convergence as conv
traj = conv.run("float32", 2, conv.make_dataset(0, 16), conv.make_dataset(1, 8), arch="psa",
                device="cpu")
print("TRAJ", len(traj), traj[0][0], 0.0 <= traj[0][1] <= 1.0)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "semseg_tpu", "tool"))
print("LOADED", loaded)
"""


def test_fresh_process_psanet_run_loads_no_jax():
    """In a fresh process that sees no CUDA device (``CUDA_VISIBLE_DEVICES``
    empty, so the same on a host with a card): ``python -m
    semseg_torch.convergence`` raises; a 2-step float32 PSANet50 ``run``
    on the CPU (the plain attention) returns a one-point trajectory and prints one line with the
    JAX tool's keys; no jax, flax, ``semseg_tpu`` or ``tool`` module is
    ever loaded. The module reads no environment variable."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert "MAIN RAISED True" in out
    assert "TRAJ 1 2 True" in out and "LOADED []" in out
    lines = [json.loads(s) for s in out if s.startswith("{")]
    assert len(lines) == 1
    assert sorted(lines[0]) == ["dtype", "elapsed_s", "loss", "step", "val_mIoU"]
    assert lines[0]["step"] == 2 and np.isfinite(lines[0]["loss"])
    source = (REPO / "semseg_torch" / "convergence.py").read_text()
    assert "environ" not in source and "getenv" not in source
