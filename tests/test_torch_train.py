"""The port's training path against the JAX package's, on the CPU.

Losses, SGD groups and update order, the poly LR, the metric histograms,
the label downscale, train-mode BatchNorm, then the slice as a whole: a
2-step float32 PSANet50 lockstep of ``semseg_torch.engine.trainer.Trainer``
against ``make_train_step`` from the same weights on the same batches, and
the entry point (``semseg_torch.train.run``) on a tiny list-file dataset.
Inputs are made from seeds with numpy and handed to both sides; JAX results
are materialised before any torch compute.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.engine import losses as jlosses
from semseg_tpu.engine import optim as joptim
from semseg_tpu.engine import trainer as jtrainer
from semseg_tpu.models.layers import BatchNorm as JBatchNorm
from semseg_tpu.models.psanet import PSANet as JPSANet
from semseg_tpu.utils.metrics import intersection_and_union_jax
from semseg_torch.engine import losses, optim, trainer
from semseg_torch.models import build
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.layers import BatchNorm2d, Dropout2d, set_precision
from semseg_torch.models.psanet import PSANet
from semseg_torch.utils.metrics import AverageMeter, intersection_and_union, summarize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IGNORE = 255


def _logits_labels(seed, b=4, c=5, h=7, w=9):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(b, h, w, c) * 2).astype(np.float32)
    labels = rs.randint(0, c, (b, h, w))
    labels[rs.rand(b, h, w) < 0.3] = IGNORE
    labels[1] = IGNORE  # one sample all ignored: its replica divides by 1
    return logits, labels


@pytest.mark.parametrize("num_replicas", [1, 2, 4])
def test_replica_mean_ce_matches_jax(num_replicas):
    """rtol 1e-6: the same f32 sums in another order."""
    logits, labels = _logits_labels(num_replicas)
    want = float(jtrainer.replica_mean_ce(jnp.asarray(logits), jnp.asarray(labels),
                                          num_replicas, IGNORE))
    got = trainer.replica_mean_ce(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                  torch.from_numpy(labels), num_replicas, IGNORE)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        trainer.replica_mean_ce(torch.zeros(3, 5, 2, 2), torch.zeros(3, 2, 2), 2, IGNORE)


def test_cross_entropy_matches_jax():
    logits, labels = _logits_labels(7)
    jl, jt = jnp.asarray(logits), jnp.asarray(labels)
    want_sum, want_cnt = (float(v) for v in jlosses.cross_entropy_sum(jl, jt, IGNORE))
    want_nll, want_valid = (np.asarray(v) for v in jlosses.nll_and_valid(jl, jt, IGNORE))
    tl, tt = torch.from_numpy(logits).permute(0, 3, 1, 2), torch.from_numpy(labels)
    got_sum, got_cnt = losses.cross_entropy_sum(tl, tt, IGNORE)
    nll, valid = losses.nll_and_valid(tl, tt, IGNORE)
    np.testing.assert_allclose(got_sum.item(), want_sum, rtol=1e-6)
    assert got_cnt.item() == want_cnt
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_allclose((nll * valid).numpy(), want_nll * want_valid, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses.cross_entropy_mean(tl, tt, IGNORE).item(),
                               float(jlosses.cross_entropy_mean(jl, jt, IGNORE)), rtol=1e-6)
    assert losses.cross_entropy_mean(tl, torch.full_like(tt, IGNORE)).item() == 0.0


# ------------------------------------------------------------- optimizer


def test_poly_lr_matches_jax():
    for step in (0, 1, 37, 99, 100, 120):
        want = float(joptim.poly_lr(0.01, jnp.asarray(step, jnp.int32), 100, 0.9))
        np.testing.assert_allclose(optim.poly_lr(0.01, step, 100, 0.9), want, rtol=1e-6)
    assert optim.poly_lr(0.01, 0, 100) == 0.01


class _Tiny(torch.nn.Module):
    """Top-level names as the segmentation models: backbone, psa, cls."""

    def __init__(self):
        super().__init__()
        self.layer1 = torch.nn.Linear(3, 4)
        self.psa = torch.nn.Linear(4, 2, bias=False)
        self.cls = torch.nn.Linear(2, 2)


def test_sgd_groups_and_update_order_match_jax():
    """Three steps of torch SGD with the two groups and the poly LR set
    before each step against ``sgd_update`` with ``make_lr_mult``: params
    within 1e-6 (f32, identical op order up to the LR product)."""
    torch.manual_seed(0)
    model = _Tiny()
    groups = optim.param_groups(model, 0.01)
    assert [g["lr_mult"] for g in groups] == [1.0, 10.0]
    assert [len(g["params"]) for g in groups] == [2, 3]
    opt = optim.make_sgd(model, 0.01, momentum=0.9, weight_decay=1e-4)
    jparams = {name.split(".")[0]: {} for name, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        top, leaf = name.split(".")
        jparams[top][leaf] = jnp.asarray(p.detach().numpy())
    mult = joptim.make_lr_mult(jparams)
    assert mult == {"layer1": {"weight": 1.0, "bias": 1.0}, "psa": {"weight": 10.0},
                    "cls": {"weight": 10.0, "bias": 10.0}}
    state = joptim.sgd_init(jparams)
    rs = np.random.RandomState(0)
    for step in range(3):
        grads = {top: {leaf: rs.randn(*v.shape).astype(np.float32) for leaf, v in d.items()}
                 for top, d in jparams.items()}
        lr = joptim.poly_lr(0.01, jnp.asarray(step, jnp.int32), 3, 0.9)
        jparams, state = joptim.sgd_update(jparams, grads, state, lr, mult, 0.9, 1e-4)
        optim.set_lr(opt, optim.poly_lr(0.01, step, 3, 0.9))
        for name, p in model.named_parameters():
            top, leaf = name.split(".")
            p.grad = torch.from_numpy(grads[top][leaf])
        opt.step()
    for name, p in model.named_parameters():
        top, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[top][leaf]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


# --------------------------------------------------------------- metrics


def test_histograms_match_jax():
    rs = np.random.RandomState(3)
    pred = rs.randint(0, 6, (2, 11, 13))
    target = rs.randint(0, 6, (2, 11, 13))
    target[rs.rand(2, 11, 13) < 0.2] = IGNORE
    want = [np.asarray(v) for v in intersection_and_union_jax(
        jnp.asarray(pred), jnp.asarray(target), 6, IGNORE)]
    got = intersection_and_union(torch.from_numpy(pred), torch.from_numpy(target), 6, IGNORE)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(summarize(*got), summarize(*want), rtol=1e-12)
    meter = AverageMeter()
    meter.update(2.0, 3)
    meter.update(4.0)
    assert (meter.val, meter.sum, meter.count, meter.avg) == (4.0, 10.0, 4, 2.5)


@pytest.mark.parametrize("zoom", [1, 2, 4])
def test_downscale_labels_matches_jax(zoom):
    """Exact: the same align-corners weights on float labels, truncated."""
    labels = np.random.RandomState(zoom).randint(0, 19, (2, 33, 41))
    labels[:, :5] = IGNORE
    want = np.asarray(jtrainer.downscale_labels(jnp.asarray(labels), zoom))
    got = trainer.downscale_labels(torch.from_numpy(labels), zoom)
    assert tuple(got.shape) == (2, 32 // 8 * zoom + 1, 40 // 8 * zoom + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_normalize_matches_jax():
    images = np.random.RandomState(0).randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    norm = ([123.675, 116.28, 103.53], [58.395, 57.12, 57.375])
    want = np.asarray(jtrainer._device_normalize(jnp.asarray(images), norm))
    got = trainer.device_normalize(torch.from_numpy(images), norm)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)
    plain = trainer.device_normalize(torch.from_numpy(images))
    assert tuple(plain.shape) == (2, 3, 5, 7) and plain.dtype == torch.float32


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batchnorm_train_mode_matches_jax(dtype):
    """Output, input/affine gradients and the running statistics after one
    train-mode step (batch moments in f32, momentum 0.1, unbiased running
    variance): f32 within 1e-5; bf16 activations within one bf16 ulp of the
    output's scale (both round the same f32 values)."""
    rs = np.random.RandomState(1)
    x = (rs.randn(3, 6, 5, 4) * 2 + 1).astype(np.float32)
    g = rs.randn(3, 6, 5, 4).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    bn = JBatchNorm(dtype=jdt)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False)
    scale = rs.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rs.randn(4).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def f(p, xx):
        y, upd = bn.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                          use_running_average=False, mutable=["batch_stats"])
        return y, upd

    xj = jnp.asarray(x).astype(jdt)
    y, upd = f(params, xj)
    _, pull = jax.vjp(lambda p, xx: f(p, xx)[0].astype(jnp.float32), params, xj)
    gp, gx = pull(jnp.asarray(g))
    want = [np.asarray(t, np.float32) for t in
            (y, gx, gp["scale"], gp["bias"], upd["batch_stats"]["mean"],
             upd["batch_stats"]["var"])]

    m = BatchNorm2d(4).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).requires_grad_()
    yt = m(xt)
    assert yt.dtype == tdt
    yt.float().backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    got = [yt.float().permute(0, 2, 3, 1), xt.grad.float().permute(0, 2, 3, 1), m.weight.grad,
           m.bias.grad, m.running_mean, m.running_var]
    for name, gv, wv in zip(("y", "dx", "dscale", "dbias", "mean", "var"), got, want):
        tol = 1e-5 if dtype == "f32" or name in ("mean", "var", "dscale", "dbias") else \
            2.0 ** (np.floor(np.log2(np.abs(wv).max())) - 7)
        np.testing.assert_allclose(gv.detach().numpy(), wv, rtol=1e-5, atol=tol, err_msg=name)


def test_dropout2d_uses_its_generator():
    x = torch.ones(4, 16, 3, 3)
    d = Dropout2d(0.5).train()
    d.generator = torch.Generator().manual_seed(5)
    a = d(x)
    d.generator.manual_seed(5)
    b = d(x)
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, 2.0} and 0 < (a == 0).float().mean() < 1
    assert torch.equal(a, a[:, :, :1, :1].expand_as(a))  # whole channels
    assert torch.equal(d.eval()(x), x) and torch.equal(Dropout2d(0.0).train()(x), x)
    assert torch.equal(Dropout2d(1.0).train()(x), torch.zeros_like(x))


def test_set_precision_maps_matmul_precision():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        set_precision(torch.float32, "high")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        set_precision(torch.bfloat16, "highest")  # other dtypes leave the flags
        assert torch.backends.cudnn.allow_tf32
        for p in (None, "default", "highest"):
            set_precision(torch.float32, "high")
            set_precision(torch.float32, p)
            assert not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
        with pytest.raises(ValueError, match="matmul_precision"):
            set_precision(torch.float32, "medium")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_build_model_for_training():
    cfg = SimpleNamespace(arch="psp", layers=50, classes=3, zoom_factor=8, train_h=33,
                          train_w=33, compute_dtype="bfloat16")
    assert build.compute_dtype(cfg) == torch.bfloat16
    assert build.compute_dtype(SimpleNamespace()) == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        build.compute_dtype(SimpleNamespace(compute_dtype="float16"))
    m = build.build_model(cfg, dtype=torch.bfloat16, device="cpu", train=True)
    assert m.training and all(p.dtype == torch.float32 for p in m.parameters())
    assert isinstance(m.cls[3], Dropout2d) and m.cls[3].p == 0.1
    logits, aux = m(torch.randn(2, 3, 33, 33))  # the PPM's 1x1 bin needs batch > 1
    assert logits.dtype == aux.dtype == torch.float32
    assert tuple(logits.shape) == tuple(aux.shape) == (2, 3, 33, 33)


# ------------------------------------------------------- PSANet50 lockstep

STEPS, BATCH, CROP, CLASSES = 2, 2, 33, 5
# base_lr 0.002, dropout 0: tests/test_train_lockstep.py:34-40 (from a
# random init, 0.01 turns f32 reduction-order noise into loss drift).
BASE_LR, MOMENTUM, WD, AUX_W, POWER = 0.002, 0.9, 1e-4, 0.4, 0.9


def _batches(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        images = rs.randn(BATCH, CROP, CROP, 3).astype(np.float32)
        labels = rs.randint(0, CLASSES, (BATCH, CROP, CROP))
        labels[:, : CROP // 4] = IGNORE
        out.append((images, labels))
    return out


def _psanet_kw():
    return dict(layers=50, classes=CLASSES, zoom_factor=8, dropout=0.0, psa_type=2,
                shrink_factor=2, mask_h=5, mask_w=5, normalization_factor=1.0)


def _tree_ratios(got, want, init):
    """Per state_dict key: L2 distance to JAX over the L2 change JAX made."""
    out = {}
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        w = w.numpy()
        update = np.linalg.norm(w - init[key].numpy())
        out[key] = (np.linalg.norm(got[key].numpy() - w), update)
    return out


def test_psanet50_two_step_lockstep_matches_jax():
    """Two f32 PSANet50 train steps (33 crops, 5 classes, bi-direction,
    shrink 2, mask 5x5, the fused attention's plain versions under the
    autograd Function) from the same JAX-initialised weights on the same
    batches, against ``make_train_step``. Bars, from measurement:

    - main and aux losses: step 0 rtol 1e-5 (a forward from identical
      weights); step 1 rtol 2e-2 (measured 8e-3: see below).
    - after step 1 (the first update, no momentum yet), every parameter and
      running statistic through ``state_dict_from_jax``: the L2 distance to
      JAX at most 0.03 of the L2 change JAX made for the ``cls``/``aux``
      heads (measured 1e-5 to 1.5e-2, cls.0 the largest) and 0.2 for every
      other key (measured at most 0.11). At this random init the gradients
      behind the heads are chaotic: JAX against itself with the images
      perturbed by 1e-6 moves the PSA gradients by 3 % and the backbone's by
      8-10 %, and the port sits at that floor. A wrong LR group, LR timing
      or aux weight moves a head key by 40 % to 10x.
    - after step 2, parameters within 0.6 and running statistics within
      0.3 of their change (measured at most 0.43 and 0.18: the step-1
      noise compounded through momentum)."""
    jmodel = JPSANet(**_psanet_kw(), fused_attention=False)
    sample = jnp.zeros((BATCH, CROP, CROP, 3), jnp.float32)
    state = jtrainer.create_train_state(jmodel, jax.random.PRNGKey(3), sample)

    def exported(st):
        return state_dict_from_jax({"params": jax.device_get(st.params),
                                    "batch_stats": jax.device_get(st.batch_stats)}, "psa")

    init_sd = exported(state)
    step_fn = jtrainer.make_train_step(
        jmodel, classes=CLASSES, ignore_label=IGNORE, aux_weight=AUX_W, base_lr=BASE_LR,
        max_iter=STEPS, power=POWER, momentum=MOMENTUM, weight_decay=WD, zoom_factor=8,
        num_replicas=1, donate=False)
    batches = _batches()
    want_losses, want_hist, want_sd = [], [], []
    for images, labels in batches:
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(labels))
        m = jax.device_get(m)
        want_losses.append((float(m["main_loss"]), float(m["aux_loss"]), float(m["lr"])))
        want_hist.append([np.asarray(m[k]) for k in ("intersection", "union", "target")])
        want_sd.append(exported(state))

    model = PSANet(**_psanet_kw(), fused_attention=True)
    model.load_state_dict(init_sd, strict=True)
    tr = trainer.Trainer(model, optim.make_sgd(model, BASE_LR, MOMENTUM, WD),
                         classes=CLASSES, ignore_label=IGNORE, aux_weight=AUX_W,
                         base_lr=BASE_LR, max_iter=STEPS, power=POWER, zoom_factor=8)
    for step, (images, labels) in enumerate(batches):
        m = tr.step(torch.from_numpy(images), torch.from_numpy(labels))
        wm, wa, wlr = want_losses[step]
        rtol = 1e-5 if step == 0 else 2e-2
        np.testing.assert_allclose(m["main_loss"].item(), wm, rtol=rtol, err_msg=f"step {step}")
        np.testing.assert_allclose(m["aux_loss"].item(), wa, rtol=rtol, err_msg=f"step {step}")
        np.testing.assert_allclose(m["loss"].item(), wm + AUX_W * wa, rtol=rtol)
        np.testing.assert_allclose(m["lr"], wlr, rtol=1e-6)
        if step == 0:  # same weights: the argmax differs only at near-ties
            for g, w in zip((m["intersection"], m["union"], m["target"]), want_hist[0]):
                assert np.abs(g.numpy() - w).sum() <= 4, (g, w)
        got = model.state_dict()
        assert sorted(got) == sorted(want_sd[step])
        ratios = _tree_ratios(got, want_sd[step], init_sd)
        assert len(ratios) > 300
        for key, (diff, update) in ratios.items():
            if step == 0:
                bar = 0.03 if key.split(".")[0] in ("cls", "aux") else 0.2
            else:
                bar = 0.3 if "running" in key else 0.6
            assert diff <= bar * update + 1e-7, (step, key, diff, update)


def test_trainer_dropout_is_seeded():
    """Two runs from the same weights and seed, dropout 0.1 on: identical
    losses; another seed gives other losses."""
    cfg = SimpleNamespace(arch="psa", layers=50, classes=3, zoom_factor=8, train_h=17,
                          train_w=17, psa_type=2, compact=0, shrink_factor=2,
                          normalization_factor=1.0, psa_softmax=1)
    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.randn(2, 17, 17, 3).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 3, (2, 17, 17)))

    def losses_for(seed):
        model = build.build_model(cfg, seed=1, device="cpu", train=True)
        assert model.cls[3].p == 0.1
        tr = trainer.Trainer(model, optim.make_sgd(model, 0.01), classes=3,
                             ignore_label=IGNORE, aux_weight=0.4, base_lr=0.01,
                             max_iter=3, power=0.9, zoom_factor=8, rng_seed=seed)
        return [tr.step(images, labels)["loss"].item() for _ in range(2)]

    first = losses_for(7)
    assert first == losses_for(7)
    assert first != losses_for(8)


# ------------------------------------------------------------ entry point


def _write_dataset(root, n=4, h=48, w=64, classes=5):
    import cv2

    rs = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    lines = []
    for k in range(n):
        cv2.imwrite(os.path.join(root, "img", f"{k}.png"),
                    rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        label = rs.randint(0, classes, (h, w)).astype(np.uint8)
        label[:4] = IGNORE
        cv2.imwrite(os.path.join(root, "img", f"{k}_label.png"), label)
        lines.append(f"img/{k}.png img/{k}_label.png")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _train_args(root, *extra):
    return ["--config", os.path.join(REPO, "config/cityscapes/cityscapes_psanet50.yaml"),
            "data_root", str(root), "train_list", os.path.join(str(root), "train.txt"),
            "classes", "5", "train_h", "33", "train_w", "33", "batch_size", "2",
            "epochs", "1", "workers", "2", "print_freq", "1", "manual_seed", "3",
            "save_path", os.path.join(str(root), "exp"), *extra]


# Run by test_train_run_imports_no_jax in a fresh interpreter.
_TRAIN_SCRIPT = """
import sys
import torch
from semseg_torch.train import parse_args, run
res = run(parse_args(sys.argv[1:]), device="cpu")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "semseg_tpu"))
ck = torch.load(res["checkpoints"][0], map_location="cpu", weights_only=True)
print("RESULT", res["trainer"].step_count, len(ck["state_dict"]), loaded)
"""


def test_train_run_imports_no_jax(tmp_path):
    """``run(cfg, device='cpu')`` in a fresh process: 2 steps (4 samples,
    batch 2, uint8 wire), one checkpoint in reference naming, and no jax,
    jaxlib, flax or ``semseg_tpu`` module ever imported (the port reads
    configs and data through its own ``semseg_torch.config`` and
    ``semseg_torch.data``)."""
    _write_dataset(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_SCRIPT, *_train_args(tmp_path, "image_wire_dtype", "uint8")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][0]
    assert result == f"RESULT 2 {len(PSANet(**_psanet_kw()).state_dict())} []"
    assert "MainLoss" in proc.stderr and "Train result at epoch [1/1]" in proc.stderr
    assert os.path.isfile(tmp_path / "exp" / "train_epoch_1.pth")


def test_train_run_and_refusals(tmp_path):
    """In process: the float32 wire, a step hook that sees every step, the
    poly LR reaching its second step; a batch larger than the dataset
    raises; ``main`` raises without CUDA. (``resume``, ``evaluate`` and
    ``weight`` are held to the JAX driver in ``tests/test_torch_drivers.py``.)"""
    from semseg_torch import train

    _write_dataset(tmp_path)
    seen = []
    res = train.run(train.parse_args(_train_args(tmp_path)), "cpu",
                    step_hook=lambda it, m: seen.append((it, m["lr"], m["loss"].item())))
    assert [it for it, _, _ in seen] == [1, 2]
    assert seen[0][1] == 0.01 and seen[1][1] == pytest.approx(0.01 * 0.5 ** 0.9)
    assert all(np.isfinite(loss) for _, _, loss in seen)
    stats = res["epochs"][0]
    assert stats["steps"] == 2 and 0.0 <= stats["mIoU"] <= 1.0
    with pytest.raises(ValueError, match="exceeds"):
        train.run(train.parse_args(_train_args(tmp_path, "batch_size", "8")), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(_train_args(tmp_path))


@pytest.mark.parametrize("end", ["returns", "preempted", "raises"])
def test_train_run_is_deterministic_and_restores_cudnn_flags(tmp_path, end):
    """``run`` trains under cuDNN's deterministic algorithms with its
    autotuning off (so an f32 run repeats itself on the card, and a resumed
    run the run it continues), whatever the caller set; the caller's flags
    come back however the run ends: returning, preempted after step 1, or
    raising from the step hook."""
    from semseg_torch import train

    cudnn = torch.backends.cudnn
    _write_dataset(tmp_path)
    cfg = train.parse_args(_train_args(tmp_path))
    if end == "preempted":
        cfg.update(_preempt_after_step=1)
    seen = []

    def hook(it, metrics):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        if end == "raises":
            raise RuntimeError("the step hook raised")

    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = False, True
    try:
        if end == "raises":
            with pytest.raises(RuntimeError, match="the step hook raised"):
                train.run(cfg, "cpu", step_hook=hook)
        else:
            res = train.run(cfg, "cpu", step_hook=hook)
            assert (res["preempt"] is not None) == (end == "preempted")
        assert seen == [(True, False)] * {"returns": 2, "preempted": 1, "raises": 1}[end]
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def test_model_parallel_needs_a_dividing_world(tmp_path):
    """``model_parallel`` that does not divide the ranks raises with JAX's
    words (``tool/train.py:79-83``): in ``run`` in one process (1 rank),
    and in ``spawn`` before any rank starts (3 ranks); the grid is
    data-major, so TP peers are neighbouring ranks."""
    from semseg_torch import train
    from semseg_torch.parallel.dist import grid

    cfg = train.parse_args(_train_args(tmp_path, "model_parallel", "2"))
    with pytest.raises(ValueError, match="model_parallel 2 does not divide 1 devices"):
        train.run(cfg, "cpu")
    cfg = train.parse_args(_train_args(tmp_path, "model_parallel", "2", "train_gpu", "[0, 0, 0]",
                                       "dist_backend", "gloo", "batch_size", "3"))
    with pytest.raises(ValueError, match="model_parallel 2 does not divide 3 devices"):
        train.spawn(cfg, "cpu")
    g = grid(8, 2)
    assert (g.data_world, g.data_index(5), g.model_index(5)) == (4, 2, 1)
    assert g.tp_ranks(2) == [4, 5] and g.data_ranks(1) == [1, 3, 5, 7]
    assert grid(4, None).model_parallel == 1


def test_model_parallel_batch_divides_by_the_data_ranks():
    """Under ``model_parallel M`` over ``W`` ranks the global batch splits
    over the ``W / M`` data ranks (TP peers load the same samples), not
    over ``W``: 2 over 4 ranks at M 2 gives 1 a data rank, at M 4 the whole
    2; a batch the data ranks do not divide raises and names the split."""
    from semseg_torch.train import per_rank_batch

    assert per_rank_batch(2, 4, model_parallel=2) == 1
    assert per_rank_batch(2, 4, model_parallel=4) == 2
    assert per_rank_batch(6, 2) == 3
    with pytest.raises(ValueError, match=r"batch_size 3 not divisible by 2 ranks \(4 ranks / "
                                         r"model_parallel 2\)"):
        per_rank_batch(3, 4, model_parallel=2)
    with pytest.raises(ValueError, match="batch_size_val 2 not divisible by 4 ranks$"):
        per_rank_batch(2, 4, "batch_size_val")
    with pytest.raises(ValueError, match="model_parallel 3 does not divide 4 devices"):
        per_rank_batch(4, 4, model_parallel=3)


def test_profile_dir_is_logged_and_ignored(tmp_path):
    """``profile_dir`` traces the first epoch (``tool/train.py:426-485``):
    the run trains as without it, logs the trace's path and writes one
    Chrome trace (``traceEvents``) holding the step's convolutions."""
    import json
    import logging

    from semseg_torch import train

    _write_dataset(tmp_path, n=2)
    records = []
    logger = logging.getLogger("test_profile_dir")
    logger.setLevel(logging.INFO)
    logger.addHandler(type("H", (logging.Handler,), {"emit": lambda self, r: records.append(r)})())
    prof = tmp_path / "prof"
    cfg = train.parse_args(_train_args(tmp_path, "profile_dir", str(prof)))
    res = train.run(cfg, "cpu", logger=logger)
    assert res["trainer"].step_count == 1
    assert os.listdir(prof) == ["train_epoch_1.pt.trace.json"]
    trace = json.loads((prof / "train_epoch_1.pt.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::conv") for n in names), sorted(names)[:20]
    path = prof / "train_epoch_1.pt.trace.json"
    assert any(r.getMessage() == f"Profiler trace written to: {path}" for r in records)
