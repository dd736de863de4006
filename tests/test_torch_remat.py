"""The port's ``remat`` on the CPU: each residual block of layer1..layer4
recomputed in the backward pass (``semseg_torch/models/resnet.py``, JAX
``nn.remat`` in ``semseg_tpu/models/resnet.py:162-166``).

- Against the port without ``remat``: f32 ``Trainer`` steps from the same
  weights give the same losses, parameters, SGD momentum, running
  statistics and ``num_batches_tracked``, bit for bit, in every BatchNorm
  form: the default, JAX's per-slice groups (``sync_bn: False`` over 2
  replicas), and synchronised over 2 gloo ranks (DDP, and a 1 x 2 TP
  grid through ``semseg_torch.parallel.parity``).
- Against JAX's ``ResNet(remat=True)``: features, the VJP and the updated
  BatchNorm statistics at segmentation strides in train mode.
- Eval, ``no_grad`` and ``inference_mode`` forwards are those without
  ``remat``, bit for bit; ``build_model`` reads the key.

Inputs are made from seeds with numpy."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from driver_data import threads  # noqa: F401  (2 intra-op threads here too)
from semseg_tpu.models.resnet import ResNet as JResNet
from semseg_tpu.models.resnet import SEG_DILATIONS, SEG_STRIDES
from semseg_torch.engine.optim import make_sgd
from semseg_torch.engine.trainer import Trainer
from semseg_torch.models import convert
from semseg_torch.models.build import build_model
from semseg_torch.models.layers import Conv2d
from semseg_torch.models.resnet import ResNet
from semseg_torch.parallel import dist as pdist
from semseg_torch.parallel import parity
from semseg_torch.utils.misc import find_free_port
from test_torch_models import _randomize_bn

CROP, CLASSES = 49, 5


@pytest.fixture(autouse=True)
def rank_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def _cfg(arch, remat, sync_bn=True, crop=CROP):
    keys = dict(arch=arch, layers=50, classes=CLASSES, zoom_factor=8, train_h=crop,
                train_w=crop, sync_bn=sync_bn, remat=remat)
    if arch == "psa":
        keys.update(psa_type=2, compact=0, shrink_factor=2, normalization_factor=1.0,
                    psa_softmax=1)
    return SimpleNamespace(**keys)


def _batches(n, crop=CROP, seed=4):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        labels = rs.randint(0, CLASSES, (4, crop, crop))
        labels[:, : crop // 4] = 255
        out.append((rs.randn(4, crop, crop, 3).astype(np.float32), labels))
    return out


def _train(cfg, replicas, batches):
    """Two f32 steps through the Trainer (the recipe's SGD, dropout on,
    drawn from the Trainer's seeded generator); the losses, the model's
    state and the momentum buffers."""
    model = build_model(cfg, device="cpu", seed=0, train=True, replicas=replicas)
    tr = Trainer(model, make_sgd(model, 0.01, 0.9, 1e-4), classes=CLASSES, ignore_label=255,
                 aux_weight=0.4, base_lr=0.01, max_iter=len(batches), power=0.9,
                 zoom_factor=8, num_replicas=replicas)
    losses = []
    for images, labels in batches:
        m = tr.step(torch.from_numpy(images), torch.from_numpy(labels))
        losses.append(torch.stack([m["loss"], m["main_loss"], m["aux_loss"]]))
    momentum = [s["momentum_buffer"] for s in tr.optimizer.state_dict()["state"].values()]
    return losses, model.state_dict(), momentum


@pytest.mark.parametrize("arch,crop", [("psp", 49), ("psa", 33)])
@pytest.mark.parametrize("sync_bn,replicas", [(True, 1), (False, 2)],
                         ids=["batch_bn", "replica_bn"])
def test_remat_steps_equal_the_steps_without(arch, crop, sync_bn, replicas):
    """Two f32 train steps of PSPNet50 at 49x49 and PSANet50 at 33x33 (PSA
    at 5x5 features, shrink 2: its mask 5x5), batch 4, from the same
    seeded weights, with ``remat`` on and off: the recompute takes the
    forward's moments through the same calls, so the losses, every
    parameter, momentum buffer and running statistic are equal bit for bit
    (``torch.equal``), and ``num_batches_tracked`` is the step count: the
    statistics moved once a step, not again in the recompute."""
    batches = _batches(2, crop)
    want = _train(_cfg(arch, False, sync_bn, crop), replicas, batches)
    got = _train(_cfg(arch, True, sync_bn, crop), replicas, batches)
    for step, (g, w) in enumerate(zip(got[0], want[0])):
        assert torch.isfinite(w).all() and torch.equal(g, w), (step, g, w)
    assert list(got[1]) == list(want[1])
    for k, w in want[1].items():
        assert torch.equal(got[1][k], w), k
    tracked = {k: int(v) for k, v in got[1].items() if k.endswith("num_batches_tracked")}
    assert tracked and set(tracked.values()) == {len(batches)}, tracked
    assert len(got[2]) == len(want[2]) and all(
        torch.equal(g, w) for g, w in zip(got[2], want[2]))


def test_remat_recomputes_the_residual_blocks_only():
    """A train step of PSANet50 at 33x33 with ``remat``: every conv of a
    residual block of layer1..layer4 runs twice (the forward and the
    recompute), the stem's, the PSA module's and the heads' once; without
    ``remat`` every conv runs once."""
    for remat in (False, True):
        model = build_model(_cfg("psa", remat, crop=33), device="cpu", train=True)
        calls = {}
        for name, m in model.named_modules():
            if isinstance(m, Conv2d):
                m.register_forward_pre_hook(
                    lambda _m, _a, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
        images, _ = _batches(1, 33)[0]
        logits, aux = model(torch.from_numpy(images).permute(0, 3, 1, 2))
        (logits.square().mean() + aux.square().mean()).backward()
        block = {k for k in calls if k.split(".")[0] in ("layer1", "layer2", "layer3",
                                                         "layer4")}
        assert len(block) == 3 * (3 + 4 + 6 + 3) + 4  # 3 convs a block, 4 downsamples
        assert len(calls) == len(list(m for m in model.modules() if isinstance(m, Conv2d)))
        for k, n in calls.items():
            assert n == (2 if remat and k in block else 1), (remat, k, n)


def test_remat_leaves_eval_and_no_grad_unchanged():
    """PSPNet50 at 33x33: the eval forward, and the train-mode forward under
    ``no_grad`` and ``inference_mode`` (which update the running statistics
    once), are those of the model without ``remat`` bit for bit, and so
    are the statistics after them."""
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 3, 33, 33).astype(np.float32))
    out = {}
    for remat in (False, True):
        model = build_model(_cfg("psp", remat, crop=33), device="cpu", seed=3)
        with torch.no_grad():
            ev = model(x)
        model.train()  # the heads' dropout draws from the global generator
        torch.manual_seed(0)
        with torch.no_grad():
            tr = model(x)
        torch.manual_seed(1)
        with torch.inference_mode():
            inf = model(x)
        out[remat] = (ev, *tr, *inf, *model.state_dict().values())
    for g, w in zip(out[True], out[False]):
        assert torch.equal(g, w)


def test_build_model_reads_remat():
    """The key on a cfg reaches the backbone; absent or None it is off
    (JAX ``build.py:80,106``: ``bool(cfg.get("remat") or False)``)."""
    for arch in ("psp", "psa"):
        cfg = _cfg(arch, True, crop=17)
        assert build_model(cfg, device="cpu").remat is True
        cfg.remat = None
        assert build_model(cfg, device="cpu").remat is False
        del cfg.remat
        assert build_model(cfg, device="cpu").remat is False
    assert ResNet(18).remat is False


def _jax_remat_features_and_vjp(variables, x, cots):
    jmodel = JResNet(depth=18, stage_strides=SEG_STRIDES, stage_dilations=SEG_DILATIONS,
                     remat=True)

    def apply(params, x):
        feats, updated = jmodel.apply({"params": params,
                                       "batch_stats": variables["batch_stats"]},
                                      x, train=True, mutable=["batch_stats"])
        return feats, updated["batch_stats"]

    @jax.jit
    def run(params, x, cots):
        feats, vjp, stats = jax.vjp(apply, params, x, has_aux=True)
        dparams, dx = vjp(tuple(cots))
        return feats, dparams, dx, stats

    out = run(variables["params"], jnp.asarray(x), [jnp.asarray(c) for c in cots])
    return jax.tree.map(np.asarray, out)


# The port's gradients against JAX's, by the relative L2 distance of each
# tensor (the distance over the norm of JAX's), with the port on one
# intra-op thread. There every tensor agrees within 1.1e-5 (the input
# gradient 6.0e-6): f32 sums in another order (oneDNN against XLA). The
# thread count is pinned because a ReLU kink moves with it: a
# pre-activation within f32 rounding of zero falls on the other side of it
# under another order of the BatchNorm sums, and routes one cotangent
# element differently into every layer below. Measured: 4 threads 1.1e-5,
# 2 threads (the rest of this file's) 6.1e-3 at layer4.0.bn1, 8 threads
# 3.5e-2 at layer2.0.conv1; a float64 run of the port agrees with JAX's f32
# within 1e-5 there, and the port without ``remat`` is as far from JAX
# without it. The bar is about 9x the one-thread reading; the port's remat
# gradients are also held bit for bit to its own without ``remat``.
GRAD_MAX = 1e-4
GRAD_THREADS = 1


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _port_remat_vjp(v, x, cots):
    """The port's ResNet18 with and without ``remat`` on JAX's variables
    ``v`` on ``GRAD_THREADS`` intra-op threads: by ``remat``, the model,
    its features, the input gradient and the weight gradients by name."""
    port, threads = {}, torch.get_num_threads()
    torch.set_num_threads(GRAD_THREADS)
    try:
        for remat in (True, False):
            model = ResNet(18, stage_strides=SEG_STRIDES, stage_dilations=SEG_DILATIONS,
                           remat=remat).train()
            model.load_state_dict(convert.backbone_state_dict_from_jax(v), strict=True)
            xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
            got = model(xt)
            torch.autograd.backward(got,
                                    [torch.from_numpy(c).permute(0, 3, 1, 2) for c in cots])
            port[remat] = (model, got, xt.grad,
                           {k: p.grad for k, p in model.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    return port


def test_remat_resnet18_matches_jax_remat():
    """JAX ``ResNet(depth=18, remat=True)`` and the port's ``ResNet(18,
    remat=True)`` at segmentation strides, 33x33, batch 2, train mode, on
    the converted weights (BatchNorm affine and statistics drawn from a
    seed): the four features within ``test_resnet_features_match_jax``'s
    1e-4; the VJP of random cotangents, each weight gradient and the input
    gradient within ``GRAD_MAX`` (see there; the port on ``GRAD_THREADS``
    intra-op threads), and equal bit
    for bit to the port's without ``remat``; the updated statistics within
    1e-5 (JAX's mean and unbiased variance at momentum 0.1),
    ``num_batches_tracked`` 1."""
    rs = np.random.RandomState(8)
    x = rs.randn(2, 33, 33, 3).astype(np.float32)
    jmodel = JResNet(depth=18, stage_strides=SEG_STRIDES, stage_dilations=SEG_DILATIONS)
    v = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(jax.random.PRNGKey(18),
                                                            jnp.asarray(x))
    v = _randomize_bn(v, seed=18)
    shapes = [(2, 9, 9, 64), (2, 5, 5, 128), (2, 5, 5, 256), (2, 5, 5, 512)]  # output stride 8
    cots = [rs.randn(*s).astype(np.float32) for s in shapes]
    feats, dparams, dx, stats = _jax_remat_features_and_vjp(v, x, cots)

    port = _port_remat_vjp(v, x, cots)
    model, got, got_dx, grads = port[True]
    for k, g in grads.items():
        assert torch.equal(g, port[False][3][k]), k
    assert torch.equal(got_dx, port[False][2])

    for g, w in zip(got, feats):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-4, atol=1e-4)
    assert _rel_l2(got_dx.permute(0, 2, 3, 1).numpy(), np.asarray(dx)) <= GRAD_MAX
    # The gradient tree in the place of the parameters maps onto the port's
    # names as the weights do (HWIO -> OIHW is linear).
    want = convert.backbone_state_dict_from_jax({"params": dparams, "batch_stats": stats})
    assert sorted(grads) == sorted(k for k in want if k.endswith(("weight", "bias")))
    rel = {k: _rel_l2(g.numpy(), want[k].numpy()) for k, g in grads.items()}
    assert max(rel.values()) <= GRAD_MAX, max(rel, key=rel.get)
    for k, t in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(t) == 1, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


GLOO_GRIDS, GLOO_CROP = (1, 2), 33  # DDP, and a 1 x 2 TP grid


@pytest.fixture(scope="module")
def gloo_arms():
    """One spawn of 2 gloo ranks (2 intra-op threads each) for both grids
    of :func:`test_remat_over_gloo_ranks_equals_no_remat`: by
    ``model_parallel``, each rank's results without and with ``remat``."""
    specs = [parity.StepSpec(cfg=_cfg("psp", remat, crop=GLOO_CROP),
                             batches=_batches(1, GLOO_CROP), device="cpu")
             for remat in (False, True)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        ranks = pdist.spawn(torch_ranks.remat_arms, 2,
                            (f"tcp://127.0.0.1:{find_free_port()}", 2, GLOO_GRIDS, specs),
                            timeout_s=300)
    return {mp: [r[mp] for r in ranks] for mp in GLOO_GRIDS}


@pytest.mark.parametrize("model_parallel", GLOO_GRIDS, ids=["ddp", "tp-1x2"])
def test_remat_over_gloo_ranks_equals_no_remat(gloo_arms, model_parallel):
    """One f32 PSPNet50 step (33x33, global batch 4, dropout off) as 2 gloo
    ranks with ``sync_bn: True``, through ``parity``'s trainer and steps, the
    arms without and with ``remat`` in one process group: as DDP ranks (the
    BatchNorm synchronised over them), and as a 1 x 2 TP grid (the head
    sharded, the backbone replicated, as JAX's ``sharding_rules.py`` shards
    it). The recompute all-reduces each block's BatchNorm moments again in
    the backward pass, on every rank in the same order; the losses on each
    rank and the state gathered on rank 0 equal those without ``remat``
    bit for bit, ``num_batches_tracked`` 1. Both grids run in one spawn
    (:func:`gloo_arms`)."""
    ranks = gloo_arms[model_parallel]
    for r, (want, got) in enumerate(ranks):
        assert got["losses"] == want["losses"] and np.isfinite(want["losses"]).all(), r
    want, got = ranks[0][0]["state"], ranks[0][1]["state"]
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
