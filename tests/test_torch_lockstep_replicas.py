"""The one-process two-replica train step against the JAX package's, on
the CPU: two float32 steps of ``Trainer(num_replicas=2)`` on a model from
``build_model(replicas=2)`` against ``make_train_step(num_replicas=2)`` on
a model from JAX's ``build_model(..., data_shards=2)``, from the same
weights on the same global batches, for PSPNet50 and PSANet50, with
``sync_bn`` True (moments over the global batch) and False (JAX's BN
groups: moments per replica, running statistics from replica 0). This is
what the DDP ranks compute (``tests/test_torch_parallel.py`` holds them to
it). Inputs are made from seeds with numpy; JAX results are materialised
before any torch compute."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.config import Config
from semseg_tpu.engine import trainer as jtrainer
from semseg_tpu.models import build as jbuild
from semseg_tpu.models.layers import set_bn_groups
from semseg_torch.engine import optim, trainer
from semseg_torch.models import build
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.layers import BatchNorm2d, Dropout2d

IGNORE = 255
# 49 crops as tests/test_torch_lockstep_psp.py; two replicas of two samples.
STEPS, BATCH, REPLICAS, CROP, CLASSES = 2, 4, 2, 49, 5
BASE_LR, MOMENTUM, WD, AUX_W, POWER = 0.002, 0.9, 1e-4, 0.4, 0.9
PSA_KEYS = dict(psa_type=2, compact=0, shrink_factor=2, mask_h=7, mask_w=7,
                normalization_factor=1.0, psa_softmax=1)


def _cfg(arch, sync_bn):
    keys = dict(arch=arch, layers=50, classes=CLASSES, zoom_factor=8, train_h=CROP,
                train_w=CROP, sync_bn=sync_bn, fused_attention=arch == "psa")
    if arch == "psa":
        keys.update(PSA_KEYS)
    return keys


def _batches(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        images = rs.randn(BATCH, CROP, CROP, 3).astype(np.float32)
        labels = rs.randint(0, CLASSES, (BATCH, CROP, CROP))
        labels[:, : CROP // 4] = IGNORE
        labels[1, CROP // 2:] = IGNORE  # replicas with unequal valid counts
        out.append((images, labels))
    return out


def _jax_run(arch, sync_bn, batches):
    """JAX's two steps; the initial and per-step state_dicts, losses and
    histograms. ``build_model`` sets the BN groups (read while tracing),
    reset to 1 after."""
    try:
        jmodel, _ = jbuild.build_model(Config(_cfg(arch, sync_bn)), data_shards=REPLICAS)
        jmodel = jmodel.clone(dropout=0.0, fused_attention=False) if arch == "psa" else \
            jmodel.clone(dropout=0.0)
        sample = jnp.zeros((BATCH, CROP, CROP, 3), jnp.float32)
        state = jtrainer.create_train_state(jmodel, jax.random.PRNGKey(3), sample)

        def exported(st):
            return state_dict_from_jax({"params": jax.device_get(st.params),
                                        "batch_stats": jax.device_get(st.batch_stats)}, arch)

        init = exported(state)
        step_fn = jtrainer.make_train_step(
            jmodel, classes=CLASSES, ignore_label=IGNORE, aux_weight=AUX_W, base_lr=BASE_LR,
            max_iter=STEPS, power=POWER, momentum=MOMENTUM, weight_decay=WD, zoom_factor=8,
            num_replicas=REPLICAS, donate=False)
        losses, hists, sds = [], [], []
        for images, labels in batches:
            state, m = step_fn(state, jnp.asarray(images), jnp.asarray(labels))
            m = jax.device_get(m)
            losses.append((float(m["main_loss"]), float(m["aux_loss"]), float(m["lr"])))
            hists.append([np.asarray(m[k]) for k in ("intersection", "union", "target")])
            sds.append(exported(state))
        return init, losses, hists, sds
    finally:
        set_bn_groups(1)


# Bars, as the one-replica locksteps' (tests/test_torch_lockstep_psp.py for
# PSPNet50, the PSANet50 lockstep in tests/test_torch_train.py), each from
# JAX's own floor: the L2 distance of a state entry to JAX over the L2
# change JAX made, by step, head or not, running statistic or not.
BARS = {"psp": {"loss1": 5e-3, "new": ("ppm", "cls", "aux"), "step0": (0.03, 0.2),
                "step1": (0.15, 0.3, 1.0)},
        "psa": {"loss1": 2e-2, "new": ("cls", "aux"), "step0": (0.03, 0.2),
                "step1": (0.3, 0.6, 0.6)}}


# PSPNet50's PPM 1x1 bin under per-replica BN normalises two values a
# channel in each replica. Its var = E[x^2] - E[x]^2 (JAX's arithmetic,
# which the port keeps) then cancels where the two pooled features nearly
# agree, and turns the convolutions' rounding into up to a tenth of the
# bin's BN bias update at step 0: JAX against itself with every pixel moved
# by 1e-6 N(0, 1) reaches 0.1057 there, the port 0.1057 (CPU, measured
# with this test's inputs). A uniform 1e-6 shift of the images, the
# one-replica locksteps' floor, moves both samples alike and shows 0.0023.
BIN1, BIN1_REPLICA_STEP0 = "ppm.features.0.", 0.15


@pytest.mark.parametrize("sync_bn", [True, False], ids=["sync_bn", "replica_bn"])
@pytest.mark.parametrize("arch", ["psp", "psa"])
def test_two_replica_lockstep_matches_jax(arch, sync_bn):
    """Two f32 steps at 49 crops (PSANet50: bi-direction, shrink 2, mask
    7x7, the fused attention's plain versions under its autograd
    Function), two replicas of two samples with unequal valid counts.
    Bars as the one-replica locksteps' (``BARS``): step 0 losses rtol
    1e-5 (a forward from identical weights) and histograms but near-ties;
    step 1 losses rtol 5e-3 (PSPNet50) or 2e-2 (PSANet50); after step 1
    every parameter and running statistic within 0.03 of JAX's change for
    the heads (PSPNet50's PPM too) and 0.2 for the rest; after step 2 the
    running statistics within 0.15 / 0.3, PSPNet50's cls and aux within
    0.3, every other parameter within 1.0 / 0.6. With ``sync_bn`` False
    the running statistics after step 1 are replica 0's alone: a port
    that tracked the global batch's would miss them by far more; and
    PSPNet50's 1x1 PPM bin gets 0.15 at step 0 (``BIN1``: its floor under
    per-replica moments is 0.1057)."""
    batches = _batches()
    init, want_losses, want_hist, want_sd = _jax_run(arch, sync_bn, batches)

    cfg = SimpleNamespace(**_cfg(arch, sync_bn))
    model = build.build_model(cfg, device="cpu", train=True, replicas=REPLICAS)
    groups = {m.groups for m in model.modules() if isinstance(m, BatchNorm2d)}
    assert groups == {1 if sync_bn else REPLICAS}
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    model.load_state_dict(init, strict=True)
    tr = trainer.Trainer(model, optim.make_sgd(model, BASE_LR, MOMENTUM, WD), classes=CLASSES,
                         ignore_label=IGNORE, aux_weight=AUX_W, base_lr=BASE_LR, max_iter=STEPS,
                         power=POWER, zoom_factor=8, num_replicas=REPLICAS)
    bars = BARS[arch]
    for step, (images, labels) in enumerate(batches):
        m = tr.step(torch.from_numpy(images), torch.from_numpy(labels))
        wm, wa, wlr = want_losses[step]
        rtol = 1e-5 if step == 0 else bars["loss1"]
        np.testing.assert_allclose(m["main_loss"].item(), wm, rtol=rtol, err_msg=f"step {step}")
        np.testing.assert_allclose(m["aux_loss"].item(), wa, rtol=rtol, err_msg=f"step {step}")
        np.testing.assert_allclose(m["lr"], wlr, rtol=1e-6)
        if step == 0:
            for g, w in zip((m["intersection"], m["union"], m["target"]), want_hist[0]):
                assert np.abs(g.numpy() - w).sum() <= 4, (g, w)
        got = model.state_dict()
        assert sorted(got) == sorted(want_sd[step])
        checked = 0
        for key, w in want_sd[step].items():
            if key.endswith("num_batches_tracked"):
                continue
            w = w.numpy()
            change = np.linalg.norm(w - init[key].numpy())
            diff = np.linalg.norm(got[key].numpy() - w)
            head = key.split(".")[0] in bars["new"]
            if step == 0:
                bar = bars["step0"][0] if head and "running" not in key else bars["step0"][1]
                if not sync_bn and key.startswith(BIN1):
                    bar = BIN1_REPLICA_STEP0
            elif "running" in key:
                bar = bars["step1"][0]
            else:
                bar = bars["step1"][1] if key.split(".")[0] in ("cls", "aux") else \
                    bars["step1"][2]
            assert diff <= bar * change + 1e-7, (step, key, diff, change)
            checked += 1
        assert checked > 300
