"""A ``compute_dtype: bfloat16`` train step against the JAX package's, on
the CPU: two PSANet50 steps of ``semseg_torch.engine.trainer.Trainer`` with
a bf16 model against ``make_train_step`` on the JAX model built with
``dtype=jnp.bfloat16`` (as ``tool/train.py:127-137`` builds it), from the
same weights on the same batches. Inputs are made from seeds with numpy;
JAX results are materialised before any torch compute."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semseg_tpu.engine import trainer as jtrainer
from semseg_tpu.models.psanet import PSANet as JPSANet
from semseg_torch.engine import optim, trainer
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.psanet import PSANet

IGNORE = 255
STEPS, BATCH, CROP, CLASSES = 2, 2, 33, 5
BASE_LR, MOMENTUM, WD, AUX_W, POWER = 0.002, 0.9, 1e-4, 0.4, 0.9
KW = dict(layers=50, classes=CLASSES, zoom_factor=8, dropout=0.0, psa_type=2,
          shrink_factor=2, mask_h=5, mask_w=5, normalization_factor=1.0)
# (median, max) of |port - JAX| / |JAX's change| over a group's keys.
BARS = {"head": (0.3, 1.3), "psa": (1.7, 2.0), "backbone": (1.7, 2.0),
        "running": (0.06, 0.5)}


def _group(key):
    if "running" in key:
        return "running"
    top = key.split(".")[0]
    return "head" if top in ("cls", "aux") else "psa" if top == "psa" else "backbone"


def test_psanet50_bf16_two_step_lockstep_matches_jax():
    """Two bf16 PSANet50 train steps (33 crops, 5 classes, bi-direction,
    shrink 2, mask 5x5). The JAX side runs its plain attention
    (``fused_attention=False``); the port runs its fused attention, whose
    CPU entry points run the plain float32 softmax + bmm. Both sides
    therefore aggregate in float32 on the CPU (JAX's DEFAULT precision is
    full float32 there), and bf16 enters everywhere else: convolutions,
    activations, the BN inputs, the logits.

    Every bar comes from JAX bf16 against JAX bf16 with the images moved
    by one bf16 ulp (its floor), with room of 1.2x to 2.5x:

    - main and aux losses at both steps: rtol 1e-2 (measured at most
      2.1e-3; floor up to 5.7e-3). The LR exact.
    - after each step, per group of keys (``cls``/``aux``, ``psa``, the
      backbone, running statistics), the L2 distance of each key to JAX
      over the L2 change JAX made, its median and its max: head 0.3 / 1.3
      (measured 0.255 / 1.074; floor 0.253 / 1.049), psa and backbone
      1.7 / 2.0 (measured 1.399 / 1.644; floor 1.388 / 1.615), running
      statistics 0.06 / 0.5 (measured 0.048 / 0.340; floor 0.048 / 0.379).
      A bf16 update from a random init is noise: JAX's own backbone and
      PSA updates move by about sqrt(2) of themselves under one ulp of
      input, so those groups catch gross faults only (an LR 10x off). The
      head's median does discriminate: an aux weight of 0.5 moves it to
      0.34, the 10x group at 5x LR to 0.54."""
    jmodel = JPSANet(**KW, dtype=jnp.bfloat16, fused_attention=False)
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
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(STEPS):
        images = rs.randn(BATCH, CROP, CROP, 3).astype(np.float32)
        labels = rs.randint(0, CLASSES, (BATCH, CROP, CROP))
        labels[:, : CROP // 4] = IGNORE
        batches.append((images, labels))
    want = []
    for images, labels in batches:
        state, m = step_fn(state, jnp.asarray(images), jnp.asarray(labels))
        m = jax.device_get(m)
        want.append((float(m["main_loss"]), float(m["aux_loss"]), float(m["lr"]),
                     exported(state)))

    model = PSANet(**KW, dtype=torch.bfloat16, fused_attention=True)
    model.load_state_dict(init_sd, strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tr = trainer.Trainer(model, optim.make_sgd(model, BASE_LR, MOMENTUM, WD),
                         classes=CLASSES, ignore_label=IGNORE, aux_weight=AUX_W,
                         base_lr=BASE_LR, max_iter=STEPS, power=POWER, zoom_factor=8)
    for step, (images, labels) in enumerate(batches):
        m = tr.step(torch.from_numpy(images), torch.from_numpy(labels))
        wm, wa, wlr, wsd = want[step]
        np.testing.assert_allclose(m["main_loss"].item(), wm, rtol=1e-2, err_msg=f"step {step}")
        np.testing.assert_allclose(m["aux_loss"].item(), wa, rtol=1e-2, err_msg=f"step {step}")
        np.testing.assert_allclose(m["lr"], wlr, rtol=1e-6)
        got = model.state_dict()
        assert sorted(got) == sorted(wsd)
        ratios = {}
        for key, w in wsd.items():
            if key.endswith("num_batches_tracked"):
                continue
            w = w.numpy()
            update = np.linalg.norm(w - init_sd[key].numpy())
            ratios.setdefault(_group(key), []).append(
                (np.linalg.norm(got[key].numpy() - w) / max(update, 1e-30), key))
        assert sum(len(v) for v in ratios.values()) > 300
        for group, (bar_median, bar_max) in BARS.items():
            values = [r for r, _ in ratios[group]]
            worst = max(ratios[group])
            assert np.median(values) <= bar_median, (step, group, np.median(values))
            assert worst[0] <= bar_max, (step, group, worst)
