"""PSPNet50 training against the JAX package's, on the CPU: two float32
train steps of ``semseg_torch.engine.trainer.Trainer`` against
``make_train_step`` from the same weights on the same batches (the model
that carries the ADE20K mIoU target). Inputs are made from seeds with
numpy; JAX results are materialised before any torch compute."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semseg_tpu.engine import trainer as jtrainer
from semseg_tpu.models.pspnet import PSPNet as JPSPNet
from semseg_torch.engine import optim, trainer
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.pspnet import PSPNet

IGNORE = 255
# 49 crops: 7x7 features, so every PPM bin (1, 2, 3, 6) pools real cells.
STEPS, BATCH, CROP, CLASSES = 2, 2, 49, 5
# base_lr 0.002, dropout 0: tests/test_train_lockstep.py:34-40.
BASE_LR, MOMENTUM, WD, AUX_W, POWER = 0.002, 0.9, 1e-4, 0.4, 0.9
# The modules of the 10x LR group (engine/optim.py).
NEW = ("ppm", "cls", "aux")


def _batches(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        images = rs.randn(BATCH, CROP, CROP, 3).astype(np.float32)
        labels = rs.randint(0, CLASSES, (BATCH, CROP, CROP))
        labels[:, : CROP // 4] = IGNORE
        out.append((images, labels))
    return out


def test_pspnet50_two_step_lockstep_matches_jax():
    """Two f32 PSPNet50 train steps (49 crops, 5 classes, PPM bins 1, 2, 3,
    6) from the same JAX-initialised weights on the same batches, against
    ``make_train_step``. Every bar is JAX's own floor, measured as JAX
    against JAX with the images moved by 1e-6, with about 1.5x room:

    - main and aux losses: step 0 rtol 1e-5 (measured 8.6e-7: a forward
      from identical weights); step 1 rtol 5e-3 (measured 4.3e-4; JAX's
      floor 7.1e-4).
    - after step 1 (the first update), the L2 distance of each parameter
      and running statistic to JAX, over the L2 change JAX made: at most
      0.03 for the 10x LR group ``ppm``/``cls``/``aux`` (measured at most
      0.020, ``ppm.features.2.1``; floor 0.020, the same key) and 0.2 for
      every other key (measured 0.060, floor 0.062). PSANet's head bar
      (0.03) holds here, but covers the PPM too: its convolutions sit in
      the 10x group and their gradients come through the bins' pooling
      of the same noisy backbone features, so they reach the head's
      floor, not the backbone's. The bars catch the recipe's faults: an
      aux weight of 0.5 moves ``aux.0`` to 0.25, the new group at 5x LR
      moves it to 0.50, no weight decay moves a backbone key to 0.64.
    - after step 2, the step-1 noise compounded through momentum: running
      statistics within 0.15 (measured 0.052, floor 0.052), ``cls``/``aux``
      within 0.3 (measured 0.18, floor 0.19) and every other parameter,
      the PPM's included, within 1.0 (measured 0.63, floor 0.58; the PPM
      0.52, floor 0.49)."""
    jmodel = JPSPNet(layers=50, classes=CLASSES, zoom_factor=8, dropout=0.0)
    sample = jnp.zeros((BATCH, CROP, CROP, 3), jnp.float32)
    state = jtrainer.create_train_state(jmodel, jax.random.PRNGKey(3), sample)

    def exported(st):
        return state_dict_from_jax({"params": jax.device_get(st.params),
                                    "batch_stats": jax.device_get(st.batch_stats)}, "psp")

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

    model = PSPNet(layers=50, classes=CLASSES, zoom_factor=8, dropout=0.0)
    model.load_state_dict(init_sd, strict=True)
    tr = trainer.Trainer(model, optim.make_sgd(model, BASE_LR, MOMENTUM, WD),
                         classes=CLASSES, ignore_label=IGNORE, aux_weight=AUX_W,
                         base_lr=BASE_LR, max_iter=STEPS, power=POWER, zoom_factor=8)
    for step, (images, labels) in enumerate(batches):
        m = tr.step(torch.from_numpy(images), torch.from_numpy(labels))
        wm, wa, wlr = want_losses[step]
        rtol = 1e-5 if step == 0 else 5e-3
        np.testing.assert_allclose(m["main_loss"].item(), wm, rtol=rtol, err_msg=f"step {step}")
        np.testing.assert_allclose(m["aux_loss"].item(), wa, rtol=rtol, err_msg=f"step {step}")
        np.testing.assert_allclose(m["loss"].item(), wm + AUX_W * wa, rtol=rtol)
        np.testing.assert_allclose(m["lr"], wlr, rtol=1e-6)
        if step == 0:  # same weights: the argmax differs only at near-ties
            for g, w in zip((m["intersection"], m["union"], m["target"]), want_hist[0]):
                assert np.abs(g.numpy() - w).sum() <= 4, (g, w)
        got = model.state_dict()
        assert sorted(got) == sorted(want_sd[step])
        checked = 0
        for key, w in want_sd[step].items():
            if key.endswith("num_batches_tracked"):
                continue
            w = w.numpy()
            update = np.linalg.norm(w - init_sd[key].numpy())
            diff = np.linalg.norm(got[key].numpy() - w)
            top = key.split(".")[0]
            if step == 0:
                bar = 0.03 if top in NEW and "running" not in key else 0.2
            elif "running" in key:
                bar = 0.15
            else:
                bar = 0.3 if top in ("cls", "aux") else 1.0
            assert diff <= bar * update + 1e-7, (step, key, diff, update)
            checked += 1
        assert checked > 300
