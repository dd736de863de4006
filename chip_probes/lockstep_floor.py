"""Where the two-step training locksteps' bars come from: JAX's own floor.

Runs on the CPU; no card needed (it imports the JAX package and the port).
For ``psp`` (PSPNet50 f32, 49x49 crops) or ``bf16`` (PSANet50 with a bf16
model, 33x33 crops), the settings of ``tests/test_torch_lockstep_psp.py``
and ``tests/test_torch_lockstep_bf16.py``, it runs two ``make_train_step``
steps from JAX-initialised weights, then:
- JAX again with the images moved by 1e-6 (f32) or one bf16 ulp (bf16):
  the floor;
- the port's ``Trainer`` from the same weights: the port;
- the port with one recipe fault each (aux weight 0.5, the 10x group at
  5x, no weight decay): what the bars must catch.
For each step and each group of state_dict keys (backbone, ``ppm`` or
``psa``, the ``cls``/``aux`` heads, running statistics) it prints the
median and max over keys of |other - JAX| / |JAX's change| (L2 norms), and
the main and aux losses' relative differences.

Usage, from the repository root:
    env JAX_PLATFORMS=cpu python3 chip_probes/lockstep_floor.py psp|bf16
"""

import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from semseg_tpu.engine import trainer as jtrainer  # noqa: E402
from semseg_torch.engine import optim, trainer  # noqa: E402
from semseg_torch.models.convert import state_dict_from_jax  # noqa: E402

IGNORE, STEPS, BATCH, CLASSES = 255, 2, 2, 5
BASE_LR, MOMENTUM, WD, AUX_W, POWER = 0.002, 0.9, 1e-4, 0.4, 0.9
FAULTS = ("aux 0.5", "new group 5x", "no weight decay")


def setup(which):
    if which == "psp":
        from semseg_tpu.models.pspnet import PSPNet as J
        from semseg_torch.models.pspnet import PSPNet as T

        kw = dict(layers=50, classes=CLASSES, zoom_factor=8, dropout=0.0)
        return J(**kw), (lambda: T(**kw)), 49, "psp"
    from semseg_tpu.models.psanet import PSANet as J
    from semseg_torch.models.psanet import PSANet as T

    kw = dict(layers=50, classes=CLASSES, zoom_factor=8, dropout=0.0, psa_type=2,
              shrink_factor=2, mask_h=5, mask_w=5, normalization_factor=1.0)
    return (J(**kw, dtype=jnp.bfloat16, fused_attention=False),
            (lambda: T(**kw, dtype=torch.bfloat16, fused_attention=True)), 33, "psa")


def perturb(x, which):
    if which == "psp":
        return x + 1e-6 * np.sign(np.random.RandomState(9).randn(*x.shape)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return (xb + 2.0 ** (np.floor(np.log2(np.maximum(np.abs(xb), 1e-30))) - 7)).astype(
        np.float32)


def main(which):
    jmodel, make_port, crop, arch = setup(which)
    rs = np.random.RandomState(0)  # the tests' batches
    batches = []
    for _ in range(STEPS):
        images = rs.randn(BATCH, crop, crop, 3).astype(np.float32)
        labels = rs.randint(0, CLASSES, (BATCH, crop, crop))
        labels[:, : crop // 4] = IGNORE
        batches.append((images, labels))

    state0 = jtrainer.create_train_state(jmodel, jax.random.PRNGKey(3),
                                         jnp.zeros((BATCH, crop, crop, 3), jnp.float32))

    def exported(st):
        return state_dict_from_jax({"params": jax.device_get(st.params),
                                    "batch_stats": jax.device_get(st.batch_stats)}, arch)

    init_sd = exported(state0)
    step_fn = jtrainer.make_train_step(
        jmodel, classes=CLASSES, ignore_label=IGNORE, aux_weight=AUX_W, base_lr=BASE_LR,
        max_iter=STEPS, power=POWER, momentum=MOMENTUM, weight_decay=WD, zoom_factor=8,
        num_replicas=1, donate=False)

    def run_jax(bs):
        st, out = state0, []
        for images, labels in bs:
            st, m = step_fn(st, jnp.asarray(images), jnp.asarray(labels))
            m = jax.device_get(m)
            out.append(((float(m["main_loss"]), float(m["aux_loss"])), exported(st)))
        return out

    def run_port(fault=None):
        model = make_port()
        model.load_state_dict(init_sd, strict=True)
        opt = optim.make_sgd(model, BASE_LR, MOMENTUM, 0.0 if fault == FAULTS[2] else WD)
        if fault == FAULTS[1]:
            opt.param_groups[1]["lr_mult"] = 5.0
        tr = trainer.Trainer(model, opt, classes=CLASSES, ignore_label=IGNORE,
                             aux_weight=0.5 if fault == FAULTS[0] else AUX_W, base_lr=BASE_LR,
                             max_iter=STEPS, power=POWER, zoom_factor=8)
        out = []
        for images, labels in batches:
            m = tr.step(torch.from_numpy(images), torch.from_numpy(labels))
            out.append(((m["main_loss"].item(), m["aux_loss"].item()),
                        {k: v.clone() for k, v in model.state_dict().items()}))
        return out

    t0 = time.perf_counter()
    want = run_jax(batches)
    runs = {"floor (JAX, perturbed input)": run_jax([(perturb(i, which), l)
                                                     for i, l in batches]),
            "port": run_port()}
    runs.update({f"port, fault: {f}": run_port(f) for f in FAULTS})
    print(f"{which}: {time.perf_counter() - t0:.1f} s on the CPU", flush=True)

    def group(key):
        top = key.split(".")[0]
        if "running" in key:
            return "running"
        return "head" if top in ("cls", "aux") else top if top in ("ppm", "psa") else "backbone"

    for step in range(STEPS):
        (wm, wa), wsd = want[step]
        for label, run in runs.items():
            (lm, la), sd = run[step]
            groups = {}
            for key, w in wsd.items():
                if key.endswith("num_batches_tracked"):
                    continue
                w = w.numpy()
                change = max(np.linalg.norm(w - init_sd[key].numpy()), 1e-30)
                ratio = np.linalg.norm(sd[key].float().numpy() - w) / change
                groups.setdefault(group(key), []).append((ratio, key))
            print(f"step {step} {label}: main {abs(lm - wm) / abs(wm):.3e}, aux "
                  f"{abs(la - wa) / abs(wa):.3e}; median/max by group: " + ", ".join(
                      f"{g} {np.median([r for r, _ in v]):.4f}/{max(v)[0]:.4f} ({max(v)[1]})"
                      for g, v in sorted(groups.items())), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("psp", "bf16"):
        raise SystemExit("usage: lockstep_floor.py psp|bf16")
    main(sys.argv[1])
