"""Where the two-replica lockstep's bars come from: JAX's own floor under
two perturbations.

Runs on the CPU; no card needed (it imports the JAX package and the port).
For one case of ``tests/test_torch_lockstep_replicas.py`` (``psp`` or
``psa``, ``sync`` or ``replica`` BatchNorm; 49x49 crops, 5 classes, two
replicas of two samples, two f32 steps), it runs ``make_train_step(
num_replicas=2)`` from JAX-initialised weights, then:
- JAX again with the images moved by 1e-6 (``uniform``, the one-replica
  locksteps' floor) or by 1e-6 N(0, 1) per pixel (``pixel``);
- the port's ``Trainer(num_replicas=2)`` from the same weights.
For each step and each group of state_dict keys (the heads: the PPM,
``cls`` and ``aux``; running statistics; the rest) it prints the max (with
its key) and the median over keys of |other - JAX| / |JAX's change| (L2
norms), for the port and for the floor, and the main losses.

Usage, from the repository root:
    env JAX_PLATFORMS=cpu python3 chip_probes/replica_floor.py psp replica pixel
"""

import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_lockstep_replicas as T  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from semseg_torch.engine import optim, trainer  # noqa: E402
from semseg_torch.models import build  # noqa: E402
from semseg_torch.models.layers import Dropout2d  # noqa: E402

GROUPS = (("heads", lambda k: k.split(".")[0] in ("ppm", "cls", "aux") and "running" not in k),
          ("running", lambda k: "running" in k),
          ("other", lambda k: k.split(".")[0] not in ("ppm", "cls", "aux")
           and "running" not in k))


def main(arch, bn, how):
    sync = bn == "sync"
    batches = T._batches()
    init, losses, _, sds = T._jax_run(arch, sync, batches)
    rs = np.random.RandomState(9)
    moved = [(im + np.float32(1e-6) * (rs.randn(*im.shape).astype(np.float32)
                                        if how == "pixel" else np.float32(1)), lb)
             for im, lb in batches]
    _, moved_losses, _, moved_sds = T._jax_run(arch, sync, moved)
    model = build.build_model(SimpleNamespace(**T._cfg(arch, sync)), device="cpu", train=True,
                              replicas=T.REPLICAS)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    model.load_state_dict(init, strict=True)
    tr = trainer.Trainer(model, optim.make_sgd(model, T.BASE_LR, T.MOMENTUM, T.WD),
                         classes=T.CLASSES, ignore_label=T.IGNORE, aux_weight=T.AUX_W,
                         base_lr=T.BASE_LR, max_iter=T.STEPS, power=T.POWER, zoom_factor=8,
                         num_replicas=T.REPLICAS)
    for step, (images, labels) in enumerate(batches):
        m = tr.step(torch.from_numpy(images), torch.from_numpy(labels))
        got = {k: v.numpy() for k, v in model.state_dict().items()}

        def ratios(other):
            out = {}
            for k, w in sds[step].items():
                if k.endswith("num_batches_tracked"):
                    continue
                w = w.numpy()
                out[k] = float(np.linalg.norm(other[k] - w)
                               / max(np.linalg.norm(w - init[k].numpy()), 1e-30))
            return out

        port = ratios(got)
        floor = ratios({k: v.numpy() for k, v in moved_sds[step].items()})
        print(f"step {step}: main loss port {m['main_loss'].item():.7f}, JAX "
              f"{losses[step][0]:.7f}, JAX moved ({how}) {moved_losses[step][0]:.7f}")
        for name, pick in GROUPS:
            keys = [k for k in port if pick(k)]
            for label, r in (("port", port), ("floor", floor)):
                worst = max(keys, key=r.get)
                print(f"  {name:8s} {label:5s} max {r[worst]:.4f} ({worst}), median "
                      f"{np.median([r[k] for k in keys]):.4f}")


if __name__ == "__main__":
    main(*sys.argv[1:4])
