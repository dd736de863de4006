"""Is a convergence arm reproducible on the card? For PSPNet50 and
PSANet50, float32 and bfloat16, with cuDNN's ``deterministic`` flag off
(the default) and on: two arms of ``semseg_torch.convergence`` built from
one init take the same ``STEPS`` batches (the index stream of seed 0), and
their states are compared after the first step and after the last. A
difference after one step names the parameters it reaches: backward runs
from the head to the stem, so the parameter nearest the output that
differs sits at (or just below) the nondeterministic operation. One JSON
line per (arch, dtype, flag), with the card's name and power limit.

Usage, from the repository root: ``python3 chip_probes/convergence_determinism.py``
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from semseg_torch import convergence as conv  # noqa: E402

STEPS = 10


def differing(a, b):
    """Names of the float entries of two state dicts that differ, in the
    model's order, and the largest absolute difference."""
    names = [k for k, v in a.items() if v.is_floating_point() and not torch.equal(v, b[k])]
    worst = max(((a[k].double() - b[k].double()).abs().max().item() for k in names),
                default=0.0)
    return names, worst


def main():
    if not torch.cuda.is_available():
        print("convergence_determinism: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = conv.device_line(0)
    images, labels = conv.make_dataset(0, conv.N_TRAIN)
    rs = np.random.RandomState(1)
    batches = [rs.randint(0, conv.N_TRAIN, conv.BATCH) for _ in range(STEPS)]
    for arch in ("psp", "psa"):
        init = conv.initial_state(arch, 0, device)
        for name in ("float32", "bfloat16"):
            for det in (False, True):
                torch.backends.cudnn.deterministic = det
                states = []
                for _ in range(2):
                    trainer = conv.build_arm(name, STEPS, arch=arch, init_state=init,
                                             device=device)
                    snaps = []
                    for k, idx in enumerate(batches):
                        trainer.step(torch.from_numpy(images[idx]), torch.from_numpy(labels[idx]))
                        if k in (0, STEPS - 1):
                            snaps.append({n: v.detach().clone()
                                          for n, v in trainer.module.state_dict().items()})
                    states.append(snaps)
                    del trainer
                one, one_worst = differing(states[0][0], states[1][0])
                last, last_worst = differing(states[0][1], states[1][1])
                floats = sum(v.is_floating_point() for v in states[0][0].values())
                print(json.dumps({
                    "arch": arch, "dtype": name, "cudnn_deterministic": det, "steps": STEPS,
                    "entries": floats,
                    "differ_after_1_step": len(one), "max_abs_after_1_step": one_worst,
                    "nearest_output_after_1_step": [n for n in one if not n.startswith(
                        ("layer", "conv", "bn"))][-6:] or one[-6:],
                    "differ_after_last_step": len(last), "max_abs_after_last_step": last_worst,
                    "device": smi}), flush=True)
                del states
                torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
