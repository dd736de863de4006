"""The numbers that decide ``correct``, each held to its limit
(``bench_h100/limits/<workload>.json``).

Serving: at each pixel the gap by which the reference's mean probability
of the served class lies below the reference's best class (0 where the
served class is the reference's best). ``gap_ratio``: the sum of the gaps
of the served maps over the sum of the gaps of a plain bfloat16 run of the
reference (the same model cast to bfloat16, the configuration's
precision), per image. How far a map may stray depends on the weights
(how many pixels are near-tied, how much the network amplifies rounding)
far more than on the arithmetic; the plain bfloat16 run of the same
weights and images measures that, so the ratio reads the arithmetic.
``class_gap`` (the widest gap) and the share of pixels off are readings.

Training, over the first three steps: ``loss_gap`` the largest relative
gap of a step's loss, ``loss_gap.first`` the first step's; ``grad_gap``
the first step's gradient as the optimizer takes it (``g + wd * p``, its
momentum buffer after one step); ``change_gap`` the change of every
parameter and BatchNorm statistic over the three steps (``.median``: of
the parameters alone, so that a step that leaves them unchanged reads 1
however the statistics move); ``bn_gap.first`` the change of the
BatchNorm statistics over the first step. Each by the worst leaf
(``.median``: the median leaf): ``| |prog| - |ref| | / max(|ref|, median
leaf's |ref|)`` of the leaf's norms. Parameters whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of ``change_gap``. Which of these a cell
compares, its limits file says; the others are readings.
"""

from __future__ import annotations


class MapStats:
    """Served class maps against the reference's mean probabilities, summed
    over maps: the widest gap, the pixels off the reference's best and the
    sum of the gaps."""

    def __init__(self):
        self.widest, self.pixels, self.off, self.gap_sum, self.maps = 0.0, 0, 0, 0.0, 0

    def add(self, mean_probs, served):
        """``mean_probs``: the reference's float32 ``[C, H, W]``;
        ``served``: a ``[H, W]`` class map on the same device."""
        got = mean_probs.gather(0, served.long()[None])[0]
        gap = mean_probs.max(0).values - got
        self.maps += 1
        self.widest = max(self.widest, float(gap.max()))
        self.pixels += gap.numel()
        self.off += int((gap > 0).sum())
        self.gap_sum += float(gap.double().sum())

    def numbers(self, plain=None):
        """The readings; with ``plain`` (the plain bfloat16 run's
        ``MapStats`` over the same images, one map an image) also
        ``gap_ratio``: this run's gaps per map over the plain run's (0 when
        neither strays, infinite when only this one does)."""
        out = {"class_gap": self.widest, "off_share": self.off / max(self.pixels, 1)}
        if plain is not None:
            mine = self.gap_sum / max(self.maps, 1)
            theirs = plain.gap_sum / max(plain.maps, 1)
            out["gap_ratio"] = (mine / theirs if theirs > 0 else
                                (0.0 if mine == 0 else float("inf")))
        return out


def norms(tensors: dict) -> dict:
    """The float64 norm of each named tensor, on the host."""
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None):
    """``(worst gap, its leaf, median gap)`` over the leaves of ``ref`` that
    ``keep`` holds (all by default); both map names to norms."""
    names = [n for n in ref if keep is None or n in keep]
    median = sorted(ref[n] for n in names)[len(names) // 2]
    # a leaf the program lacks (no optimizer state, say) reads a norm of 0
    gaps = {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median, 1e-30) for n in names}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, sorted(gaps.values())[len(gaps) // 2]


def moving(ref_grad: dict, buffers, factor=1e-3):
    """Names of the state entries compared in ``change_gap``: every
    parameter whose reference gradient norm is at least ``factor`` times the
    median parameter's, and every other entry (BatchNorm's statistics)."""
    median = sorted(ref_grad.values())[len(ref_grad) // 2]
    return {n for n, v in ref_grad.items() if v >= factor * median} | set(buffers)


def statistics_change(model, start: dict) -> dict:
    """The change of every BatchNorm running mean and variance of ``model``
    since ``start`` (float32, by name)."""
    return {k: v.detach().float() - start[k] for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def train_numbers(prog, ref):
    """``prog`` and ``ref``: ``(losses [3], first gradient's norm by name,
    change's norm by name, the first step's BatchNorm statistics' change's
    norm by name)``. Returns ``{name: (value, detail)}``: the first step's
    loss and the largest of the three; the worst and the median leaf of the
    first gradient and of the change over three steps; the worst statistic
    of the first step."""
    losses_p, grad_p, change_p, bn_p = prog
    losses_r, grad_r, change_r, bn_r = ref
    rel = [abs(p - r) / abs(r) for p, r in zip(losses_p, losses_r)]
    grad_gap, grad_leaf, grad_median = leaf_gaps(grad_p, grad_r)
    keep = moving(grad_r, [n for n in change_r if n not in grad_r])
    change_gap, change_leaf, _ = leaf_gaps(change_p, change_r, keep)
    moved = keep & set(grad_r)
    _, _, change_median = leaf_gaps(change_p, change_r, moved)
    bn_gap, bn_leaf, _ = leaf_gaps(bn_p, bn_r)
    steps = f"steps {[float(f'{v:.3e}') for v in rel]}"
    kept = f"{len(keep)} of {len(change_r)} entries"
    return {"loss_gap": (max(rel), steps),
            "loss_gap.first": (rel[0], steps),
            "grad_gap": (grad_gap, grad_leaf),
            "grad_gap.median": (grad_median, f"{len(grad_r)} leaves"),
            "change_gap": (change_gap, f"{change_leaf}; {kept}"),
            "change_gap.median": (change_median, f"{len(moved)} of {len(grad_r)} parameters"),
            "bn_gap.first": (bn_gap, bn_leaf)}
