"""The plain reference against semseg_torch at a tiny size on the CPU, the
same weights made by the benchmark on both sides (this test imports both;
the reference itself imports nothing of the program)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_h100.harness import compare, manifest, traffic, weights
from bench_h100.reference import models, pipeline
from bench_h100.reference import train as ref_train
from bench_h100.rehearse import tiny

CELLS = {"psp": "city_pspnet50_serve_ss", "psa": "city_psanet50_train_f32"}


def pair(arch):
    config = tiny(manifest.cell(CELLS[arch])).config
    from semseg_torch.models.build import build_model

    ref = models.build(config, "cpu")
    state = weights.make(models.build(config, "meta"), 7, "cpu")
    ref.load_state_dict(state)
    prog = build_model(SimpleNamespace(**config["model"]), device="cpu")
    prog.load_state_dict(state)
    return config, ref, prog


@pytest.mark.parametrize("arch", ["psp", "psa"])
def test_forward_matches(arch):
    torch.manual_seed(0)
    config, ref, prog = pair(arch)
    x = torch.randn(2, 3, 33, 33)
    with torch.no_grad():
        ref.eval(), prog.eval()
        a, b = ref(x), prog(x)
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
        ref.train(), prog.train()
        for model in (ref, prog):  # one dropout stream each, seeded alike
            gen = torch.Generator().manual_seed(3)
            for mod in model.modules():
                if hasattr(mod, "generator"):
                    mod.generator = gen
        (a, a_aux), (b, b_aux) = ref(x), prog(x)
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
        assert (a_aux - b_aux).abs().max() <= 1e-4 * a_aux.abs().max()


def test_sliding_window_matches():
    from semseg_torch.engine.evaluator import SlidingWindowEvaluator

    config, ref, prog = pair("psp")
    m = config["model"]
    image = traffic.street_sample(3, 48, 96)[0]
    kw = dict(crop=33, base_size=96, scales=[0.5, 1.0, 1.25], mean=[120.0, 110.0, 100.0],
              std=[60.0, 60.0, 60.0])
    want = pipeline.mean_probs(ref.eval(), image, **kw).permute(1, 2, 0).numpy()
    ev = SlidingWindowEvaluator(prog, classes=m["classes"], crop_h=33, crop_w=33,
                                mean=kw["mean"], std=kw["std"], base_size=96,
                                scales=kw["scales"], window_batch=8, device="cpu")
    got = ev.predict_probs(image)
    assert np.abs(got - want).max() < 1e-5
    stats = compare.MapStats()
    stats.add(torch.from_numpy(want).permute(2, 0, 1), torch.from_numpy(ev.predict(image)))
    assert stats.widest < 1e-5


def test_training_steps_match():
    from semseg_torch.engine.optim import make_sgd
    from semseg_torch.engine.trainer import Trainer

    config, ref, prog = pair("psa")
    r = config["recipe"]
    mix = dict(manifest.cell(CELLS["psa"]).traffic, batch=2, batches=2, image_h=48,
               image_w=96, crops_per_image=2)
    batches = [(torch.from_numpy(i), torch.from_numpy(lab))
               for i, lab in traffic.training_batches(5, mix, 33)]
    mean, std = [123.7, 116.3, 103.5], [58.4, 57.1, 57.4]
    trainer = Trainer(prog, make_sgd(prog, r["base_lr"], r["momentum"], r["weight_decay"]),
                      classes=19, ignore_label=255, aux_weight=r["aux_weight"],
                      base_lr=r["base_lr"], max_iter=r["max_iter"], power=r["power"],
                      zoom_factor=8, rng_seed=11, normalize=(mean, std))
    losses = [float(trainer.step(*b)["loss"]) for b in batches[:1]]
    want_losses, want_grad, _, _ = ref_train.run_steps(ref, batches[:1], recipe=r, rng_seed=11,
                                                    mean=mean, std=std)
    assert abs(losses[0] - float(want_losses[0])) <= 1e-5 * abs(losses[0])
    names = {p: n for n, p in prog.named_parameters()}
    got = {names[p]: s["momentum_buffer"] for p, s in trainer.optimizer.state.items()}
    worst, leaf, _ = compare.leaf_gaps(compare.norms(got), compare.norms(want_grad))
    assert worst < 1e-3, leaf
