"""The port's training driver against the JAX package's, on the CPU:
checkpoints, preemption and exact resume, start-up loads and validation
(the counterparts of ``tests/test_integration.py:71-94, 121-135,
192-267``), and its validation step against ``make_eval_step``. Data are
seeded synthetic PNGs with a list file (``tests/driver_data.py``); every
``.pth`` is written by the test."""

import logging
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driver_data import CLASSES, IGNORE, cfg as _cfg, threads as _threads  # noqa: F401
from driver_data import write_dataset as _write_dataset
from semseg_torch import train
from semseg_torch.engine import checkpoint as ckpt


def _assert_same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"]), k
    assert a.step_count == b.step_count


# ------------------------------------------------------------- train driver


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The data and an uninterrupted run: 2 epochs of 2 steps."""
    root = tmp_path_factory.mktemp("resume")
    _write_dataset(root)
    full = train.run(_cfg(root, "save_path", str(root / "full")), "cpu")
    assert full["trainer"].step_count == 4 and full["trainer"].model.cls[3].p == 0.1
    assert [os.path.basename(p) for p in full["checkpoints"]] == ["train_epoch_1.pth",
                                                                   "train_epoch_2.pth"]
    return root, full["trainer"]


@pytest.mark.parametrize("preempt_after", [3, 2])
def test_preemption_snapshot_and_exact_resume(uninterrupted, preempt_after):
    """2 epochs of 2 steps, dropout on (0.1). A run stopped after global
    step 3 (mid-epoch) or 2 (an epoch's last step) leaves
    ``train_preempt.pth``; ``resume auto`` runs the remaining steps and
    ends bit for bit where the uninterrupted run ends: weights, BN
    statistics, momentum and step. The resumed epoch save deletes the
    snapshot; keep-2 holds the epoch saves."""
    root, full = uninterrupted
    tmp_path = root / f"after{preempt_after}"
    pre = train.run(_cfg(root, "save_path", str(tmp_path / "exp"),
                         _preempt_after_step=preempt_after), "cpu")
    assert pre["trainer"].step_count == preempt_after
    assert pre["preempt"] == str(tmp_path / "exp" / "train_preempt.pth")
    snap = ckpt.load_checkpoint(pre["preempt"])
    assert (snap["epoch"], snap["step"]) == ((preempt_after - 1) // 2, preempt_after)

    res = train.run(_cfg(root, "save_path", str(tmp_path / "exp"), "resume", "auto"), "cpu")
    assert res["preempt"] is None and res["trainer"].step_count == 4
    _assert_same_state(full, res["trainer"])
    # Stopped at an epoch's last step, that epoch's save never ran.
    saved = ["train_epoch_1.pth"] if preempt_after == 3 else []
    assert sorted(os.listdir(tmp_path / "exp")) == ["scalars.jsonl", *saved,
                                                    "train_epoch_2.pth"]
    final = ckpt.load_checkpoint(str(tmp_path / "exp" / "train_epoch_2.pth"))
    assert (final["epoch"], final["step"]) == (2, 4)


def test_signal_asks_for_a_snapshot(tmp_path):
    """SIGUSR1 during step 1 stops the run at that step boundary with a
    snapshot; the previous handler is back after ``run``."""
    _write_dataset(tmp_path)
    before = signal.getsignal(signal.SIGUSR1)
    res = train.run(_cfg(tmp_path, "async_save", "False"), "cpu",
                    step_hook=lambda it, m: os.kill(os.getpid(), signal.SIGUSR1))
    assert res["trainer"].step_count == 1 and os.path.isfile(res["preempt"])
    assert ckpt.load_checkpoint(res["preempt"])["step"] == 1
    assert signal.getsignal(signal.SIGUSR1) is before


def test_start_up_loads(tmp_path, caplog):
    """With ``base_lr 0`` the weights after training are the weights
    loaded: ``initmodel`` (a deep-base ImageNet ``.pth`` with ``fc``)
    gives the backbone, the heads keep the seeded init; ``weight`` loads
    over it (the reference's order); a missing ``weight`` file is logged
    and skipped."""
    from semseg_torch.models.build import build_model
    from semseg_torch.models.resnet import ResNet

    _write_dataset(tmp_path)
    torch.manual_seed(5)
    backbone = ResNet(depth=50)
    for m in backbone.modules():  # non-default statistics, so a load shows
        if isinstance(m, torch.nn.BatchNorm2d):
            m.weight.data.uniform_(0.5, 1.5)
    stem = {"layer0.0": "conv1", "layer0.1": "bn1", "layer0.3": "conv2", "layer0.4": "bn2",
            "layer0.6": "conv3", "layer0.7": "bn3"}
    imagenet = {}
    for k, v in backbone.state_dict().items():
        head = ".".join(k.split(".")[:2])
        imagenet[k.replace(head, stem[head], 1) if head in stem else k] = v
    imagenet.update({"fc.weight": torch.ones(10, 2048), "fc.bias": torch.ones(10)})
    torch.save(imagenet, str(tmp_path / "resnet50_v2.pth"))

    base = dict(base_lr=0.0, epochs=1, batch_size=4,  # one step
                initmodel=str(tmp_path / "resnet50_v2.pth"))
    res = train.run(_cfg(tmp_path, **base), "cpu")
    got = dict(res["trainer"].model.named_parameters())
    for k, v in backbone.named_parameters():
        assert torch.equal(got[k], v), k
    fresh = build_model(_cfg(tmp_path), device="cpu", seed=3, train=True)
    for k, v in fresh.named_parameters():
        if not k.startswith("layer"):
            assert torch.equal(got[k], v), k

    weight = build_model(_cfg(tmp_path), device="cpu", seed=11)
    torch.save({"state_dict": {f"module.{k}": v for k, v in weight.state_dict().items()}},
               str(tmp_path / "w.pth"))
    res = train.run(_cfg(tmp_path, weight=str(tmp_path / "w.pth"),
                         save_path=str(tmp_path / "exp2"), **base), "cpu")
    got = dict(res["trainer"].model.named_parameters())
    for k, v in weight.named_parameters():
        assert torch.equal(got[k], v), k
    logger = logging.getLogger("drivers-test")
    with caplog.at_level(logging.INFO, logger="drivers-test"):
        train._load_start(_cfg(tmp_path, weight=str(tmp_path / "absent.pth"), pretrained=False),
                          weight, logger)
    assert "no weight found" in caplog.text
    assert all(torch.equal(got[k], v) for k, v in weight.named_parameters())


def test_validation_with_a_partial_batch(tmp_path, caplog):
    """``evaluate True``: 3 validation images at ``batch_size_val 2`` (the
    second batch padded with an ignore-labelled filler) give the stats of
    the same weights at ``batch_size_val 1``, and the reference's lines."""
    _write_dataset(tmp_path)
    cfg = _cfg(tmp_path, "evaluate", "True", "epochs", "1")
    logger = logging.getLogger("drivers-test")
    with caplog.at_level(logging.INFO, logger="drivers-test"):
        res = train.run(cfg, "cpu", logger=logger)
    (val,) = res["val"]
    assert all(np.isfinite(v) for v in val.values()) and 0.0 <= val["mIoU"] <= 1.0
    assert "Val result: mIoU/mAcc/allAcc" in caplog.text
    assert f"Class_{CLASSES - 1} Result: iou/accuracy" in caplog.text
    one = _cfg(tmp_path, "evaluate", "True", "batch_size_val", "1")
    again = train._validate(one, logger, res["trainer"], train.build_val_loader(one), "cpu",
                            np.float32, True)
    for k in ("mIoU", "mAcc", "allAcc"):
        assert again[k] == val[k], k
    np.testing.assert_allclose(again["loss"], val["loss"], rtol=1e-6)
    assert res["trainer"].model.training


@pytest.mark.parametrize("zoom", [8, 4])
def test_eval_step_matches_jax(zoom):
    """``eval_step`` against ``make_eval_step`` on one PSPNet50 (4 classes,
    25x25 crops) with the same weights: the CE sum within 1e-5 relative,
    the valid count exact, the histograms but near-ties (at most 4
    pixels). ``zoom_factor 4`` resizes the logits to the labels."""
    from semseg_tpu.engine.trainer import make_eval_step
    from semseg_tpu.models.pspnet import PSPNet as JPSPNet
    from semseg_torch.engine.trainer import eval_step
    from semseg_torch.models.convert import state_dict_from_jax
    from semseg_torch.models.pspnet import PSPNet

    jmodel = JPSPNet(layers=50, classes=4, zoom_factor=zoom)
    v = jax.jit(lambda k, x: jmodel.init({"params": k, "dropout": k}, x, train=True))(
        jax.random.PRNGKey(1), jnp.zeros((2, 25, 25, 3), jnp.float32))
    v = jax.tree.map(np.asarray, v)
    rs = np.random.RandomState(zoom)
    images = rs.randint(0, 256, (2, 25, 25, 3)).astype(np.uint8)
    labels = rs.randint(0, 4, (2, 25, 25)).astype(np.uint8)
    labels[1, :6] = IGNORE
    norm = (train.IMAGENET_MEAN, train.IMAGENET_STD)
    want = jax.device_get(make_eval_step(jmodel, classes=4, ignore_label=IGNORE,
                                         zoom_factor=zoom, normalize=norm)(
        v, jnp.asarray(images), jnp.asarray(labels)))

    model = PSPNet(layers=50, classes=4, zoom_factor=zoom)
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    got = eval_step(model.eval(), torch.from_numpy(images), torch.from_numpy(labels),
                    classes=4, ignore_label=IGNORE, zoom_factor=zoom, normalize=norm)
    np.testing.assert_allclose(got["loss_sum"].item(), float(want["loss_sum"]), rtol=1e-5)
    assert got["valid_count"].item() == float(want["valid_count"])
    for k in ("intersection", "union", "target"):
        assert np.abs(got[k].numpy() - np.asarray(want[k])).sum() <= 4, k
