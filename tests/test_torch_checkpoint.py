"""The port's checkpoints (``semseg_torch/engine/checkpoint.py``): the
counterparts of ``tests/test_checkpoint.py``'s tests of the JAX package's
orbax checkpoints, on ``torch.save`` files, and the trainer's state dict."""

import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from semseg_torch.engine import checkpoint as ckpt
from semseg_torch.engine.trainer import Trainer
from semseg_torch.models.convert import backbone_from_imagenet_pth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0, step=7):
    """A trained-looking state: weights, BN statistics, SGD momentum."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(2, 3, 5, 5)).square().sum().backward()
    opt.step()
    return {"step": step, "state_dict": model.state_dict(), "optimizer": opt.state_dict()}


def _assert_same(got, want):
    assert got["step"] == want["step"]
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    for k, v in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][k]["momentum_buffer"], v["momentum_buffer"])
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]


def test_save_restore_round_trip(tmp_path):
    """``train_epoch_3.pth`` holds epoch, step, weights and optimizer, and
    reads back with ``weights_only=True`` as JAX's
    ``load_torch_checkpoint`` (``convert.py:166-173``) needs."""
    state = _state()
    path = ckpt.save_checkpoint(str(tmp_path), 3, state)
    assert path == str(tmp_path / "train_epoch_3.pth")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert sorted(payload) == ["epoch", "optimizer", "state_dict", "step"]
    assert payload["epoch"] == 3
    _assert_same(payload, state)
    assert sorted(os.listdir(tmp_path)) == ["train_epoch_3.pth"]  # no .tmp left


def test_async_save_holds_the_snapshot(tmp_path):
    """``save_checkpoint_async`` copies the state to the host before it
    returns: changing the tensors while the write is in flight does not
    reach the file."""
    state = _state()
    want = ckpt.host_snapshot(state)
    path = ckpt.save_checkpoint_async(str(tmp_path), 3, state)
    for v in state["state_dict"].values():
        v.zero_()
    for s in state["optimizer"]["state"].values():
        s["momentum_buffer"].zero_()
    ckpt.wait_pending()
    _assert_same(ckpt.load_checkpoint(path), want)


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", boom)
    ckpt.save_checkpoint_async(str(tmp_path), 1, _state())
    with pytest.raises(RuntimeError, match="disk full"):
        ckpt.wait_pending()
    ckpt.wait_pending()  # the error is consumed; later waits are clean


def test_async_save_retention_matches_sync(tmp_path):
    """Async and sync saves keep the same files with the same contents."""
    for kind, save in (("sync", ckpt.save_checkpoint), ("async", ckpt.save_checkpoint_async)):
        for epoch in range(1, 6):
            save(str(tmp_path / kind), epoch, _state(step=epoch), save_freq=1, keep=2)
        ckpt.wait_pending()
    for kind in ("sync", "async"):
        assert sorted(os.listdir(tmp_path / kind)) == ["train_epoch_4.pth", "train_epoch_5.pth"]
    for name in ("train_epoch_4.pth", "train_epoch_5.pth"):
        a = ckpt.load_checkpoint(str(tmp_path / "sync" / name))
        b = ckpt.load_checkpoint(str(tmp_path / "async" / name))
        assert a["epoch"] == b["epoch"]
        _assert_same(a, b)


@pytest.mark.parametrize("save_freq", [1, 2])
def test_rolling_retention_keeps_two(tmp_path, save_freq):
    """Keep-2: a save deletes the one ``save_freq * keep`` epochs older,
    and the preemption snapshot."""
    state = _state()
    ckpt.save_preempt_checkpoint(str(tmp_path), 0, state)
    for epoch in range(save_freq, 5 * save_freq + 1, save_freq):
        ckpt.save_checkpoint(str(tmp_path), epoch, state, save_freq=save_freq, keep=2)
    assert set(os.listdir(tmp_path)) == {f"train_epoch_{4 * save_freq}.pth",
                                         f"train_epoch_{5 * save_freq}.pth"}


def test_latest_checkpoint_discovery(tmp_path):
    """None for an empty or missing folder; the highest epoch (by number,
    not by name); the preemption snapshot before any epoch save."""
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    state = _state()
    ckpt.save_checkpoint(str(tmp_path), 2, state, keep=10)
    ckpt.save_checkpoint(str(tmp_path), 10, state, keep=10)
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "train_epoch_10.pth")
    path = ckpt.save_preempt_checkpoint(str(tmp_path), 10, state)
    assert path == str(tmp_path / "train_preempt.pth")
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    payload = ckpt.load_checkpoint(path)
    assert payload["epoch"] == 10 and payload["step"] == 7


def test_load_state_dict_any(tmp_path):
    """A port checkpoint, a DDP ``module.`` file and a bare state_dict give
    the same state_dict; a JAX orbax directory raises and names the
    exporter."""
    state = _state()
    sd = state["state_dict"]
    port = ckpt.save_checkpoint(str(tmp_path), 1, state)
    ddp = str(tmp_path / "ddp.pth")
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v for k, v in sd.items()}}, ddp)
    bare = str(tmp_path / "bare.pth")
    torch.save(sd, bare)
    for path in (port, ddp, bare):
        got = ckpt.load_state_dict_any(path)
        assert sorted(got) == sorted(sd)
        assert all(torch.equal(got[k], v) for k, v in sd.items())
    orbax = tmp_path / "train_epoch_1.ckpt"
    orbax.mkdir()
    with pytest.raises(ValueError, match="export_format pth"):
        ckpt.load_state_dict_any(str(orbax))


def test_mid_write_killed_save_falls_back(tmp_path, caplog):
    """A process killed inside a save (after ``torch.save`` wrote the
    ``.tmp`` file, before the rename) leaves no ``train_epoch_2.pth``;
    ``latest_checkpoint`` skips the ``.tmp`` with a warning and returns
    epoch 1."""
    script = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        import torch
        from semseg_torch.engine import checkpoint as ckpt
        state = {{"step": 3, "state_dict": {{"w": torch.ones(2, 2)}}, "optimizer": {{}}}}
        ckpt.save_checkpoint({str(tmp_path)!r}, 1, state)
        ckpt.os.replace = lambda src, dst: os._exit(9)  # dies before the rename
        ckpt.save_checkpoint({str(tmp_path)!r}, 2, state)
        """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True)
    assert proc.returncode == 9, proc.stderr
    assert sorted(os.listdir(tmp_path)) == ["train_epoch_1.pth", "train_epoch_2.pth.tmp"]
    with caplog.at_level(logging.WARNING, logger=ckpt.__name__):
        latest = ckpt.latest_checkpoint(str(tmp_path))
    assert latest == str(tmp_path / "train_epoch_1.pth")
    assert "train_epoch_2.pth.tmp" in caplog.text
    payload = ckpt.load_checkpoint(latest)
    assert payload["epoch"] == 1 and payload["step"] == 3


def test_incomplete_preempt_snapshot_falls_back(tmp_path, caplog):
    """A preemption snapshot killed mid-write is only a ``.tmp`` file, so
    it never outranks the epoch save."""
    ckpt.save_checkpoint(str(tmp_path), 4, _state())
    (tmp_path / "train_preempt.pth.tmp").write_bytes(b"partial")
    with caplog.at_level(logging.WARNING, logger=ckpt.__name__):
        assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "train_epoch_4.pth")
    assert "train_preempt.pth.tmp" in caplog.text


def test_trainer_state_dict_round_trip(tmp_path):
    """``Trainer.state_dict`` through a file into a fresh trainer gives
    the same model, momentum and step, and the next step is identical in
    both (the LR and the dropout stream follow the step)."""
    def make(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Conv2d(3, 5, 3, padding=1),
                                    torch.nn.BatchNorm2d(5))

        class Seg(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.layer1, self.cls = model, torch.nn.Conv2d(5, 5, 1)

            def forward(self, x):
                y = self.cls(self.layer1(x))
                return (y, y * 0.5) if self.training else y

        seg = Seg()
        from semseg_torch.engine.optim import make_sgd

        return Trainer(seg, make_sgd(seg, 0.01), classes=5, ignore_label=255,
                       aux_weight=0.4, base_lr=0.01, max_iter=10, power=0.9, zoom_factor=8)

    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.randn(2, 9, 9, 3).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 5, (2, 9, 9)))
    a = make(0)
    for _ in range(3):
        a.step(images, labels)
    path = ckpt.save_checkpoint(str(tmp_path), 1, a.state_dict())
    b = make(1)
    b.load_state_dict(ckpt.load_checkpoint(path))
    assert b.step_count == 3
    ma, mb = a.step(images, labels), b.step(images, labels)
    assert ma["loss"].item() == mb["loss"].item() and ma["lr"] == mb["lr"]
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k


def test_backbone_from_imagenet_pth(tmp_path):
    """A deep-base ImageNet ResNet file (``conv1``/``bn1`` .. ``bn3`` stem,
    ``layer1``-``layer4``, ``fc``) maps onto ``layer0``-``layer4``; ``fc.*``
    is dropped silently, blocks beyond the depth and other keys come back
    as unused."""
    from semseg_torch.models.resnet import ResNet

    sd = ResNet(depth=50).state_dict()
    stem = {"layer0.0": "conv1", "layer0.1": "bn1", "layer0.3": "conv2",
            "layer0.4": "bn2", "layer0.6": "conv3", "layer0.7": "bn3"}
    imagenet = {}
    for k, v in sd.items():
        head = ".".join(k.split(".")[:2])
        imagenet[k.replace(head, stem[head], 1) if head in stem else k] = v
    imagenet.update({"fc.weight": torch.zeros(10, 2048), "fc.bias": torch.zeros(10),
                     "layer3.6.conv1.weight": torch.zeros(1), "extra.w": torch.zeros(1)})
    path = str(tmp_path / "resnet50_v2.pth")
    torch.save(imagenet, path)
    got, unused = backbone_from_imagenet_pth(path, 50)
    assert unused == ["extra.w", "layer3.6.conv1.weight"]
    assert sorted(got) == sorted(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
