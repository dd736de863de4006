"""The port's own host side (``semseg_torch.config``, ``semseg_torch.data``)
against the JAX package's modules it was copied from: the same configs,
the same augmented samples byte for byte, the same loader order."""

import glob
import os

import cv2
import numpy as np
import pytest

from semseg_torch import config as tconfig
from semseg_torch import data as tdata
from semseg_tpu import config as jconfig
from semseg_tpu import data as jdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "config", "**", "*.yaml"), recursive=True))
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
IGNORE = 255


def test_the_configs_are_there():
    assert len(CONFIGS) == 12


@pytest.mark.parametrize("path", CONFIGS)
def test_config_parses_the_same(path):
    """Every repo config, alone and with ``KEY VALUE`` overrides (a
    number, a list coerced to the original's type, a dotted key, an
    extension key), gives equal attributes; a bad override raises alike."""
    path = os.path.join(REPO, path)
    overrides = ["batch_size", "4", "TRAIN.base_lr", "0.5", "train_gpu", "(0, 1)",
                 "compute_dtype", "bfloat16", "save_path", "exp/some/where"]
    for argv in (["--config", path], ["--config", path, *overrides]):
        got = tconfig.parse_config_args(argv)
        want = jconfig.parse_config_args(argv)
        assert isinstance(got, tconfig.Config)
        assert dict(got) == dict(want)
        assert got.batch_size == want.batch_size and str(got) == str(want)
    for bad in (["no_such_key", "1"], ["batch_size", "'sixteen'"], ["batch_size"]):
        with pytest.raises((KeyError, ValueError)) as want_exc:
            jconfig.parse_config_args(["--config", path, *bad])
        with pytest.raises(want_exc.type):
            tconfig.parse_config_args(["--config", path, *bad])


def _write_dataset(root, n=6, h=40, w=52, classes=5):
    rs = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    lines = []
    for k in range(n):
        cv2.imwrite(os.path.join(root, "img", f"{k}.png"),
                    rs.randint(0, 256, (h + k, w, 3)).astype(np.uint8))
        label = rs.randint(0, classes, (h + k, w)).astype(np.uint8)
        label[:3] = IGNORE
        cv2.imwrite(os.path.join(root, "img", f"{k}_label.png"), label)
        lines.append(f"img/{k}.png img/{k}_label.png")
    path = os.path.join(root, "train.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _train_data(mod, root, data_list, uint8):
    """The training pipeline of ``semseg_torch.train.build_train_loader``
    built from ``mod`` (either package's data module)."""
    t = mod.transform
    chain = [
        t.RandScale([0.5, 2.0]),
        t.RandRotate([-10, 10], padding=MEAN, ignore_label=IGNORE),
        t.RandomGaussianBlur(),
        t.RandomHorizontalFlip(),
        t.Crop([33, 33], crop_type="rand", padding=MEAN, ignore_label=IGNORE),
        t.ToTensor(),
    ] + ([] if uint8 else [t.Normalize(mean=MEAN, std=STD)])
    data = mod.SemData(split="train", data_root=str(root), data_list=data_list,
                       transform=t.Compose(chain))
    return mod.Uint8Wire(data) if uint8 else data


@pytest.mark.parametrize("uint8", [False, True])
def test_train_transform_stream_is_byte_identical(tmp_path, uint8):
    """From the same per-sample seed, every augmented sample (float32 or
    the uint8 wire) is byte-identical."""
    data_list = _write_dataset(tmp_path)
    got_data = _train_data(tdata, tmp_path, data_list, uint8)
    want_data = _train_data(jdata, tmp_path, data_list, uint8)
    assert len(got_data) == len(want_data) == 6
    for epoch in (0, 1):
        for index in range(len(got_data)):
            with tdata.transform.per_sample_rng(3, epoch, index):
                got = got_data[index]
            with jdata.transform.per_sample_rng(3, epoch, index):
                want = want_data[index]
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert g.tobytes() == w.tobytes(), (epoch, index)


@pytest.mark.parametrize("num_workers,drop_last", [(0, True), (2, False)])
def test_loader_gives_the_same_batches(tmp_path, num_workers, drop_last):
    """``DataLoader``: the same length, order and batches over two epochs
    and a mid-epoch restart, with threads or without."""
    data_list = _write_dataset(tmp_path)

    def batches(mod, epoch, start_batch=0):
        loader = mod.DataLoader(_train_data(mod, tmp_path, data_list, True), batch_size=4,
                                shuffle=True, num_workers=num_workers,
                                drop_last=drop_last, seed=5)
        loader.set_epoch(epoch, start_batch)
        return len(loader), loader.sampler.indices(), list(loader)

    for epoch, start in ((0, 0), (1, 0), (1, 1)):
        got, want = batches(tdata, epoch, start), batches(jdata, epoch, start)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[2]) == len(want[2]) == want[0] - start
        for (gi, gl), (wi, wl) in zip(got[2], want[2]):
            assert gi.tobytes() == wi.tobytes() and gl.tobytes() == wl.tobytes()
