"""The port's public names and small helpers against the JAX package's:
the LR schedules, directory and port helpers of ``utils/misc.py``, the
``resnetN`` factories, the histograms, and the names the ``models``,
``utils`` and ``engine`` packages export."""

import socket

import numpy as np
import pytest
import torch

import semseg_torch.engine
import semseg_torch.models
import semseg_torch.utils
import semseg_tpu.engine
import semseg_tpu.models
import semseg_tpu.utils
from semseg_tpu.utils import misc as jmisc
from semseg_torch.models.resnet import SEG_DILATIONS, SEG_STRIDES, ResNet
from semseg_torch.parallel import dist as pdist
from semseg_torch.utils import misc

MAX_ITER = 100


@pytest.mark.parametrize("args,want", [
    # tests/test_utils.py's values
    ((0.01, 0, 100), 0.01),
    ((0.01, 50, 100, 0.9), 0.01 * 0.5 ** 0.9),
    ((0.01, 100, 100), 0.0),
])
def test_poly_learning_rate_reference_values(args, want):
    assert misc.poly_learning_rate(*args) == pytest.approx(want)
    assert misc.poly_learning_rate(*args) == jmisc.poly_learning_rate(*args)


@pytest.mark.parametrize("fn,args", [
    ("poly_learning_rate", [(0.01, it, MAX_ITER) for it in range(MAX_ITER + 1)]),
    ("poly_learning_rate", [(0.02, it, MAX_ITER, 1.5) for it in range(0, MAX_ITER + 1, 7)]),
    # past max_iter: no floor at 0, as JAX's (a negative LR)
    ("poly_learning_rate", [(0.01, MAX_ITER + 5, MAX_ITER, 1.0)]),
    ("step_learning_rate", [(0.1, e, 30) for e in range(MAX_ITER + 1)]),
    ("step_learning_rate", [(0.1, e, 7, 0.5) for e in range(0, MAX_ITER + 1, 3)]),
])
def test_schedules_equal_jax_across_iterations(fn, args):
    got = [getattr(misc, fn)(*a) for a in args]
    want = [getattr(jmisc, fn)(*a) for a in args]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("epoch,want", [(0, 0.1), (30, 0.01), (65, 0.001)])
def test_step_learning_rate_reference_values(epoch, want):
    assert misc.step_learning_rate(0.1, epoch=epoch, step_epoch=30) == pytest.approx(want)


def test_check_mkdir_and_check_makedirs(tmp_path):
    one = tmp_path / "a"
    misc.check_mkdir(str(one))
    misc.check_mkdir(str(one))  # exists: nothing
    assert one.is_dir()
    deep = tmp_path / "b" / "c"
    with pytest.raises(FileNotFoundError):
        misc.check_mkdir(str(deep))  # one level only, as JAX's
    misc.check_makedirs(str(deep))
    assert deep.is_dir()


def test_find_free_port_is_bindable_and_the_one_rendezvous_uses():
    port = misc.find_free_port()
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", port))
    assert pdist.find_free_port is misc.find_free_port
    assert not hasattr(pdist, "free_port")
    assert pdist.rendezvous_url(type("Cfg", (), {"world_size": 1})()).startswith(
        "tcp://127.0.0.1:")


def _tree(module):
    """The module tree: every submodule's name, type and repr (strides,
    dilations, channels), and every parameter's shape."""
    return ([(n, type(m).__name__, repr(m) if not list(m.children()) else "")
             for n, m in module.named_modules()],
            [(n, tuple(p.shape)) for n, p in module.named_parameters()])


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
def test_resnet_factories_build_the_segmentation_backbone(depth):
    """``resnetN()`` is ``ResNet(depth=N)`` at the segmentation strides and
    dilations; ``seg=False`` at the classification ones; what the caller
    names wins, and other keywords pass through."""
    ctor = getattr(semseg_torch.models, f"resnet{depth}")
    assert ctor.__name__ == f"resnet{depth}"
    with torch.device("meta"):  # shapes only: no weights allocated or drawn
        pairs = [
            (ctor(), ResNet(depth=depth, stage_strides=SEG_STRIDES,
                            stage_dilations=SEG_DILATIONS)),
            (ctor(seg=False), ResNet(depth=depth)),
            (ctor(stage_dilations=(1, 1, 1, 2), remat=True),
             ResNet(depth=depth, stage_strides=SEG_STRIDES, stage_dilations=(1, 1, 1, 2),
                    remat=True)),
        ]
    for got, want in pairs:
        assert _tree(got) == _tree(want)
        assert got.remat is want.remat


@pytest.mark.parametrize("package", ["models", "utils"])
def test_the_port_exports_every_public_name_of_jax(package):
    jax_pkg = getattr(semseg_tpu, package)
    port = getattr(semseg_torch, package)
    assert set(jax_pkg.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_engine_exports_or_maps_every_public_name_of_jax():
    port = semseg_torch.engine
    doc = port.__doc__
    for name in semseg_tpu.engine.__all__:
        assert name in port.__all__ or f"``{name}``" in doc, name
    for name in port.__all__:
        assert getattr(port, name) is not None
    mapped = [n for n in semseg_tpu.engine.__all__ if n not in port.__all__]
    assert sorted(mapped) == sorted(["SGDState", "sgd_init", "sgd_update", "make_lr_mult",
                                     "TrainState", "create_train_state", "make_train_step",
                                     "make_eval_step"])


def test_package_imports():
    from semseg_torch.engine import SlidingWindowEvaluator, Trainer  # noqa: F401
    from semseg_torch.models import PSANet, PSPNet, build_model, resnet50  # noqa: F401
    from semseg_torch.utils import poly_learning_rate, step_learning_rate  # noqa: F401


@pytest.mark.parametrize("name", ["intersection_and_union", "intersection_and_union_jax"])
def test_histograms_equal_jax(name):
    rs = np.random.RandomState(0)
    out = rs.randint(0, 6, (3, 17, 19))
    target = rs.randint(0, 6, (3, 17, 19))
    target[:, :2] = 255
    want = getattr(semseg_tpu.utils, name)(out, target, 6, 255)
    got = getattr(semseg_torch.utils, name)(torch.from_numpy(out), torch.from_numpy(target),
                                            6, 255)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
