"""The port's native host pipeline (``semseg_torch/data/native.py``, the
unchanged ``csrc/hostpipe.cpp`` built into ``build/semseg_torch_host/``)
against the port's Python pipeline and against the JAX package's native
wrapper, on the CPU.

The parity contract is ``tests/test_native_pipe.py``'s: the random
parameters are the same draws by construction; the pixel kernels run in
the system OpenCV (C++) and in the cv2 wheel (Python pipeline). Without
rotation labels are bit for bit equal and images within 2e-5 (normalised,
f32 SIMD order); warpAffine's 1/32 sub-pixel bins differ between the two
builds at ties, so with rotation under 1 % of label pixels may move. Against
the JAX package's wrapper, on the same system OpenCV, every sample is equal
bit for bit."""

import logging

import cv2
import numpy as np
import pytest

from semseg_torch.data import DataLoader, SemData, native, transform
from semseg_torch.data.transform import _default_rng, per_sample_rng

MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]
CROP = 33


@pytest.fixture(scope="module")
def png_dataset(tmp_path_factory):
    """8 images of 4 shapes (some smaller than the crop: padding) with
    5-class label PNGs."""
    root = tmp_path_factory.mktemp("nativedata")
    rs = np.random.RandomState(7)
    lines = []
    for i, (h, w) in enumerate([(40, 56), (64, 48), (30, 30), (80, 100)] * 2):
        cv2.imwrite(str(root / f"img{i}.png"), (rs.rand(h, w, 3) * 255).astype(np.uint8))
        cv2.imwrite(str(root / f"lab{i}.png"), rs.randint(0, 5, size=(h, w)).astype(np.uint8))
        lines.append(f"img{i}.png lab{i}.png\n")
    (root / "list.txt").write_text("".join(lines))
    assert native.available(), native.build_error()
    return str(root), str(root / "list.txt")


def _python(root, lst, rotate=True):
    chain = [transform.RandScale([0.5, 2.0])]
    if rotate:
        chain.append(transform.RandRotate([-10, 10], padding=MEAN, ignore_label=255))
    chain += [transform.RandomGaussianBlur(), transform.RandomHorizontalFlip(),
              transform.Crop([CROP, CROP], crop_type="rand", padding=MEAN, ignore_label=255),
              transform.ToTensor(), transform.Normalize(mean=MEAN, std=STD)]
    return SemData("train", root, lst, transform=transform.Compose(chain))


def _native(root, lst, rotate=True, module=native, **kw):
    return module.NativeSemData("train", root, lst, crop_h=CROP, crop_w=CROP, mean=MEAN,
                                std=STD, ignore_label=255, crop_type="rand", scale=(0.5, 2.0),
                                rotate=(-10, 10) if rotate else None, **kw)


def _pairs(a, b, epochs=3, rng_b=per_sample_rng):
    """Sample pairs of ``a`` and ``b`` under the same per-sample streams
    (``rng_b``: the stream context of ``b``'s package)."""
    for epoch in range(epochs):
        for idx in range(len(a)):
            with per_sample_rng(11, epoch, idx):
                got = a[idx]
            with rng_b(11, epoch, idx):
                want = b[idx]
            yield (epoch, idx), got, want


def test_native_matches_python_without_rotation(png_dataset):
    """Scale, blur, flip, pad, crop, normalise: labels bit for bit, images
    within 2e-5."""
    root, lst = png_dataset
    padded = False
    for at, (img, lab), (img_py, lab_py) in _pairs(_native(root, lst, rotate=False),
                                                   _python(root, lst, rotate=False)):
        np.testing.assert_array_equal(lab, lab_py, err_msg=str(at))
        np.testing.assert_allclose(img, img_py, atol=2e-5, rtol=0, err_msg=str(at))
        padded |= bool((lab_py == 255).any())
    assert padded


def test_native_rotation_within_library_variance(png_dataset):
    """The full recipe with rotation: under 1 % of label pixels and a mean
    image drift under 2e-2 (noise images, the worst case) differ, and only
    where the rotation branch ran."""
    root, lst = png_dataset
    fired = diverged = 0
    for (epoch, idx), (img, lab), (img_py, lab_py) in _pairs(_native(root, lst),
                                                             _python(root, lst)):
        with per_sample_rng(11, epoch, idx):  # the scale draw, then the rotation gate
            _default_rng.random()
            fired += _default_rng.random() < 0.5
        frac = float((lab != lab_py).mean())
        assert frac < 0.01 and float(np.abs(img - img_py).mean()) < 2e-2, (epoch, idx)
        diverged += frac > 0
    assert 0 < fired and diverged <= fired


def test_native_matches_the_jax_packages_wrapper(png_dataset):
    """The same source on the same OpenCV: the port's samples equal those
    of ``semseg_tpu.data.native`` (its prebuilt extension) bit for bit,
    rotation included, normalised and raw."""
    from semseg_tpu.data import native as jnative
    from semseg_tpu.data.transform import per_sample_rng as jax_rng

    if not jnative.available():
        pytest.skip("the JAX package's native extension is not built")
    root, lst = png_dataset
    for normalize in (True, False):
        for at, (img, lab), (jimg, jlab) in _pairs(
                _native(root, lst, normalize=normalize),
                _native(root, lst, module=jnative, normalize=normalize), epochs=2,
                rng_b=jax_rng):
            np.testing.assert_array_equal(lab, jlab, err_msg=str(at))
            np.testing.assert_array_equal(img, jimg, err_msg=str(at))


def test_native_through_the_loader(png_dataset):
    """``DataLoader`` over the native dataset equals it over the Python
    pipeline (same seed and epoch, threaded fetch)."""
    root, lst = png_dataset
    loaders = [DataLoader(d, batch_size=4, shuffle=True, num_workers=2, seed=5)
               for d in (_python(root, lst, rotate=False), _native(root, lst, rotate=False))]
    for loader in loaders:
        loader.set_epoch(2)
    batches = 0
    for (pi, pl), (ni, nl) in zip(*loaders):
        np.testing.assert_allclose(ni, pi, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(nl, pl)
        batches += 1
    assert batches == 2


def test_train_loader_picks_the_pipeline(png_dataset, monkeypatch, caplog):
    """``native_loader: True`` gives the native pipeline, raw pixels on the
    uint8 wire; when the extension cannot be built, a warning that says why
    and the Python pipeline."""
    from types import SimpleNamespace

    from semseg_torch.train import build_train_loader

    root, lst = png_dataset
    cfg = SimpleNamespace(data_root=root, train_list=lst, ignore_label=255, scale_min=0.5,
                          scale_max=2.0, rotate_min=-10, rotate_max=10, train_h=CROP,
                          train_w=CROP, batch_size=4, workers=2, manual_seed=0,
                          native_loader=True, image_wire_dtype="uint8")
    logger = logging.getLogger("native-test")
    with caplog.at_level(logging.INFO, logger="native-test"):
        loader, normalize = build_train_loader(cfg, logger)
    assert loader.pipeline == "native" and normalize is not None
    assert "native (C++) host data pipeline enabled" in caplog.text
    images, labels = next(iter(loader))
    assert images.dtype == np.uint8 and images.shape == (4, CROP, CROP, 3)
    monkeypatch.setattr(native, "_load", lambda: (None, "RuntimeError: no g++"))
    with caplog.at_level(logging.WARNING, logger="native-test"):
        loader, _ = build_train_loader(cfg, logger)
    assert loader.pipeline == "python" and "no g++" in caplog.text
