"""The per-shape caches behind the evaluator are bounded (``utils/misc.py::
CACHE_ENTRIES``): the resize matrices (the numpy ``lru_cache``s and their
tensors), the window coverage and the evaluator's geometries. An image
stream of ever new sizes (ADE20K's validation images, a server's clients)
keeps at most the bound in each, and the predictions do not move: an
evicted size met again, and an image through a fresh evaluator with every
cache emptied, give the same bits."""

import numpy as np
import pytest
import torch

from semseg_torch.engine import evaluator as teval
from semseg_torch.ops import resize
from semseg_torch.utils.misc import CACHE_ENTRIES, LRU, tensor_cache

SCALES = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75]
CROP, BASE, CLASSES = 17, 32, 5


class _TinyNet(torch.nn.Module):
    """Two 3x3 convolutions, logits at the window's size."""

    dtype = torch.float32
    zoom_factor = 1

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.a = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.b = torch.nn.Conv2d(8, CLASSES, 3, padding=1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)

    def forward(self, x, zoom=True):
        return self.b(torch.relu(self.a(x)))


def _evaluator(model):
    return teval.SlidingWindowEvaluator(
        model, classes=CLASSES, crop_h=CROP, crop_w=CROP, mean=[120.0, 110.0, 100.0],
        std=[60.0, 60.0, 60.0], base_size=BASE, scales=SCALES, window_batch=4, device="cpu")


def _clear():
    for fn in (resize.interp_matrix, teval._coverage, resize._interp_matrix_half_pixel,
               resize._interp_matrix):
        fn.cache_clear()


def _sizes(n):
    rs = np.random.RandomState(3)
    out = []
    while len(out) < n:
        hw = (int(rs.randint(12, 48)), int(rs.randint(12, 48)))
        if hw not in out:
            out.append(hw)
    return out


def _entries(ev):
    return {"geometries": len(ev._geometries), "interp_matrix": len(resize.interp_matrix.cache),
            "coverage": len(teval._coverage.cache),
            "numpy_half_pixel": resize._interp_matrix_half_pixel.cache_info().currsize}


def test_more_sizes_than_the_bound_keep_the_bound_and_the_bits():
    _clear()
    model = _TinyNet().eval()
    ev = _evaluator(model)
    rs = np.random.RandomState(0)
    # 6 scales a size: 14 sizes make 84 geometries, past the bound of 64
    images = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in _sizes(14)]
    first = None
    for k, img in enumerate(images):
        probs = ev.predict_probs(img)
        first = probs if k == 0 else first
        entries = _entries(ev)
        assert all(v <= CACHE_ENTRIES for v in entries.values()), (k, entries)
    assert entries["geometries"] == entries["interp_matrix"] == CACHE_ENTRIES, entries

    # the first size is gone from the geometries and the resize matrices
    h0, w0 = images[0].shape[:2]
    assert not any((h0, w0, s) in ev._geometries for s in SCALES)
    sizes = [teval._scaled_size(h0, w0, s, BASE) for s in SCALES]
    evicted = [(a, b, True, torch.device("cpu")) not in resize.interp_matrix.cache
               for nh, nw in sizes for a, b in ((h0, nh), (w0, nw))]
    assert any(evicted)
    np.testing.assert_array_equal(ev.predict_probs(images[0]), first)

    last = ev.predict_probs(images[-1])
    pred = ev.predict(images[-1])
    _clear()
    fresh = _evaluator(model)
    np.testing.assert_array_equal(fresh.predict_probs(images[-1]), last)
    np.testing.assert_array_equal(fresh.predict(images[-1]), pred)


def test_lru_drops_the_least_recently_used():
    cache = LRU(3)
    for k in "abc":
        cache.put(k, k.upper())
    assert cache.get("a") == "A"  # a is now the most recent
    cache.put("d", "D")
    assert "b" not in cache and all(k in cache for k in "acd")
    cache.put("c", "C2")  # c is now the most recent, a the least
    cache.put("e", "E")
    assert "a" not in cache and all(k in cache for k in "cde")
    assert cache.values() == ["D", "C2", "E"] and cache.get("c") == "C2"
    assert cache.get("b", "missing") == "missing" and len(cache) == 3
    cache.clear()
    assert len(cache) == 0 and cache.values() == []


@pytest.mark.parametrize("keys", [CACHE_ENTRIES - 1, CACHE_ENTRIES, 3 * CACHE_ENTRIES])
def test_tensor_cache_keeps_the_recent_keys(keys):
    calls = []

    @tensor_cache
    def build(n):
        calls.append(n)
        return torch.full((2,), float(n))

    for n in range(keys):
        assert build(n)[0].item() == n
    assert len(build.cache) == min(keys, CACHE_ENTRIES)
    recent = list(range(max(0, keys - CACHE_ENTRIES), keys))
    assert all((n,) in build.cache for n in recent)
    before = len(calls)
    for n in recent:  # cached: nothing rebuilt
        build(n)
    assert len(calls) == before
    if keys > CACHE_ENTRIES:  # an evicted key is built again, with the same value
        assert build(0)[0].item() == 0 and len(calls) == before + 1
