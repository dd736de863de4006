"""Inputs made from ``--seed``: street-like images and label maps, the
serving pool and the training batches, and the seeds of everything else.

``street_sample`` is a copy of ``chip_smoke.py::street_sample``.
"""

from __future__ import annotations

import numpy as np


def seeds(seed: int, purpose: int, n: int):
    """``n`` 31-bit seeds for one purpose, from any whole ``seed`` (negative
    or past 64 bits included): distinct purposes draw unrelated streams."""
    entropy = [abs(int(seed)) % 2 ** 128, int(seed < 0), purpose]
    return [int(s) for s in np.random.SeedSequence(entropy).generate_state(n, np.uint32) >> 1]


WEIGHTS, IMAGES, CROPS, SAMPLE, DROPOUT = range(5)
# The recipes' input normalisation (ImageNet's, on 0-255 pixels).
MEAN = [0.485 * 255, 0.456 * 255, 0.406 * 255]
STD = [0.229 * 255, 0.224 * 255, 0.225 * 255]


def street_sample(seed, h=1024, w=2048):
    """A seeded street-like uint8 RGB image (sky band, buildings of random
    widths and colours, road with lane marks, pixel noise) and its
    Cityscapes label map (road 0, building 2, wall 3, vegetation 8, sky 10,
    ignore 255 on the bottom rows, where the ego vehicle would be)."""
    rs = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.float32)
    label = np.full((h, w), 10, np.uint8)
    yy = np.arange(h, dtype=np.float32)[:, None]
    horizon, road = int(h * rs.uniform(0.3, 0.4)), int(h * rs.uniform(0.6, 0.7))
    img[:horizon] = np.array([120, 170, 230]) + (yy[:horizon, :, None] / h) * 40
    x, k = 0, 0
    while x < w:
        bw = rs.randint(60, 300)
        img[horizon:road, x:x + bw] = rs.randint(40, 200, 3)
        label[horizon:road, x:x + bw] = (2, 8, 3)[k % 3]
        x, k = x + bw, k + 1
    img[road:] = [85, 85, 90]
    label[road:] = 0
    for lane in range(rs.randint(2, 5)):
        x0 = rs.randint(0, w - 40)
        img[road + 20:, x0:x0 + 12] = [230, 230, 230]
    img += rs.randint(-8, 9, img.shape)
    label[h - h // 16:] = 255
    return np.clip(img, 0, 255).astype(np.uint8), label


def serving_pool(seed: int, mix: dict):
    """The mix's ``pool`` distinct ``image_h x image_w`` images, in a fixed
    order."""
    h, w = mix["image_h"], mix["image_w"]
    return [street_sample(s, h, w)[0] for s in seeds(seed, IMAGES, mix["pool"])]


def training_batches(seed: int, mix: dict, crop: int):
    """``mix["batches"]`` batches of ``mix["batch"]`` ``crop x crop`` crops
    (uint8 NHWC images, uint8 labels), every row distinct: each street
    image gives ``crops_per_image`` crops at offsets drawn from the seed."""
    per = mix["crops_per_image"]
    n_rows = mix["batches"] * mix["batch"]
    n_images = -(-n_rows // per)
    h, w = mix["image_h"], mix["image_w"]
    rs = np.random.RandomState(seeds(seed, CROPS, 1)[0])
    images, labels = [], []
    for s in seeds(seed, IMAGES, n_images):
        img, lab = street_sample(s, h, w)
        for _ in range(per):
            y, x = rs.randint(0, h - crop + 1), rs.randint(0, w - crop + 1)
            images.append(img[y:y + crop, x:x + crop])
            labels.append(lab[y:y + crop, x:x + crop])
    images, labels = np.stack(images[:n_rows]), np.stack(labels[:n_rows])
    b = mix["batch"]
    return [(images[i:i + b], labels[i:i + b]) for i in range(0, n_rows, b)]
