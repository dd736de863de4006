"""Where the bf16 spatial partition departs from one device, on the card.

For a small PSANet50 (97x97 windows of a 128x256 image, the card test's)
and for PSPNet50 and PSANet50 at full width (1024x2048 street image), over
``devices=[cuda:0, cuda:0]``:

- the bf16 spatial partition against the bf16 single-device evaluator, and
  beside it the single device against itself at half the window batch (a
  shape change with the same arithmetic) and both bf16 results against the
  f32 single-device result;
- the same with cuDNN turned off (PyTorch's own convolutions), small model
  only;
- stage by stage on one chunk's windows (the flips included): each stage
  of the model given the same input once whole and once through the row
  partition, the share of elements that differ and the largest difference
  in bf16 units in the last place of the larger value.

Prints one JSON object a line. Usage, from the repository root:
``python3 chip_probes/spatial_bf16_probe.py``
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def spread(a, b):
    return {"max_abs": float(np.abs(a - b).max()),
            "agree": float((a.argmax(-1) == b.argmax(-1)).mean())}


def ulps(a, b):
    """Share of differing elements and the largest difference in bf16 ulps
    of the larger magnitude."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return {"frac_diff": float((d > 0).float().mean()), "max_ulps": float((d / ulp).max()),
            "max_abs": float(d.max())}


def small_cfg():
    return SimpleNamespace(arch="psa", layers=50, classes=19, zoom_factor=8,
                           train_h=97, train_w=97, test_h=97, test_w=97,
                           base_size=256, scales=[1.0], model_path="",
                           allow_random_weights=True, window_batch=8,
                           eval_pipeline="device", psa_type=2, compact=0,
                           shrink_factor=2, normalization_factor=1.0, psa_softmax=1)


def stages(ev, image, dev):
    """Stage by stage, the model whole against the row partition on the
    same input: one chunk of windows with their flips."""
    from semseg_torch.models.pspnet import PSPNet
    from semseg_torch.parallel.spatial import Spatial
    from semseg_torch.ops.pool import max_pool2d

    model = ev.model
    sp = Spatial([dev, dev], [model, model])
    crop = ev.crop_h
    w = image.shape[1]
    xs = [0, (w - crop) // 3, 2 * (w - crop) // 3, w - crop][: ev.window_batch // 2]
    wins = torch.stack([torch.from_numpy(image[:crop, x:x + crop].copy()).permute(2, 0, 1)
                        for x in xs]).float().to(dev)
    x = ev._normalize(wins)
    x = torch.cat([x, x.flip(-1)]).to(model.dtype)
    ms = (model, model)

    def part(name, inp):
        return sp.gather(sp.apply(sp.sub(ms, name), sp.scatter(inp)))

    out = {}
    with torch.inference_mode():
        y = model.layer0[0](x)
        out["layer0.0 (first conv)"] = ulps(y, part("layer0.0", x))
        y = model.layer0(x)
        out["layer0"] = ulps(y, part("layer0", x))
        p = max_pool2d(y, 3, 2, 1)
        out["max_pool"] = ulps(p, sp.gather(sp.max_pool2d(sp.scatter(y), 3, 2, 1)))
        y = p
        for name in ("layer1", "layer2", "layer3", "layer4"):
            z = getattr(model, name)(y)
            out[name] = ulps(z, part(name, y))
            y = z
        context = "ppm" if isinstance(model, PSPNet) else "psa"
        z = getattr(model, context)(y)
        out[context] = ulps(z, part(context, y))
        out["cls"] = ulps(model.cls(z), part("cls", z))
        whole = model(x, zoom=False)
        out["chained, zoom=False"] = ulps(whole, sp.forward(x, zoom=False))
        one = Spatial([dev], [model])
        out["one-entry walk, chained"] = ulps(whole, one.forward(x, zoom=False))
    return out


def probe(label, cfg, image, dev, cudnn_off=False):
    from semseg_torch.serve import build_evaluator
    from semseg_torch.utils.misc import get_logger

    bf16 = build_evaluator(cfg, get_logger(), dtype=torch.bfloat16, device=dev, seed=0)
    f32 = build_evaluator(cfg, get_logger(), dtype=torch.float32, device=dev, seed=0)
    spatial = bf16.with_options(devices=[dev, dev], partition="spatial")
    half = bf16.with_options(window_batch=bf16.window_batch // 2)
    p32 = f32.predict_probs(image)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row = {"model": label, "image": list(image.shape[:2]), "fused": spatial.fused_stitch}
    for off in ((False, True) if cudnn_off else (False,)):
        torch.backends.cudnn.enabled = not off
        p1, psp, phalf = (e.predict_probs(image) for e in (bf16, spatial, half))
        tag = "cudnn_off" if off else "cudnn"
        row[tag] = {"spatial_vs_single": spread(psp, p1),
                    "half_batch_vs_single": spread(phalf, p1),
                    "single_vs_f32": spread(p1, p32), "spatial_vs_f32": spread(psp, p32),
                    "spatial_bit_equal": bool(np.array_equal(psp, p1))}
    torch.backends.cudnn.enabled = True
    row["stages_bf16"] = stages(bf16, image, dev)
    row["stages_f32"] = stages(f32, image, dev)
    print(json.dumps(row), flush=True)


def main():
    if not torch.cuda.is_available():
        print("spatial_bf16_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    dev = torch.device("cuda", 0)
    small = (np.random.RandomState(0).rand(128, 256, 3) * 255).astype(np.uint8)
    probe("PSANet50 97x97 (card test)", small_cfg(), small, dev, cudnn_off=True)
    street = chip_smoke.street_image(0)
    probe("PSPNet50 713x713", chip_smoke.pspnet_cfg(), street, dev)
    probe("PSANet50 705x705", chip_smoke.psanet_cfg(), street, dev)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
