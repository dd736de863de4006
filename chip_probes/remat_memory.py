"""Does the 101-layer recipes' published batch fit the card in float32,
with and without ``remat``? For PSANet101 (705x705 crops) and PSPNet101
(713x713), float32 (the recipe's ``compute_dtype``, TF32 off), cuDNN's
defaults: the largest batch among 16 and 8 that trains without ``remat``,
and the peak memory with ``remat`` at 16. Each configuration runs in a
fresh process (an out-of-memory error leaves nothing behind): the Trainer
(seed-0 weights, the recipe's SGD) takes 1 warm-up and 2 timed steps on a
device-resident batch of ``chip_smoke.py``'s street crops, through the
phase 26 code (``chip_smoke.f32_arm``); the process
reports the peak memory (``max_memory_allocated``, and reserved), the
seconds a step, or the out-of-memory error. The card's name and power
limit head the output; the JSON lines also go to ``--out``.

Usage, from the repository root: ``python3 chip_probes/remat_memory.py
[--out chiprun_out/remat_memory.jsonl]`` (about 3 minutes of chip time).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

CROPS = {"psa": 705, "psp": 713}


def one(arch, batch, remat):
    """One configuration in this process (``chip_smoke.f32_arm``, cuDNN's
    defaults, 1 warm-up and 2 timed steps); returns its JSON record."""
    dev = torch.device("cuda", 0)
    crop = CROPS[arch]
    cfg = (chip_smoke.psanet101_cfg(remat=remat) if arch == "psa"
           else chip_smoke.pspnet101_cfg(remat=remat))
    rec = {"arch": arch, "layers": 101, "crop": crop, "batch": batch, "remat": remat,
           "dtype": "float32", "total_gib": torch.cuda.mem_get_info(dev)[1] / 2 ** 30}
    images, labels = chip_smoke.street_batch(dev, batch, crop, 500)
    per_step = chip_smoke.F32_TRAIN_STEP if arch == "psa" else {}
    try:
        arm = chip_smoke.f32_arm(dev, cfg, images, labels, 3, per_step)
        rec.update(fits=True, step_s=arm["step_s"], images_per_s=batch / arm["step_s"],
                   losses=arm["losses"].tolist())
    except torch.cuda.OutOfMemoryError as exc:
        rec.update(fits=False, error=str(exc).splitlines()[0][:300])
    rec.update(peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               reserved_gib=torch.cuda.max_memory_reserved(dev) / 2 ** 30)
    return rec


def child(arch, batch, remat):
    """Run :func:`one` in a fresh interpreter; its record."""
    res = subprocess.run([sys.executable, __file__, "--one", arch, str(batch), str(int(remat))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    for line in res.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{arch} batch {batch} remat {remat}: exit {res.returncode}\n"
                       f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--one", nargs=3, metavar=("ARCH", "BATCH", "REMAT"))
    ap.add_argument("--out", default="chiprun_out/remat_memory.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("remat_memory: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if args.one:
        arch, batch, remat = args.one
        print("RESULT " + json.dumps(one(arch, int(batch), bool(int(remat)))), flush=True)
        return 0
    _, smi = chip_smoke.phase_device()
    chip_smoke.phase_build()
    records = []
    for arch in ("psa", "psp"):
        for batch in (16, 8):
            records.append(child(arch, batch, False))
            print(json.dumps({**records[-1], "card": smi}), flush=True)
            if records[-1]["fits"]:
                break
        records.append(child(arch, 16, True))
        print(json.dumps({**records[-1], "card": smi}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps({**r, "card": smi}) + "\n" for r in records))
    for arch in ("psa", "psp"):
        rows = [r for r in records if r["arch"] == arch]
        plain = [r for r in rows if not r["remat"] and r["fits"]]
        remat = [r for r in rows if r["remat"]][0]
        print(f"[remat memory] {arch}net101 f32 {CROPS[arch]}x{CROPS[arch]}: largest batch "
              f"without remat {plain[0]['batch'] if plain else 'none of 16, 8'}"
              + (f" (peak {plain[0]['peak_gib']:.2f} GiB, {plain[0]['step_s']:.4f} s/step)"
                 if plain else "")
              + f"; remat at 16: fits {remat['fits']}, peak {remat['peak_gib']:.2f} GiB"
              + (f", {remat['step_s']:.4f} s/step" if remat["fits"] else "")
              + f"; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
