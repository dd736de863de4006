"""Where the stitch kernel's time goes, on one NVIDIA GPU.

No profiler of kernel internals runs on the card's machine, so this builds
variants of a stitch kernel source with one piece removed each and times
every variant at the three recipe shapes (Cityscapes 713, PSANet 705, ADE20K
150 classes at 473; CUDA events over 20 back-to-back launches, the library
called directly). The base build is checked against the plain version
(max abs diff and row sums within 2e-2); the variants' results are wrong by
design and only their times mean anything. It knows two designs: the
one-thread-per-pixel kernel of the first port (``--source`` a copy of that
``csrc/stitch.cu``) and the shared-memory kernel that replaced it (the
repository's ``csrc/stitch.cu``, the default). Builds go under
``build/stitch_ablation/``.

Usage, from the repository root on a machine with the card:
    python3 chip_probes/stitch_ablation.py [--source PATH]
"""

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from semseg_torch.ops import stitch  # noqa: E402
from semseg_torch.ops._build import NVCC_FLAGS, _nvcc  # noqa: E402

# One pixel a thread, each class's upsampled logit evaluated in two passes
# from four gathered global loads.
PIXEL_DESIGN = {
    "base": [],
    "no_pass1": [("float m0 = -INFINITY, s0 = 0.f, m1 = -INFINITY, s1 = 0.f;\n"
                  "  for (int k = 0; k < classes; ++k) {",
                  "float m0 = 0.f, s0 = 1.f, m1 = 0.f, s1 = 1.f;\n"
                  "  for (int k = 0; k < 0; ++k) {")],
    "no_gather": [(f"__bfloat162float({r}[c.{c}])",
                   f"(float)((unsigned)(size_t)({r} + c.{c}) & 255u)")
                  for r in ("row_lo", "row_hi") for c in ("lo", "hi")],
    "no_exp": [("expf(", "(")],
    "no_stores": [("dst[k * out_plane] = __float2bfloat16_rn(p0 + p1);",
                   "if (p0 + p1 == 12345.f) dst[k * out_plane] = __float2bfloat16_rn(p0 + p1);")],
}
# A block per 1024 pixels, the H pass in shared memory, the classes in
# registers.
SHARED_DESIGN = {
    "base": [],
    "no_hpass": [("l0 < n_lines;", "l0 < 0;")],
    "no_wpass_loads": [("return fmaf(c.w1, line[c.hi], c.w0 * line[c.lo]);",
                        "return fmaf(c.w1, (float)c.hi, "
                        "c.w0 * (float)((unsigned)(size_t)line & 255u));")],
    "no_exp": [("__expf(", "("),
               ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
    "no_stores": [("if (k < kc) dst[(long long)k * plane] = o;",
                   "if (k < kc && __bfloat162float(o) == 12345.f) dst[(long long)k * plane] = o;")],
    "no_rounding": [("  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);\n"
                     "  return __low2bfloat16(__hadd2(h, __lowhigh2highlow(h)));",
                     "  return __ushort_as_bfloat16("
                     "(unsigned short)(__float_as_uint(p0 + p1) >> 16));")],
    "pix4": [("constexpr int kPix = 8;", "constexpr int kPix = 4;")],
}
SHAPES = (("cityscapes", 4, 19, 90, 713), ("psanet-cityscapes", 4, 19, 89, 705),
          ("ade20k", 4, 150, 60, 473))


def build(text, out, name, edits):
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    cu = out / f"{name}.cu"
    cu.write_text(text)
    so = out / f"lib{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-2000:]}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "Used" in ln or "spill" in ln]
    return name, so, regs


def ms(fn, reps=20):
    for _ in range(3):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(ROOT / "semseg_torch" / "csrc" / "stitch.cu"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stitch_ablation: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    text = Path(args.source).read_text()
    design, variants = (("pixel", PIXEL_DESIGN) if "upsampled(" in text
                        else ("shared", SHARED_DESIGN))
    out = ROOT / "build" / "stitch_ablation" / design
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda kv: build(text, out, *kv), variants.items()))
    print(f"{design} design ({args.source}): base {built[0][2]}", flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for label, p, c, hs, size in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        lp = (torch.randn(p, 2, c, hs, hs, generator=g, device=dev) * 3).to(torch.bfloat16)
        res = torch.empty(p, c, size, size, dtype=torch.bfloat16, device=dev)
        if design == "pixel":  # row and column taps as index and weight tables
            tables = [lp, res, *stitch._taps(hs, size, dev), *stitch._taps(hs, size, dev)]
        else:  # one 16-byte record per output index
            tables = [lp, res, stitch._tap_records(hs, size, dev),
                      stitch._tap_records(hs, size, dev)]
        row = []
        for name, so, _ in built:
            fn = ctypes.CDLL(str(so)).semseg_stitch_upsample_softmax_flip
            fn.argtypes = [ctypes.c_void_p] * len(tables) + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call():
                rc = fn(lp.data_ptr(), res.data_ptr(), *[t.data_ptr() for t in tables[2:]],
                        p, c, hs, hs, size, size, stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError {rc}")
            if name == "base":
                call()
                torch.cuda.synchronize()
                want = stitch.upsample_softmax_flip_reference(lp, (size, size)).float()
                err = (res.float() - want).abs().max().item()
                rows = (res.float().sum(1) - 1).abs().max().item()
                if not (err <= 2e-2 and rows <= 2e-2):
                    raise AssertionError(f"{label}: base vs plain {err}, row sums {rows}")
                row.append(f"base err {err:.3e} rows {rows:.3e}")
            row.append(f"{name} {ms(call):.4f}")
        print(f"{label} [{p},2,{c},{hs},{hs}]->{size}^2 ms: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
