"""Where the tensor-core PSA kernels' time goes, on one NVIDIA GPU.

No profiler of kernel internals runs on the card's machine, so this builds
variants of ``semseg_torch/csrc/psa.cu`` with one piece of the tensor-core
kernels removed each and times them at the Cityscapes PSANet shapes (CUDA
events over 20 back-to-back launches, the library called directly). The
variants' results are wrong by design: only their times mean anything.
Builds go under ``build/psa_ablation/``.
- ``--family bf16`` (the default): the bf16 forward, dx and da. Removed:
  the wgmma products, the exps, the loads of A, the operand copies, forming
  p, the operand pack; for da the wgmma products, the operand copies, the
  packs, the loads of A, the stores of da, the whole epilogue or the whole
  channel loop (da without the caller's ``delta``).
- ``--family tf32x3``: the f32 forward and dx on the tensor cores as
  3xTF32. Removed: all three wgmma passes, the two small-term passes (one
  TF32 pass left), the exps, the loads of A, the operand copies, forming p
  (and its split), the per-stage add of the products into the rounded sums
  (with the forward's rescaling by alpha), the operand pack. And two
  layouts: ``mt1``, 128 channels a block (four blocks a query tile at
  C = 512) in place of 256, and ``mt1_2blocks``, the same with two blocks
  an SM (at most 128 registers a thread).
- ``--family tf32x3_da``: the f32 da on the tensor cores as 3xTF32, at (8|16,
  512, 2025) and (1, 512, 7921). Removed: the transposing pack, the rounded
  sums (the per-stage fold into the running sum), the two small-term passes
  (one TF32 pass left), the epilogue (A's loads, the exps, the stores of
  da), the operand copies, all three wgmma passes. And two additions:
  ``prefetch``, the epilogue's A tile prefetched into L2 before the channel
  loop, and ``rows8``, the epilogue with 8 rows of A in flight a warp in
  place of 4.

``--against PATH`` builds another ``psa.cu`` unchanged (an older commit's,
unpacked with ``git archive`` under ``build/``) and times it beside the
variants as ``against``; with ``tf32x3_da`` it also says whether its da
equals the base's bit for bit.

Usage, from the repository root on a machine with the card:
    python3 chip_probes/psa_ablation.py [--family bf16|tf32x3|tf32x3_da]
        [--against build/parent/semseg_torch/csrc/psa.cu]
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
from semseg_torch.ops import psa  # noqa: E402
from semseg_torch.ops._build import NVCC_FLAGS, _nvcc  # noqa: E402

VARIANTS = {
    "base": [],
    "no_wgmma": [("wgmma_m64n64k16(acc[mt], da, db);", "")],
    "no_exp": [("expf(", "(")],
    "no_A_loads": [("__ldg(araw + (long long)i * HW + j)", "(unsigned short)0x3F80"),
                   ("__ldg(row + j)", "(unsigned short)0x3F80"),
                   ("__ldg(row + j + 1)", "(unsigned short)0x3F80")],
    "no_operand": [("      cp_async16(sa + buf * kSA + swz(r, ch), "
                    "opn + (long long)r * HWp + k0 + ch * 8);\n", "")],
    "no_p": [("    if (more) produce(s + 1);\n", "")],
    "no_pack": [("  psa_pack_bf16_kernel<T><<<(unsigned)((total8 + 255) / 256), 256, 0, s>>>(\n"
                 "      src, pack, c, hw, cp, hwp, total8);\n", "")],
    "da_no_wgmma": [("wgmma_m64n64k16<1>(acc[h], dx, desc_sw128_mn(base + (2 + h) * kDaHalf + "
                     "k * 2048));", "")],
    "da_no_operand": [("      cp_async16(base + (2 * op + half) * kDaHalf + swz(row, ch), src);\n",
                       "")],
    "da_no_pack": [("    psa_pack_bf16_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(x, xpk, c, hw, "
                    "cp, hwp, total8);\n    psa_pack_bf16_kernel<float><<<blocks, 256, 0, s>>>(g, "
                    "gpk, c, hw, cp, hwp, total8);\n", "")],
    "da_no_A_loads": [("__ldg(araw + off + lane + 32 * k)", "(unsigned short)0x3F80")],
    "da_no_stores": [("da[off + col] = __float2bfloat16_rn(",
                      "if (p == 12345.f) da[off + col] = __float2bfloat16_rn(")],
    "da_no_epilogue": [("for (int r0 = warp; r0 < kDaTile;", "for (int r0 = warp; r0 < 0;")],
    "da_no_gemm": [("for (int s = 0; s < stages; ++s) {\n    cp_async_wait<kDaStages - 2>();",
                    "for (int s = 0; s < 0; ++s) {\n    cp_async_wait<kDaStages - 2>();")],
}
TF32_VARIANTS = {
    "base": [],
    "no_wgmma": [("        wgmma_m64n64k8_tf32(acc[mt], al, bh, k);  // small terms first; k = 0 "
                  "starts from 0\n        wgmma_m64n64k8_tf32(acc[mt], ah, bl, 1);\n"
                  "        wgmma_m64n64k8_tf32(acc[mt], ah, bh, 1);\n", "")],
    "one_pass": [("        wgmma_m64n64k8_tf32(acc[mt], al, bh, k);  // small terms first; k = 0 "
                  "starts from 0\n        wgmma_m64n64k8_tf32(acc[mt], ah, bl, 1);\n", "")],
    "no_exp": [("expf(raw[r] - m_new)", "(raw[r] - m_new)"),
               ("expf(raw[r] - ml[0])", "(raw[r] - ml[0])")],
    "no_A_loads": [("? __ldg(an + (long long)i * HW + j) : -INFINITY", "? 0.5f : -INFINITY")],
    "no_operand": [("      cp_async16(dst, hin + src);\n      cp_async16(dst + kPA, lon + src);\n",
                    "")],
    "no_p": [("    if (more) produce(s + 1);\n    if (s + 2 < stages) fetch((s + 2) * kTf32K);\n",
              "    if (s + 2 < stages) fetch((s + 2) * kTf32K);\n")],
    "no_promote": [("          v = kDx ? v + acc[mt][4 * q + e] : fmaf(v, e % 2 ? f.y : f.x, "
                    "acc[mt][4 * q + e]);\n", "")],
    "mt1": [("inline int tf32_m_tiles(int c) { return c <= 128 ? 1 : 2; }",
             "inline int tf32_m_tiles(int c) { return 1; }")],
    "mt1_2blocks": [("inline int tf32_m_tiles(int c) { return c <= 128 ? 1 : 2; }",
                     "inline int tf32_m_tiles(int c) { return 1; }"),
                    ("__global__ void __launch_bounds__(kThreads, 1)\npsa_tf32x3_kernel(",
                     "__global__ void __launch_bounds__(kThreads, 2)\npsa_tf32x3_kernel(")],
    "no_pack": [("  psa_pack_tf32x3_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, s>>>(src, "
                 "pack, c, hw, cp,\n                                                             "
                 "             hwp, total4);\n", "")],
}
TF32_DA_VARIANTS = {
    "base": [],
    "no_pack": [("    psa_pack_tf32x3_t_kernel<<<grid, block, 0, s>>>(x, xpk, c, hw, cp, hwp);\n"
                 "    psa_pack_tf32x3_t_kernel<<<grid, block, 0, s>>>(g, gpk, c, hw, cp, hwp);\n",
                 "")],
    "no_fold": [("    for (int e = 0; e < 64; ++e) sum[e] += acc[e];",
                 "    for (int e = 0; e < 64; e += 64) sum[e] += acc[e];")],
    "one_pass": [("      wgmma_m64n128k8_tf32(acc, al, bh, k);  // small terms first; k = 0 starts "
                  "from 0\n      wgmma_m64n128k8_tf32(acc, ah, bl, 1);\n", "")],
    "no_epilogue": [("for (int r0 = warp; r0 < kTdTile;", "for (int r0 = warp; r0 < 0;")],
    "prefetch": [("  for (int s = 0; s < stages; ++s) {\n    cp_async_wait<kTdStages - 2>();",
                  "  for (int id = tid; id < kTdTile * 5; id += kThreads) {\n"
                  "    const int i = i0 + id / 5, j = min(j0 + 32 * (id % 5), min(j0 + kTdTile, HW)"
                  " - 1);\n    if (i < HW) asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"("
                  "a + (n * HW + i) * (long long)HW + j));\n  }\n"
                  "  for (int s = 0; s < stages; ++s) {\n    cp_async_wait<kTdStages - 2>();")],
    "rows8": [("  constexpr int kRows = 4;", "  constexpr int kRows = 8;")],
    "no_operand": [("      cp_async16(dst, xn + off);\n      cp_async16(dst + kTdPart, xn + part + "
                    "off);\n      cp_async16(dst + 2 * kTdPart, gn + off);\n      cp_async16(dst + "
                    "3 * kTdPart, gn + part + off);\n", "")],
    "no_wgmma": [("      wgmma_m64n128k8_tf32(acc, al, bh, k);  // small terms first; k = 0 starts "
                  "from 0\n      wgmma_m64n128k8_tf32(acc, ah, bl, 1);\n      "
                  "wgmma_m64n128k8_tf32(acc, ah, bh, 1);\n", "")],
}
FAMILIES = {"bf16": VARIANTS, "tf32x3": TF32_VARIANTS, "tf32x3_da": TF32_DA_VARIANTS}
OUT = ROOT / "build" / "psa_ablation"


def build(family, name, source=None):
    text = Path(source or ROOT / "semseg_torch" / "csrc" / "psa.cu").read_text()
    for old, new in FAMILIES[family].get(name, []):
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in psa.cu")
        text = text.replace(old, new)
    cu = OUT / f"{family}_{name}.cu"
    cu.write_text(text)
    so = OUT / f"lib{family}_{name}.so"
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_nvcc(), *flags, "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-2000:]}")
    return name, so


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


def time_tf32x3(libs, dev):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for n, c, hw in [(8, 512, 2025), (16, 512, 2025)]:
        g0 = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, c, hw, generator=g0, device=dev)
        a = torch.randn(n, hw, hw, generator=g0, device=dev) * 3
        g = torch.randn(n, c, hw, generator=g0, device=dev)
        m, l = psa.psa_softmax_stats(a)
        out = torch.empty(n, c, hw, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        row = []
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            fwd, bwd = lib.semseg_psa_softmax_bmm_tf32x3, lib.semseg_psa_bwd_dx_tf32x3
            for fn in (fwd, bwd):
                fn.argtypes, fn.restype = [ptr] * 6 + [i32] * 3 + [f32, ptr], ctypes.c_int
            elems = lib.semseg_psa_tf32x3_pack_elems
            elems.argtypes, elems.restype = [i32] * 3, ctypes.c_longlong
            pack = torch.empty(elems(n, c, hw), device=dev)
            t_fwd = ms(lambda: fwd(x.data_ptr(), a.data_ptr(), out.data_ptr(), None, None,
                                   pack.data_ptr(), n, c, hw, 1.0, stream))
            t_dx = ms(lambda: bwd(a.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(),
                                  out.data_ptr(), pack.data_ptr(), n, c, hw, 1.0, stream))
            row.append(f"{name} fwd {t_fwd:.4f} dx {t_dx:.4f}")
        print(f"3xTF32 {(n, c, hw)} ms: " + "; ".join(row), flush=True)


def time_tf32x3_da(libs, dev):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for n, c, hw in [(8, 512, 2025), (16, 512, 2025), (1, 512, 7921)]:
        g0 = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, c, hw, generator=g0, device=dev)
        a = torch.randn(n, hw, hw, generator=g0, device=dev) * 3
        g = torch.randn(n, c, hw, generator=g0, device=dev)
        m, l = psa.psa_softmax_stats(a)
        delta = torch.randn(n, hw, generator=g0, device=dev)
        da = torch.empty_like(a)
        stream = torch.cuda.current_stream().cuda_stream
        row, results = [], {}
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            fn = lib.semseg_psa_bwd_da_tf32x3
            fn.argtypes, fn.restype = [ptr] * 8 + [i32] * 3 + [f32, ptr], ctypes.c_int
            elems = lib.semseg_psa_da_tf32x3_pack_elems
            elems.argtypes, elems.restype = [i32] * 3, ctypes.c_longlong
            pack = torch.empty(elems(n, c, hw), device=dev)
            t = ms(lambda: fn(x.data_ptr(), g.data_ptr(), a.data_ptr(), m.data_ptr(),
                              l.data_ptr(), delta.data_ptr(), da.data_ptr(), pack.data_ptr(),
                              n, c, hw, 1.0, stream))
            row.append(f"{name} {t:.4f}")
            if name in ("base", "against"):
                results[name] = da.clone()
        print(f"3xTF32 da {(n, c, hw)} ms: " + "; ".join(row), flush=True)
        if "against" in results:
            print(f"3xTF32 da {(n, c, hw)}: against == base bit for bit "
                  f"{torch.equal(results['base'], results['against'])}", flush=True)
        del x, a, g, da, results
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=sorted(FAMILIES), default="bf16")
    ap.add_argument("--against", help="another psa.cu, built unchanged and timed beside")
    args = ap.parse_args()
    family = args.family
    if not torch.cuda.is_available():
        print("psa_ablation: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(name, None) for name in FAMILIES[family]]
    if args.against:
        jobs.append(("against", args.against))
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(pool.map(lambda job: build(family, *job), jobs))
    dev = torch.device("cuda")
    if family == "tf32x3":
        time_tf32x3(libs, dev)
        return 0
    if family == "tf32x3_da":
        time_tf32x3_da(libs, dev)
        return 0
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for n, c, hw in [(8, 512, 2025), (16, 512, 2025)]:
        g0 = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, c, hw, generator=g0, device=dev).to(torch.bfloat16)
        a = (torch.randn(n, hw, hw, generator=g0, device=dev) * 3).to(torch.bfloat16)
        g = torch.randn(n, c, hw, generator=g0, device=dev)
        m, l = psa.psa_softmax_stats(a)
        out = torch.empty(n, c, hw, device=dev)
        dx = torch.empty(n, c, hw, device=dev, dtype=torch.bfloat16)
        da = torch.empty_like(a)
        pack = psa._wgmma_pack(x)
        da_pack = torch.empty(2 * psa._lib()["semseg_psa_da_wgmma_pack_elems"](n, c, hw),
                              dtype=torch.bfloat16, device=dev)
        delta = torch.randn(n, hw, generator=g0, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        row = []
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            fwd, bwd = lib.semseg_psa_softmax_bmm_wgmma, lib.semseg_psa_bwd_dx_wgmma
            for fn in (fwd, bwd):
                fn.argtypes, fn.restype = [ptr] * 6 + [i32] * 3 + [f32, ptr], ctypes.c_int
            bda = lib.semseg_psa_bwd_da_wgmma
            bda.argtypes, bda.restype = [ptr] * 8 + [i32] * 3 + [f32, ptr], ctypes.c_int
            t_fwd = ms(lambda: fwd(x.data_ptr(), a.data_ptr(), out.data_ptr(), None, None,
                                   pack.data_ptr(), n, c, hw, 1.0, stream))
            t_dx = ms(lambda: bwd(a.data_ptr(), g.data_ptr(), m.data_ptr(), l.data_ptr(),
                                  dx.data_ptr(), pack.data_ptr(), n, c, hw, 1.0, stream))
            t_da = ms(lambda: bda(x.data_ptr(), g.data_ptr(), a.data_ptr(), m.data_ptr(),
                                  l.data_ptr(), delta.data_ptr(), da.data_ptr(),
                                  da_pack.data_ptr(), n, c, hw, 1.0, stream))
            row.append(f"{name} fwd {t_fwd:.4f} dx {t_dx:.4f} da {t_da:.4f}")
        print(f"{(n, c, hw)} ms: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
