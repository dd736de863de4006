// Fused zoom-upsample + softmax + flip-TTA average for sliding-window eval.
//
// Replaces the TPU kernel semseg_tpu/ops/stitch_pallas.py::_kernel (Pallas,
// wrapper upsample_softmax_flip). For each window pair (original window,
// horizontally flipped window) it computes
//
//     out = bf16( bf16(softmax(up(L0)) / 2) + bf16(softmax(up_m(L1)) / 2) )
//
// where up is the align-corners bilinear upsample from feature resolution
// [hs, ws] to the crop [out_h, out_w], and up_m is the same upsample with
// its output columns reversed (the mirror that un-flips the second half,
// exact because it permutes the interpolation matrix). Rounding points
// follow the TPU kernel: interpolation weights rounded to bf16, H pass
// accumulated in f32 and rounded to bf16, W pass accumulated in f32, f32
// softmax over classes, each half rounded to bf16 before the bf16 add.
// Each output row and column takes two source taps, and bf16 x bf16
// products are exact in f32, so the two-term sums here equal the matmul
// form bit for bit.
//
// Bound on an H100: write bandwidth. The PSANet path writes [4, 19, 705,
// 705] bf16 (75.5 MB) per chunk from 1.2 MB of input logits, which stays in
// L2: 0.0233 ms at 3.35 TB/s. Every intermediate (the H pass, the upsampled
// logits, both softmaxes) lives in shared memory or registers. Beside the
// bytes, each output element needs two exps on the special function unit
// (16 lanes a clock on an SM): 0.020 ms on this path.
//
// Design. A thread per pixel, the plain form, evaluates each class's
// upsampled logit twice (for the softmax statistics, then for the output)
// from four gathered global loads, and recomputes the H pass for every
// pixel of a row: 15x the bound on this path. Here a block owns 2048
// consecutive pixels of one pair's output plane (flattened: three or four
// rows at out_w 705; 1024 when the classes take several chunks), up to
// eight pixels a thread, thread t taking pixels t, t + 256, ... so that a
// warp's stores are coalesced.
// - H pass, once per (half, class, row, source column) of the block's rows:
//   the two row taps read from global memory (coalesced along the source
//   row, L2-resident), the sum rounded to bf16 and held as f32 in shared
//   memory. A warp takes four lines at a time, a lane three columns of
//   each, so that 24 loads are in flight. With zoom 8 each H value serves
//   the eight-odd pixels of its row between two source columns.
// - W pass per pixel and class: two shared-memory taps (the mirrored column
//   for half 1), one FMA. A chunk of up to 32 classes is held in registers,
//   so the softmax is one pass: max, exp, sum, then the averaged
//   probabilities. The kernel is compiled for chunk widths of 4, 8, ...,
//   32; all slots of the width are computed (slots past the chunk on a copy
//   of its last class, left out of the sums and stores), so that no branch
//   splits the unrolled class loops, and widths up to 20 (Cityscapes' 19)
//   keep 80 registers for three blocks an SM.
// - More classes (ADE20K's 150) run in chunks of 32: a first sweep over the
//   chunks keeps an online max and sum per pixel (in shared memory), a
//   second recomputes each chunk's H pass and writes. No class cap.
// - Stores: 2-byte, warp-coalesced. out_w is odd on the recipe crops (705,
//   713), so rows are only 2-byte aligned; removing the stores saves 1 % of
//   the time (chip_probes/stitch_ablation.py), so wider stores are not worth
//   their peeling.
// - Column and row taps are 16-byte records {lo, hi, w0, w1}, one load each.
// A shape whose block would not fit in shared memory gets fewer classes per
// chunk, then fewer pixels per block (the plan in the launcher below).
//
// Interface: plain C, bound from Python with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 8;                       // pixels a thread, at most
constexpr int kBlockPix = kThreads * kPix;    // pixels a block, at most
constexpr int kClasses = 32;                  // classes a chunk, at most (registers)
constexpr int kLines = 4;                     // H pass lines a warp keeps in flight

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two interpolation taps: source indices and their (bf16-valued) weights,
// one 16-byte record {lo, hi, bits of w0, bits of w1} per output index.
struct Taps {
  int lo, hi;
  float w0, w1;
};

__device__ __forceinline__ Taps load_taps(const int4* __restrict__ taps, int i) {
  const int4 v = __ldg(taps + i);
  return Taps{v.x, v.y, __int_as_float(v.z), __int_as_float(v.w)};
}

// 2^x on the special function unit (flush-to-zero; x <= 0 here).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// bf16(bf16(p0) + bf16(p1)): each half's probability rounded to bf16 (one
// packed conversion), then one bf16 add (the sum of two bf16 values rounded
// once, as the f32 add and the cast after it round it).
__device__ __forceinline__ __nv_bfloat16 average(float p0, float p1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  return __low2bfloat16(__hadd2(h, __lowhigh2highlow(h)));
}

// One upsampled logit: the W pass over one (half, class, row) line of the
// H pass in shared memory.
__device__ __forceinline__ float wpass(const float* line, const Taps& c) {
  return fmaf(c.w1, line[c.hi], c.w0 * line[c.lo]);
}

// Blocks an SM for chunks of KC classes (the registers of v0, v1).
constexpr int min_blocks(int kc) { return kc <= 20 ? 3 : 2; }

// Grid (ceil(out_h out_w / block_pix), n_pairs), kThreads threads; chunks
// of kc_max <= KC classes. Dynamic shared memory: the H pass [2 halves][kc
// classes][rows][ws] f32, then, when the classes take more than one chunk,
// the per-pixel statistics [block_pix] float4 (m0, s0, m1, s1).
template <int KC>
__global__ void __launch_bounds__(kThreads, min_blocks(KC))
upsample_softmax_flip_kernel(const __nv_bfloat16* __restrict__ logits,
                             __nv_bfloat16* __restrict__ out,
                             const int4* __restrict__ row_taps,
                             const int4* __restrict__ col_taps,
                             int classes, int hs, int ws, int out_h, int out_w,
                             int block_pix, int kc_max, int stats_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hsm = reinterpret_cast<float*>(smem);
  float4* stats = reinterpret_cast<float4*>(smem + stats_off);
  const int plane = out_h * out_w;
  const int pix0 = blockIdx.x * block_pix;
  const int pix_end = min(pix0 + block_pix, plane);
  const int y_first = pix0 / out_w;
  const int rows = (pix_end - 1) / out_w - y_first + 1;
  const int p = blockIdx.y;
  const long long src_plane = (long long)hs * ws;
  const __nv_bfloat16* pair = logits + (long long)p * 2 * classes * src_plane;
  __nv_bfloat16* dst_pair = out + (long long)p * classes * plane;
  const int chunks = (classes + kc_max - 1) / kc_max;
  // ln / rows as a multiply and shift: exact for ln, rows < 2^16.
  const unsigned long long inv_rows = (1ull << 32) / rows + 1;

  for (int pass = 0; pass < (chunks > 1 ? 2 : 1); ++pass) {
    for (int k0 = 0; k0 < classes; k0 += kc_max) {
      const int kc = min(kc_max, classes - k0);
      const int line = rows * ws;  // one (half, class) of the H pass
      __syncthreads();             // the last chunk's W pass is done with hsm
      // H pass: hsm[((h kc + k) rows + r) ws + x], bf16-rounded, held as
      // f32. A warp takes kLines (half, class, row) lines at a time and a
      // lane 3 columns of each, so that 2 kLines 3 loads are in flight.
      const int n_lines = 2 * kc * rows;
      for (int l0 = kLines * (threadIdx.x / 32); l0 < n_lines; l0 += kLines * (kThreads / 32)) {
        float w0[kLines], w1[kLines];
        const __nv_bfloat16* lo[kLines];
        const __nv_bfloat16* hi[kLines];
#pragma unroll
        for (int j = 0; j < kLines; ++j) {
          const int ln = min(l0 + j, n_lines - 1);
          const int hk = (int)((ln * inv_rows) >> 32), r = ln - hk * rows;
          const int h = hk >= kc, k = hk - h * kc;
          const Taps rt = load_taps(row_taps, y_first + r);
          w0[j] = rt.w0;
          w1[j] = rt.w1;
          const __nv_bfloat16* src = pair + ((long long)h * classes + k0 + k) * src_plane;
          lo[j] = src + (long long)rt.lo * ws;
          hi[j] = src + (long long)rt.hi * ws;
        }
        for (int x0 = threadIdx.x % 32; x0 < ws; x0 += 96) {
          float va[kLines][3], vb[kLines][3];
#pragma unroll
          for (int j = 0; j < kLines; ++j) {
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const int x = min(x0 + 32 * i, ws - 1);
              va[j][i] = __bfloat162float(lo[j][x]);
              vb[j][i] = __bfloat162float(hi[j][x]);
            }
          }
#pragma unroll
          for (int j = 0; j < kLines; ++j) {
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              if (l0 + j < n_lines && x0 + 32 * i < ws) {
                hsm[(l0 + j) * ws + x0 + 32 * i] =
                    round_bf16(fmaf(w1[j], vb[j][i], w0[j] * va[j][i]));
              }
            }
          }
        }
      }
      __syncthreads();

#pragma unroll 1
      for (int q = 0; q < kPix; ++q) {
        const int loc = threadIdx.x + kThreads * q;
        const int pix = pix0 + loc;
        if (loc >= block_pix || pix >= pix_end) break;
        const int y = pix / out_w;
        const int x = pix - y * out_w;
        const Taps c0 = load_taps(col_taps, x);
        // The flipped half reads the mirrored column: rw[:, ::-1].
        const Taps c1 = load_taps(col_taps, out_w - 1 - x);
        const float* h0 = hsm + (y - y_first) * ws;
        const float* h1 = h0 + kc * line;
        // All KC slots are computed, slots past kc on a copy of the last
        // class (harmless in the max, left out of the sums and stores), so
        // that no branch splits the unrolled loops.
        float v0[KC], v1[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int kk = min(k, kc - 1);
          v0[k] = wpass(h0 + kk * line, c0);
          v1[k] = wpass(h1 + kk * line, c1);
        }
        float cm0 = v0[0], cm1 = v1[0];
#pragma unroll
        for (int k = 1; k < KC; ++k) {
          cm0 = fmaxf(cm0, v0[k]);
          cm1 = fmaxf(cm1, v1[k]);
        }
        __nv_bfloat16* dst = dst_pair + (long long)k0 * plane + pix;
        if (chunks == 1) {  // the whole softmax from registers
          float s0 = 0.f, s1 = 0.f;
          const float ml0 = cm0 * kLog2e, ml1 = cm1 * kLog2e;
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            v0[k] = exp2_ftz(fmaf(v0[k], kLog2e, -ml0));
            v1[k] = exp2_ftz(fmaf(v1[k], kLog2e, -ml1));
            s0 += k < kc ? v0[k] : 0.f;
            s1 += k < kc ? v1[k] : 0.f;
          }
          const float r0 = __fdividef(0.5f, s0), r1 = __fdividef(0.5f, s1);
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            const __nv_bfloat16 o = average(v0[k] * r0, v1[k] * r1);
            if (k < kc) dst[(long long)k * plane] = o;
          }
        } else if (pass == 0) {  // merge the chunk into the running statistics
          float4 st = k0 == 0 ? make_float4(cm0, 0.f, cm1, 0.f) : stats[loc];
          const float m0 = fmaxf(st.x, cm0), m1 = fmaxf(st.z, cm1);
          float s0 = st.y * __expf(st.x - m0), s1 = st.w * __expf(st.z - m1);
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            s0 += k < kc ? __expf(v0[k] - m0) : 0.f;
            s1 += k < kc ? __expf(v1[k] - m1) : 0.f;
          }
          stats[loc] = make_float4(m0, s0, m1, s1);
        } else {  // write the chunk from the final statistics
          const float4 st = stats[loc];
          const float r0 = 0.5f / st.y, r1 = 0.5f / st.w;
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            const __nv_bfloat16 o =
                average(__expf(v0[k] - st.x) * r0, __expf(v1[k] - st.z) * r1);
            if (k < kc) dst[(long long)k * plane] = o;
          }
        }
      }
    }
  }
}

// Rows of the output plane that a block of `block_pix` flattened pixels
// can touch.
int rows_spanned(int block_pix, int out_h, int out_w) {
  const int rows = (block_pix - 1) / out_w + 2;
  return rows < out_h ? rows : out_h;
}

// Shared-memory bytes for (block_pix, kc): the H pass, then the statistics
// when the classes take more than one chunk. Returns the statistics offset
// in *stats_off.
int smem_bytes(int block_pix, int kc, int classes, int ws, int out_h, int out_w,
               int* stats_off) {
  const long long h = 4LL * 2 * kc * rows_spanned(block_pix, out_h, out_w) * ws;
  const long long off = (h + 15) / 16 * 16;
  *stats_off = (int)off;
  const long long total = off + (kc < classes ? 16LL * block_pix : 0);
  return total > (1 << 30) ? (1 << 30) : (int)total;
}

template <int KC>
int launch(const void* logits, void* out, const void* row_taps, const void* col_taps,
           int n_pairs, int classes, int hs, int ws, int out_h, int out_w, int block_pix,
           int kc, int stats_off, int bytes, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(upsample_softmax_flip_kernel<KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)out_h * out_w;
  const dim3 grid((unsigned)((plane + block_pix - 1) / block_pix), (unsigned)n_pairs);
  upsample_softmax_flip_kernel<KC><<<grid, kThreads, bytes, s>>>(
      (const __nv_bfloat16*)logits, (__nv_bfloat16*)out, (const int4*)row_taps,
      (const int4*)col_taps, classes, hs, ws, out_h, out_w, block_pix, kc, stats_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int semseg_stitch_upsample_softmax_flip(
    const void* logits, void* out, const void* row_taps, const void* col_taps, int n_pairs,
    int classes, int hs, int ws, int out_h, int out_w, void* stream) {
  if ((long long)n_pairs * classes * out_h * out_w == 0) return 0;
  // Plan: kBlockPix pixels a block when the classes fit one chunk (half as
  // many when they are chunked: the second sweep recomputes the H pass of
  // every chunk, and the statistics take shared memory), up to kClasses
  // classes a chunk; then fewer classes per chunk and fewer pixels while the
  // block would not fit the share of shared memory that its blocks-per-SM
  // target leaves it.
  int block_pix = classes <= kClasses ? kBlockPix : kBlockPix / 2;
  int kc = classes < kClasses ? classes : kClasses, stats_off = 0;
  auto fits = [&](int* bytes) {
    *bytes = smem_bytes(block_pix, kc, classes, ws, out_h, out_w, &stats_off);
    return *bytes <= (227 * 1024) / min_blocks((kc + 3) / 4 * 4) - 1024;
  };
  int bytes = 0;
  while (!fits(&bytes)) {
    if (kc > 1) {
      kc = (kc + 1) / 2;
    } else if (block_pix > 32) {
      block_pix /= 2;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
#define SEMSEG_STITCH_LAUNCH(KC)                                                          \
  return launch<KC>(logits, out, row_taps, col_taps, n_pairs, classes, hs, ws, out_h, out_w, \
                    block_pix, kc, stats_off, bytes, s)
  switch ((kc + 3) / 4) {
    case 1: SEMSEG_STITCH_LAUNCH(4);
    case 2: SEMSEG_STITCH_LAUNCH(8);
    case 3: SEMSEG_STITCH_LAUNCH(12);
    case 4: SEMSEG_STITCH_LAUNCH(16);
    case 5: SEMSEG_STITCH_LAUNCH(20);
    case 6: SEMSEG_STITCH_LAUNCH(24);
    case 7: SEMSEG_STITCH_LAUNCH(28);
    default: SEMSEG_STITCH_LAUNCH(32);
  }
#undef SEMSEG_STITCH_LAUNCH
}
