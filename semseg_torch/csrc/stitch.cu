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
// Bound on an H100: write bandwidth. The main path writes [4, 19, 713, 713]
// bf16 (about 77 MB) per chunk from about 2.5 MB of input logits, which
// stays in L2; every intermediate (upsampled logits, both softmaxes) lives
// in registers and is never written to device memory.
//
// Design: one thread per output pixel (p, y, x). A first pass over the
// classes keeps an online max and sum of exponentials for both halves; a
// second pass recomputes each class's value and writes the averaged
// probability. Nothing is staged in shared memory, so any class count
// works (Cityscapes' 19 and ADE20K's 150 alike). Neighbouring threads
// write neighbouring addresses (coalesced 2-byte stores). Wider stores and
// shared-memory staging of the source rows are left for later work.
//
// Interface: plain C, bound from Python with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two interpolation taps: source indices and their (bf16-valued) weights.
struct Taps {
  int lo, hi;
  float w0, w1;
};

__device__ __forceinline__ Taps load_taps(const int* __restrict__ idx,
                                          const float* __restrict__ w, int i) {
  Taps t;
  t.lo = idx[2 * i];
  t.hi = idx[2 * i + 1];
  t.w0 = w[2 * i];
  t.w1 = w[2 * i + 1];
  return t;
}

// One upsampled logit: H pass at the two source columns (rounded to bf16),
// then the W pass, from one [hs, ws] class plane.
__device__ __forceinline__ float upsampled(const __nv_bfloat16* __restrict__ plane,
                                           int ws, const Taps& r, const Taps& c) {
  const __nv_bfloat16* row_lo = plane + r.lo * ws;
  const __nv_bfloat16* row_hi = plane + r.hi * ws;
  float a = round_bf16(r.w0 * __bfloat162float(row_lo[c.lo]) +
                       r.w1 * __bfloat162float(row_hi[c.lo]));
  float b = round_bf16(r.w0 * __bfloat162float(row_lo[c.hi]) +
                       r.w1 * __bfloat162float(row_hi[c.hi]));
  return c.w0 * a + c.w1 * b;
}

__global__ void __launch_bounds__(kThreads)
upsample_softmax_flip_kernel(const __nv_bfloat16* __restrict__ logits,
                             __nv_bfloat16* __restrict__ out,
                             const int* __restrict__ row_idx,
                             const float* __restrict__ row_w,
                             const int* __restrict__ col_idx,
                             const float* __restrict__ col_w,
                             int n_pairs, int classes, int hs, int ws,
                             int out_h, int out_w) {
  const long long total = (long long)n_pairs * out_h * out_w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = (int)(idx % out_w);
  const long long py = idx / out_w;
  const int y = (int)(py % out_h);
  const int p = (int)(py / out_h);

  const Taps r = load_taps(row_idx, row_w, y);
  const Taps c0 = load_taps(col_idx, col_w, x);
  // The flipped half reads the mirrored column: rw[:, ::-1].
  const Taps c1 = load_taps(col_idx, col_w, out_w - 1 - x);

  const long long plane = (long long)hs * ws;
  const __nv_bfloat16* half0 = logits + (long long)p * 2 * classes * plane;
  const __nv_bfloat16* half1 = half0 + (long long)classes * plane;

  // Pass 1: online max and sum of exp over the classes, both halves.
  float m0 = -INFINITY, s0 = 0.f, m1 = -INFINITY, s1 = 0.f;
  for (int k = 0; k < classes; ++k) {
    const float v0 = upsampled(half0 + k * plane, ws, r, c0);
    const float v1 = upsampled(half1 + k * plane, ws, r, c1);
    if (v0 > m0) {
      s0 = s0 * expf(m0 - v0) + 1.f;
      m0 = v0;
    } else {
      s0 += expf(v0 - m0);
    }
    if (v1 > m1) {
      s1 = s1 * expf(m1 - v1) + 1.f;
      m1 = v1;
    } else {
      s1 += expf(v1 - m1);
    }
  }

  // Pass 2: the averaged probabilities, one bf16 store per class.
  const long long out_plane = (long long)out_h * out_w;
  __nv_bfloat16* dst = out + (long long)p * classes * out_plane +
                       (long long)y * out_w + x;
  for (int k = 0; k < classes; ++k) {
    const float v0 = upsampled(half0 + k * plane, ws, r, c0);
    const float v1 = upsampled(half1 + k * plane, ws, r, c1);
    const float p0 = round_bf16((expf(v0 - m0) / s0) * 0.5f);
    const float p1 = round_bf16((expf(v1 - m1) / s1) * 0.5f);
    dst[k * out_plane] = __float2bfloat16_rn(p0 + p1);
  }
}

}  // namespace

extern "C" int semseg_stitch_upsample_softmax_flip(
    const void* logits, void* out, const void* row_idx, const void* row_w,
    const void* col_idx, const void* col_w, int n_pairs, int classes, int hs,
    int ws, int out_h, int out_w, void* stream) {
  const long long total = (long long)n_pairs * out_h * out_w;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  upsample_softmax_flip_kernel<<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)logits, (__nv_bfloat16*)out, (const int*)row_idx,
      (const float*)row_w, (const int*)col_idx, (const float*)col_w, n_pairs,
      classes, hs, ws, out_h, out_w);
  return (int)cudaGetLastError();
}
