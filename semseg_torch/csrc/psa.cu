// PSA softmax + aggregation forward, two kernels (resident and flash):
//
//     out[n, c, j] = inv_norm * sum_i x[n, c, i] * softmax_i(A[n, i, j])
//
// x is [N, C, HW], A is [N, HW, HW] (both bf16 or both f32), out is f32
// [N, C, HW]. All math is f32 on the CUDA cores (plain FMAs), whatever the
// operand dtype: the JAX contract holds bf16 operands to the f32 result on
// the same bf16 values, so tensor cores (p rounded to bf16) are not used.
//
// Replaces:
// - semseg_psa_softmax_bmm (resident) -> semseg_tpu/ops/psa_pallas.py::
//   _fwd_kernel (:48): an exact column softmax per query tile.
// - semseg_psa_softmax_bmm_flash -> psa_pallas.py::_flash_fwd_kernel
//   (:303): the online-softmax forward that also returns the column max m
//   and the sum l of exp(A - m), f32 [N, HW], for the flash backward.
//
// Bound on an H100: f32 FMA throughput. On the Cityscapes PSANet path one
// launch is 2 * 8 * 512 * 2025^2 = 33.6 GFLOP against 65.6 MB of bf16 A,
// about 500 FLOP per byte of A: far above the card's f32 ridge, so A's
// bytes are small beside the arithmetic.
//
// Design: one kernel body, psa_fwd_kernel<T, kFlash>. One block of 256
// threads per (128-channel tile, 64-column query tile, batch row). The
// channel tile is the fastest grid axis, so the blocks that share one
// column tile of A run side by side and share it through L2; x (2 MB per
// sample in bf16 at hw 2025) is re-read from L2 by every column tile. Each
// stage stages 32 source rows of x (transposed to [i][c], f32) and of A in
// shared memory. Four threads per column turn the A tile into p in place;
// then each thread accumulates a 4-channel x 8-column register tile with
// f32 FMAs. A warp owns 8 columns and its 32 lanes 4 channels each, so the
// p values of a stage are broadcast reads and the x values conflict-free
// (odd row stride). Ragged C and HW edges are masked from the block
// indices: no padding of the inputs, no -inf rows in memory.
// - Resident: a first pass over all HW source rows forms each column's max
//   and sum (coalesced reads along the row-major A, sixteen in flight per
//   thread, since this pass is latency-bound), then every stage computes
//   p = exp(a - m) / l. A is read twice.
// - Flash: the TPU kernel's sequential source-tile grid axis becomes the
//   loop over stages inside the block. The four threads of a column keep
//   the running max and sum and publish alpha = exp(m_old - m_new), by
//   which the register tile is rescaled before each stage. A is read once;
//   nothing carries between blocks, so no atomics.
// The exps cost HW*HW*ceil(C/128) per launch (x2 for resident), about 1 %
// of the FMAs at C = 512. Double buffering, wider register tiles and the
// tensor cores are left for later work.
//
// Interface: plain C, bound from Python with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTC = 128;      // channels per block
constexpr int kTJ = 64;       // query columns per block
constexpr int kTI = 32;       // source rows per shared-memory stage
constexpr int kXS = kTC + 1;  // xs row stride: odd, so [i][c] stores spread over banks
constexpr int kPS = kTJ + 8;  // ps row stride: 16-byte rows, conflict-free column walks
constexpr int kMC = kTC / 32;           // channels per thread (4)
constexpr int kMJ = kTJ / (kThreads / 32);  // columns per thread (8)

static_assert(kTI == 32, "x tile loads map one lane to one source row");
static_assert(kMJ == 8, "p reads are two float4 per stage row");

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

struct Tiles {
  float xs[kTI][kXS];
  __align__(16) float ps[kTI][kPS];
  __align__(16) float col[kTJ];  // resident: column max; flash: alpha; then the output scale
  float col2[kTJ];               // resident: column sum
  float red_m[kThreads / kTJ][kTJ];
  float red_s[kThreads / kTJ][kTJ];
};

// x[c0:c0+128, i0:i0+32] -> xs[i][c] as f32, zero outside [C, HW).
template <typename T>
__device__ __forceinline__ void load_x(Tiles& t, const T* __restrict__ xn,
                                       int C, int HW, int c0, int i0) {
  const int ii = threadIdx.x % kTI;
  const int i = i0 + ii;
#pragma unroll
  for (int r = 0; r < kTC / (kThreads / kTI); ++r) {
    const int cc = threadIdx.x / kTI + (kThreads / kTI) * r;
    const int c = c0 + cc;
    t.xs[ii][cc] = (i < HW && c < C) ? ld(xn + (long long)c * HW + i) : 0.f;
  }
}

// The stage's register-tile update: acc[r][q] += x[c_r, i] * p[i, j_q].
__device__ __forceinline__ void accumulate(const Tiles& t, float (&acc)[kMC][kMJ]) {
  const int lane = threadIdx.x % 32;
  const int jw = (threadIdx.x / 32) * kMJ;
#pragma unroll 8
  for (int k = 0; k < kTI; ++k) {
    float xv[kMC];
#pragma unroll
    for (int r = 0; r < kMC; ++r) xv[r] = t.xs[k][lane + 32 * r];
    const float4 p0 = *reinterpret_cast<const float4*>(&t.ps[k][jw]);
    const float4 p1 = *reinterpret_cast<const float4*>(&t.ps[k][jw + 4]);
    const float pv[kMJ] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int r = 0; r < kMC; ++r) {
#pragma unroll
      for (int q = 0; q < kMJ; ++q) acc[r][q] = fmaf(xv[r], pv[q], acc[r][q]);
    }
  }
}

// out[n, c, j] = acc * scale[j] for the thread's in-range entries.
__device__ __forceinline__ void store_out(const Tiles& t, const float (&acc)[kMC][kMJ],
                                          float* __restrict__ outn, int C, int HW,
                                          int c0, int j0) {
  const int lane = threadIdx.x % 32;
  const int jw = (threadIdx.x / 32) * kMJ;
#pragma unroll
  for (int r = 0; r < kMC; ++r) {
    const int c = c0 + lane + 32 * r;
    if (c >= C) continue;
#pragma unroll
    for (int q = 0; q < kMJ; ++q) {
      const int j = j0 + jw + q;
      if (j < HW) outn[(long long)c * HW + j] = acc[r][q] * t.col[jw + q];
    }
  }
}

__device__ __forceinline__ void online_update(float v, float& m, float& s) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

// Resident pass 1: each column's max and sum of exp over all source rows,
// into t.col / t.col2 (0 and 1 for columns past HW). Thread (g, jj) walks
// rows g, g+4, ... of column jj with two independent online (m, s) chains
// and sixteen loads in flight, since the pass is latency-bound; the four
// partials of a column are then merged.
template <typename T>
__device__ __forceinline__ void column_stats(Tiles& t, const T* __restrict__ an,
                                             int HW, int j0) {
  constexpr int kG = kThreads / kTJ;
  constexpr int kU = 16;
  const int jj = threadIdx.x % kTJ;
  const int g = threadIdx.x / kTJ;
  const int j = j0 + jj;
  float m = -INFINITY, s = 0.f, m2 = -INFINITY, s2 = 0.f;
  if (j < HW) {
    int i = g;
    for (; i + (kU - 1) * kG < HW; i += kU * kG) {
      float v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) v[u] = ld(an + (long long)(i + u * kG) * HW + j);
#pragma unroll
      for (int u = 0; u < kU; u += 2) {
        online_update(v[u], m, s);
        online_update(v[u + 1], m2, s2);
      }
    }
    for (; i < HW; i += kG) online_update(ld(an + (long long)i * HW + j), m, s);
  }
  if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else if (s2 > 0.f) {
    s += s2 * expf(m2 - m);
  }
  t.red_m[g][jj] = m;
  t.red_s[g][jj] = s;
  __syncthreads();
  if (threadIdx.x < kTJ) {
    float mm = t.red_m[0][jj];
    for (int h = 1; h < kG; ++h) mm = fmaxf(mm, t.red_m[h][jj]);
    float ss = 0.f;
    for (int h = 0; h < kG; ++h) {
      if (t.red_s[h][jj] > 0.f) ss += t.red_s[h][jj] * expf(t.red_m[h][jj] - mm);
    }
    t.col[jj] = j < HW ? mm : 0.f;
    t.col2[jj] = j < HW ? ss : 1.f;
  }
  __syncthreads();
}

// Both forward kernels. kFlash = false: resident (exact statistics from
// pass 1, then p = exp(a - m) / l per stage); kFlash = true: flash (online
// statistics per stage, register tile rescaled by alpha; writes m and l).
template <typename T, bool kFlash>
__global__ void __launch_bounds__(kThreads, 2)
psa_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
               float* __restrict__ out, float* __restrict__ m_out,
               float* __restrict__ l_out, int C, int HW, float inv_norm) {
  __shared__ Tiles t;
  const int c0 = blockIdx.x * kTC;
  const int j0 = blockIdx.y * kTJ;
  const long long n = blockIdx.z;
  const T* xn = x + n * C * HW;
  const T* an = a + n * HW * HW;

  // Column statistics: four threads per column (lanes 4*jc .. 4*jc+3 of
  // one warp), each over rows q, q+4, ... of a stage.
  const int sj = threadIdx.x / 4;
  const int sq = threadIdx.x % 4;
  float m_run = -INFINITY, l_run = 0.f;
  if (!kFlash) {
    column_stats(t, an, HW, j0);
    m_run = t.col[sj];
    l_run = t.col2[sj];
  }

  float acc[kMC][kMJ] = {};
  for (int i0 = 0; i0 < HW; i0 += kTI) {
    load_x(t, xn, C, HW, c0, i0);
    {
      const int jj = threadIdx.x % kTJ;
      const int j = j0 + jj;
#pragma unroll
      for (int r = 0; r < kTI / (kThreads / kTJ); ++r) {
        const int ii = threadIdx.x / kTJ + (kThreads / kTJ) * r;
        const int i = i0 + ii;
        // rows past HW are -inf (p = 0); columns past HW any finite value
        t.ps[ii][jj] = i < HW ? (j < HW ? ld(an + (long long)i * HW + j) : 0.f)
                              : -INFINITY;
      }
    }
    __syncthreads();
    if (kFlash) {
      float tmax = -INFINITY;
#pragma unroll
      for (int r = 0; r < kTI / 4; ++r) tmax = fmaxf(tmax, t.ps[sq + 4 * r][sj]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      // Every stage holds at least one row < HW, so m_new is finite.
      const float m_new = fmaxf(m_run, tmax);
      const float alpha = expf(m_run - m_new);  // 0 on the first stage
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kTI / 4; ++r) {
        const float e = expf(t.ps[sq + 4 * r][sj] - m_new);
        t.ps[sq + 4 * r][sj] = e;
        s += e;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      l_run = l_run * alpha + s;
      m_run = m_new;
      if (sq == 0) t.col[sj] = alpha;
    } else {
#pragma unroll
      for (int r = 0; r < kTI / 4; ++r) {
        float& v = t.ps[sq + 4 * r][sj];
        v = expf(v - m_run) / l_run;
      }
    }
    __syncthreads();
    if (kFlash) {
      const int jw = (threadIdx.x / 32) * kMJ;
#pragma unroll
      for (int q = 0; q < kMJ; ++q) {
        const float alpha = t.col[jw + q];
#pragma unroll
        for (int r = 0; r < kMC; ++r) acc[r][q] *= alpha;
      }
    }
    accumulate(t, acc);
    __syncthreads();
  }

  if (sq == 0) {
    t.col[sj] = kFlash ? inv_norm / l_run : inv_norm;
    const int j = j0 + sj;
    if (kFlash && blockIdx.x == 0 && j < HW) {
      m_out[n * HW + j] = m_run;
      l_out[n * HW + j] = l_run;
    }
  }
  __syncthreads();
  store_out(t, acc, out + n * C * HW, C, HW, c0, j0);
}

template <bool kFlash>
int launch(const void* x, const void* a, void* out, void* m, void* l, int n,
           int c, int hw, float inv_norm, int is_bf16, void* stream) {
  if (n == 0 || c == 0 || hw == 0) return 0;
  const dim3 grid((c + kTC - 1) / kTC, (hw + kTJ - 1) / kTJ, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    psa_fwd_kernel<__nv_bfloat16, kFlash><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)a, (float*)out,
        (float*)m, (float*)l, c, hw, inv_norm);
  } else {
    psa_fwd_kernel<float, kFlash><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)a, (float*)out, (float*)m, (float*)l, c,
        hw, inv_norm);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int semseg_psa_softmax_bmm(const void* x, const void* a, void* out,
                                      int n, int c, int hw, float inv_norm,
                                      int is_bf16, void* stream) {
  return launch<false>(x, a, out, nullptr, nullptr, n, c, hw, inv_norm, is_bf16,
                       stream);
}

extern "C" int semseg_psa_softmax_bmm_flash(const void* x, const void* a,
                                            void* out, void* m, void* l, int n,
                                            int c, int hw, float inv_norm,
                                            int is_bf16, void* stream) {
  return launch<true>(x, a, out, m, l, n, c, hw, inv_norm, is_bf16, stream);
}
