// PSA softmax + aggregation: the forward kernels (resident and flash) and
// the three backward kernels.
//
//     out[n, c, j] = inv_norm * sum_i x[n, c, i] * p[n, i, j],
//     p[n, :, j] = softmax_i(A[n, :, j]),  m = max_i A, l = sum_i exp(A - m)
//
// x is [N, C, HW], A is [N, HW, HW] (both bf16 or both f32), out is f32
// [N, C, HW]. All math is f32 on the CUDA cores (plain FMAs), whatever the
// operand dtype: the JAX contract holds bf16 operands to the f32 result on
// the same bf16 values, so tensor cores (p rounded to bf16) are not used.
//
// Replaces (semseg_tpu/ops/psa_pallas.py):
// - semseg_psa_softmax_bmm (resident forward) -> _fwd_kernel (:48): an
//   exact column softmax per query tile; writes m and l when asked, for the
//   backward.
// - semseg_psa_softmax_bmm_flash -> _flash_fwd_kernel (:303): the
//   online-softmax forward, which also returns m and l, f32 [N, HW].
// - semseg_psa_bwd_da -> _bwd_da_kernel (:125): the softmax VJP
//   da = p * (inv_norm * x^T g - delta), in A's dtype.
// - semseg_psa_bwd_dx -> _bwd_dx_kernel (:140): dx = inv_norm * g p^T, f32.
// - semseg_psa_flash_bwd -> _flash_bwd_kernel (:383): both of the above in
//   one launch.
// The upstream gradient g is f32 [N, C, HW] (the forward's output dtype).
// The backward kernels recompute p = exp(A - m) / l from the forward's
// statistics and take delta[n, j] = sum_c g * out (f32 [N, HW], computed by
// the caller), the flash identity sum_i p * dP = sum_c g * out. The TPU
// resident backward held whole columns of A in VMEM and formed sum_i p * dP
// in the tile; a Hopper block that owns an i-tile of da cannot, so both
// backward paths use the identity.
//
// Bound on an H100: f32 FMA throughput. On the Cityscapes PSANet path each
// of the five is one GEMM of 2 * 8 * 512 * 2025^2 = 33.6 GFLOP (the flash
// backward two) against 65.6 MB of bf16 A: about 500 FLOP per byte of A,
// far above the card's f32 ridge, so A's bytes are small beside the
// arithmetic.
//
// Design: every kernel is the same register-tiled SIMT GEMM,
// acc[M = 128][N = 64] += sum_k S1[k][m] * S2[k][n], 256 threads, stages of
// K = 32 staged in shared memory as f32, a 4 x 8 register tile per thread
// (a warp owns 8 N columns; its 32 lanes own 4 M rows each, so S2 reads are
// broadcasts and S1 reads conflict-free). Ragged C and HW edges are masked
// from the block indices: no padding of the inputs, no -inf rows in memory.
// Nothing carries between blocks, so there are no atomics and two calls
// give bit-identical results.
// - Forward, one block per (128 channels, 64 query columns, batch row):
//   M = c, N = j, K = i. Resident: a first pass over all HW source rows forms
//   each column's max and sum (coalesced reads along the row-major A,
//   sixteen in flight per thread, since this pass is latency-bound), then
//   every stage computes p = exp(a - m) / l; A is read twice. Flash: the TPU
//   kernel's sequential source-tile grid axis becomes the loop over stages;
//   the four threads of a column keep the running max and sum and publish
//   alpha = exp(m_old - m_new), by which the register tile is rescaled
//   before each stage. A is read once.
// - da, one block per (128 query columns, 64 source rows, batch row):
//   M = j, N = i, K = c. Loops over C for dP^T = g^T x and recomputes p in
//   the epilogue, where a warp's lanes walk 32 consecutive columns of A and
//   da (coalesced).
// - dx, one block per (128 channels, 64 source rows, batch row): M = c,
//   N = i, K = j. Loops over the HW query columns; each stage turns an A
//   tile into p^T on the way into shared memory.
// - Flash backward, one block per (64 source rows, batch row): loops over
//   query tiles of 128 columns. Per tile, the da GEMM over C, then the
//   epilogue writes da and keeps p^T [128 j][64 i] in shared memory, then
//   the dx GEMM over the tile's 128 columns for every 128-channel chunk. The
//   dx sums carry across query tiles in the f32 output itself: the block owns
//   dx[:, i-tile] and each thread reads back only what it wrote, so no
//   atomics and no C-sized shared memory (any C works).
// The exps cost HW * HW * ceil(C / 128) per forward launch (x2 for resident)
// and HW * HW per backward launch, about 1 % of the FMAs at C = 512. Double
// buffering, wider register tiles and the tensor cores are left for later
// work.
//
// Interface: plain C, bound from Python with ctypes. Every launch goes on
// the caller's stream, does not synchronise and allocates nothing; the
// return value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTC = 128;      // GEMM M rows per block
constexpr int kTJ = 64;       // GEMM N columns per block
constexpr int kTI = 32;       // GEMM K depth per shared-memory stage
constexpr int kXS = kTC + 1;  // S1 row stride: odd, so transposing stores spread over banks
constexpr int kPS = kTJ + 8;  // S2 row stride: 16-byte rows, conflict-free column walks
constexpr int kMC = kTC / 32;           // M rows per thread (4)
constexpr int kMJ = kTJ / (kThreads / 32);  // N columns per thread (8)

static_assert(kTI == 32, "transposing loads map one lane to one K index");
static_assert(kMJ == 8, "S2 reads are two float4 per stage row");

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Tiles {
  float xs[kTI][kXS];
  __align__(16) float ps[kTI][kPS];
  __align__(16) float col[kTJ];  // resident: column max; flash: alpha; then the output scale
  float col2[kTJ];               // resident: column sum
  float red_m[kThreads / kTJ][kTJ];
  float red_s[kThreads / kTJ][kTJ];
};

// s[k][m] = src[(r0 + m) * stride + k0 + k] for m < W, k < 32, zero outside
// rows x cols: a transposing load, one lane per k.
template <int W, int S, typename T>
__device__ __forceinline__ void load_cols(float (*s)[S], const T* __restrict__ src,
                                          long long stride, int rows, int cols,
                                          int r0, int k0) {
  const int kk = threadIdx.x % kTI;
  const int k = k0 + kk;
#pragma unroll
  for (int r = 0; r < W / (kThreads / kTI); ++r) {
    const int mm = threadIdx.x / kTI + (kThreads / kTI) * r;
    const int m = r0 + mm;
    s[kk][mm] = (k < cols && m < rows) ? ld(src + (long long)m * stride + k) : 0.f;
  }
}

// s[k][m] = src[(k0 + k) * stride + m0 + m] for m < W, k < 32, zero outside
// rows x cols: a direct load, lanes along m.
template <int W, int S, typename T>
__device__ __forceinline__ void load_rows(float (*s)[S], const T* __restrict__ src,
                                          long long stride, int rows, int cols,
                                          int k0, int m0) {
  const int mm = threadIdx.x % W;
  const int m = m0 + mm;
#pragma unroll
  for (int r = 0; r < kTI / (kThreads / W); ++r) {
    const int kk = threadIdx.x / W + (kThreads / W) * r;
    const int k = k0 + kk;
    s[kk][mm] = (k < rows && m < cols) ? ld(src + (long long)k * stride + m) : 0.f;
  }
}

// The stage's register-tile update: acc[r][q] += S1[k][m_r] * S2[k][n_q].
__device__ __forceinline__ void accumulate(const float (*s1)[kXS], const float (*s2)[kPS],
                                           float (&acc)[kMC][kMJ]) {
  const int lane = threadIdx.x % 32;
  const int jw = (threadIdx.x / 32) * kMJ;
#pragma unroll 8
  for (int k = 0; k < kTI; ++k) {
    float xv[kMC];
#pragma unroll
    for (int r = 0; r < kMC; ++r) xv[r] = s1[k][lane + 32 * r];
    const float4 p0 = *reinterpret_cast<const float4*>(&s2[k][jw]);
    const float4 p1 = *reinterpret_cast<const float4*>(&s2[k][jw + 4]);
    const float pv[kMJ] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int r = 0; r < kMC; ++r) {
#pragma unroll
      for (int q = 0; q < kMJ; ++q) acc[r][q] = fmaf(xv[r], pv[q], acc[r][q]);
    }
  }
}

// out[m, n] = acc * scale[n] (row-major, stride HW) for the thread's
// in-range entries: M rows < rows, N columns < HW.
__device__ __forceinline__ void store_tile(const float (&acc)[kMC][kMJ], const float* scale,
                                           float* __restrict__ out, int rows, int HW,
                                           int m0, int n0) {
  const int lane = threadIdx.x % 32;
  const int jw = (threadIdx.x / 32) * kMJ;
#pragma unroll
  for (int r = 0; r < kMC; ++r) {
    const int m = m0 + lane + 32 * r;
    if (m >= rows) continue;
#pragma unroll
    for (int q = 0; q < kMJ; ++q) {
      const int n = n0 + jw + q;
      if (n < HW) out[(long long)m * HW + n] = acc[r][q] * scale[jw + q];
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
// statistics per stage, register tile rescaled by alpha). Either writes m
// and l when m_out is not null.
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
    load_cols<kTC, kXS>(t.xs, xn, HW, C, HW, c0, i0);
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
    accumulate(t.xs, t.ps, acc);
    __syncthreads();
  }

  if (sq == 0) {
    t.col[sj] = kFlash ? inv_norm / l_run : inv_norm;
    const int j = j0 + sj;
    if (m_out != nullptr && blockIdx.x == 0 && j < HW) {
      m_out[n * HW + j] = m_run;
      l_out[n * HW + j] = l_run;
    }
  }
  __syncthreads();
  store_tile(acc, t.col, out + n * C * HW, C, HW, c0, j0);
}

struct GemmTiles {
  float s1[kTI][kXS];
  __align__(16) float s2[kTI][kPS];
};

// The da GEMM of one (128-column, 64-row) tile: acc[r][q] = sum_c
// g[c, j0 + lane + 32 r] * x[c, i0 + jw + q], i.e. dP^T / inv_norm.
template <typename T>
__device__ __forceinline__ void gemm_dpt(GemmTiles& t, const T* __restrict__ xn,
                                         const float* __restrict__ gn, int C, int HW,
                                         int j0, int i0, float (&acc)[kMC][kMJ]) {
  for (int c0 = 0; c0 < C; c0 += kTI) {
    load_rows<kTC, kXS>(t.s1, gn, HW, C, HW, c0, j0);
    load_rows<kTJ, kPS>(t.s2, xn, HW, C, HW, c0, i0);
    __syncthreads();
    accumulate(t.s1, t.s2, acc);
    __syncthreads();
  }
}

// The softmax VJP of one tile: da[i, j] = p * (inv_norm * acc - delta[j])
// with p = exp(a - m[j]) / l[j], written in A's dtype. If pt is not null,
// p^T (0 outside HW) goes there too, [128 j][kPS].
template <typename T>
__device__ __forceinline__ void da_epilogue(const float (&acc)[kMC][kMJ],
                                            const T* __restrict__ an,
                                            const float* __restrict__ mn,
                                            const float* __restrict__ ln,
                                            const float* __restrict__ dn,
                                            T* __restrict__ dan, int HW, int j0, int i0,
                                            float inv_norm, float (*pt)[kPS]) {
  const int lane = threadIdx.x % 32;
  const int jw = (threadIdx.x / 32) * kMJ;
#pragma unroll
  for (int r = 0; r < kMC; ++r) {
    const int jj = lane + 32 * r;
    const int j = j0 + jj;
    const bool jin = j < HW;
    const float mj = jin ? mn[j] : 0.f;
    const float lj = jin ? ln[j] : 1.f;
    const float dj = jin ? dn[j] : 0.f;
#pragma unroll
    for (int q = 0; q < kMJ; ++q) {
      const int i = i0 + jw + q;
      float p = 0.f;
      if (jin && i < HW) {
        const long long off = (long long)i * HW + j;
        p = expf(ld(an + off) - mj) / lj;
        st(dan + off, p * (acc[r][q] * inv_norm - dj));
      }
      if (pt != nullptr) pt[jj][jw + q] = p;
    }
  }
}

// Resident backward, da. Grid (ceil(HW/128) column tiles, ceil(HW/64) row
// tiles, N).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
psa_bwd_da_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const float* __restrict__ g, const float* __restrict__ m,
                  const float* __restrict__ l, const float* __restrict__ delta,
                  T* __restrict__ da, int C, int HW, float inv_norm) {
  __shared__ GemmTiles t;
  const int j0 = blockIdx.x * kTC;
  const int i0 = blockIdx.y * kTJ;
  const long long n = blockIdx.z;
  float acc[kMC][kMJ] = {};
  gemm_dpt(t, x + n * C * HW, g + n * C * HW, C, HW, j0, i0, acc);
  da_epilogue(acc, a + n * HW * HW, m + n * HW, l + n * HW, delta + n * HW,
              da + n * HW * HW, HW, j0, i0, inv_norm, (float (*)[kPS])nullptr);
}

// Resident backward, dx (f32). Grid (ceil(C/128) channel tiles,
// ceil(HW/64) row tiles, N). Each stage stages g[c-tile, j-stage]
// transposed and turns A[i-tile, j-stage] into p^T.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
psa_bwd_dx_kernel(const T* __restrict__ a, const float* __restrict__ g,
                  const float* __restrict__ m, const float* __restrict__ l,
                  float* __restrict__ dx, int C, int HW, float inv_norm) {
  __shared__ GemmTiles t;
  __shared__ float scale[kTJ];
  const int c0 = blockIdx.x * kTC;
  const int i0 = blockIdx.y * kTJ;
  const long long n = blockIdx.z;
  const T* an = a + n * HW * HW;
  const float* gn = g + n * C * HW;
  const float* mn = m + n * HW;
  const float* ln = l + n * HW;
  if (threadIdx.x < kTJ) scale[threadIdx.x] = inv_norm;

  const int kk = threadIdx.x % kTI;
  float acc[kMC][kMJ] = {};
  for (int j0 = 0; j0 < HW; j0 += kTI) {
    load_cols<kTC, kXS>(t.s1, gn, HW, C, HW, c0, j0);
    {
      const int j = j0 + kk;
      const bool jin = j < HW;
      const float mj = jin ? mn[j] : 0.f;
      const float lj = jin ? ln[j] : 1.f;
#pragma unroll
      for (int r = 0; r < kTJ / (kThreads / kTI); ++r) {
        const int ii = threadIdx.x / kTI + (kThreads / kTI) * r;
        const int i = i0 + ii;
        t.s2[kk][ii] = (jin && i < HW) ? expf(ld(an + (long long)i * HW + j) - mj) / lj : 0.f;
      }
    }
    __syncthreads();
    accumulate(t.s1, t.s2, acc);
    __syncthreads();
  }
  store_tile(acc, scale, dx + n * C * HW, C, HW, c0, i0);
}

struct FlashBwdTiles {
  GemmTiles gemm;
  __align__(16) float pt[kTC][kPS];  // p^T of the current query tile
};

// Flash backward: da and dx (f32) in one launch. Grid (ceil(HW/64) row
// tiles, N); dynamic shared memory sizeof(FlashBwdTiles).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
psa_flash_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                     const float* __restrict__ g, const float* __restrict__ m,
                     const float* __restrict__ l, const float* __restrict__ delta,
                     T* __restrict__ da, float* __restrict__ dx, int C, int HW,
                     float inv_norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  FlashBwdTiles& t = *reinterpret_cast<FlashBwdTiles*>(smem);
  const int i0 = blockIdx.x * kTJ;
  const long long n = blockIdx.y;
  const T* xn = x + n * C * HW;
  const T* an = a + n * HW * HW;
  const float* gn = g + n * C * HW;
  float* dxn = dx + n * C * HW;
  const int lane = threadIdx.x % 32;
  const int jw = (threadIdx.x / 32) * kMJ;

  for (int j0 = 0; j0 < HW; j0 += kTC) {
    {
      float acc[kMC][kMJ] = {};
      gemm_dpt(t.gemm, xn, gn, C, HW, j0, i0, acc);
      da_epilogue(acc, an, m + n * HW, l + n * HW, delta + n * HW, da + n * HW * HW,
                  HW, j0, i0, inv_norm, t.pt);
    }
    __syncthreads();
    const bool first = j0 == 0;
    const bool last = j0 + kTC >= HW;
    for (int c0 = 0; c0 < C; c0 += kTC) {
      // This thread's dx sums so far: it wrote them itself on the last tile.
      float acc[kMC][kMJ];
#pragma unroll
      for (int r = 0; r < kMC; ++r) {
        const int c = c0 + lane + 32 * r;
#pragma unroll
        for (int q = 0; q < kMJ; ++q) {
          const int i = i0 + jw + q;
          acc[r][q] = (!first && c < C && i < HW) ? dxn[(long long)c * HW + i] : 0.f;
        }
      }
      for (int k0 = 0; k0 < kTC; k0 += kTI) {
        load_cols<kTC, kXS>(t.gemm.s1, gn, HW, C, HW, c0, j0 + k0);
        __syncthreads();
        accumulate(t.gemm.s1, &t.pt[k0], acc);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kMC; ++r) {
        const int c = c0 + lane + 32 * r;
        if (c >= C) continue;
#pragma unroll
        for (int q = 0; q < kMJ; ++q) {
          const int i = i0 + jw + q;
          if (i < HW) dxn[(long long)c * HW + i] = last ? acc[r][q] * inv_norm : acc[r][q];
        }
      }
    }
  }
}

template <bool kFlash>
int launch_fwd(const void* x, const void* a, void* out, void* m, void* l, int n,
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

template <typename T>
int launch_flash_bwd(const void* x, const void* a, const void* g, const void* m,
                     const void* l, const void* delta, void* da, void* dx, int n,
                     int c, int hw, float inv_norm, cudaStream_t s) {
  const int bytes = (int)sizeof(FlashBwdTiles);
  cudaError_t err = cudaFuncSetAttribute(
      psa_flash_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hw + kTJ - 1) / kTJ, n);
  psa_flash_bwd_kernel<T><<<grid, kThreads, bytes, s>>>(
      (const T*)x, (const T*)a, (const float*)g, (const float*)m, (const float*)l,
      (const float*)delta, (T*)da, (float*)dx, c, hw, inv_norm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int semseg_psa_softmax_bmm(const void* x, const void* a, void* out,
                                      void* m, void* l, int n, int c, int hw,
                                      float inv_norm, int is_bf16, void* stream) {
  return launch_fwd<false>(x, a, out, m, l, n, c, hw, inv_norm, is_bf16, stream);
}

extern "C" int semseg_psa_softmax_bmm_flash(const void* x, const void* a,
                                            void* out, void* m, void* l, int n,
                                            int c, int hw, float inv_norm,
                                            int is_bf16, void* stream) {
  return launch_fwd<true>(x, a, out, m, l, n, c, hw, inv_norm, is_bf16, stream);
}

extern "C" int semseg_psa_bwd_da(const void* x, const void* a, const void* g,
                                 const void* m, const void* l, const void* delta,
                                 void* da, int n, int c, int hw, float inv_norm,
                                 int is_bf16, void* stream) {
  if (n == 0 || hw == 0) return 0;
  const dim3 grid((hw + kTC - 1) / kTC, (hw + kTJ - 1) / kTJ, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    psa_bwd_da_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)a, (const float*)g,
        (const float*)m, (const float*)l, (const float*)delta, (__nv_bfloat16*)da,
        c, hw, inv_norm);
  } else {
    psa_bwd_da_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)a, (const float*)g, (const float*)m,
        (const float*)l, (const float*)delta, (float*)da, c, hw, inv_norm);
  }
  return (int)cudaGetLastError();
}

extern "C" int semseg_psa_bwd_dx(const void* a, const void* g, const void* m,
                                 const void* l, void* dx, int n, int c, int hw,
                                 float inv_norm, int is_bf16, void* stream) {
  if (n == 0 || c == 0 || hw == 0) return 0;
  const dim3 grid((c + kTC - 1) / kTC, (hw + kTJ - 1) / kTJ, n);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    psa_bwd_dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a, (const float*)g, (const float*)m, (const float*)l,
        (float*)dx, c, hw, inv_norm);
  } else {
    psa_bwd_dx_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)a, (const float*)g, (const float*)m, (const float*)l,
        (float*)dx, c, hw, inv_norm);
  }
  return (int)cudaGetLastError();
}

extern "C" int semseg_psa_flash_bwd(const void* x, const void* a, const void* g,
                                    const void* m, const void* l, const void* delta,
                                    void* da, void* dx, int n, int c, int hw,
                                    float inv_norm, int is_bf16, void* stream) {
  if (n == 0 || hw == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return launch_flash_bwd<__nv_bfloat16>(x, a, g, m, l, delta, da, dx, n, c, hw,
                                           inv_norm, s);
  }
  return launch_flash_bwd<float>(x, a, g, m, l, delta, da, dx, n, c, hw, inv_norm, s);
}
