// PSA softmax + aggregation on the tensor cores: for each operand dtype a
// forward, a dx and a da kernel.
//
//     out[n, c, j] = inv_norm * sum_i x[n, c, i] * p[n, i, j],
//     p[n, :, j] = softmax_i(A[n, :, j]),  m = max_i A, l = sum_i exp(A - m)
//
// x is [N, C, HW], A is [N, HW, HW] (both bf16 or both f32), out is f32
// [N, C, HW]. The operand dtype picks the precision, as the TPU kernels'
// _precision_for does (psa_pallas.py:75-81): bf16 operands run one bf16
// pass with p (forward, dx) or g (da, dx) rounded to bf16 and f32 sums
// (psa_wgmma_kernel and psa_da_wgmma_kernel, the first part below); f32
// operands run at HIGHEST precision as 3xTF32 (psa_tf32x3_kernel, the
// second part, and psa_da_tf32x3_kernel, the third).
//
// Replaces (semseg_tpu/ops/psa_pallas.py):
// - _fwd_kernel (:48) and _flash_fwd_kernel (:303): the forward,
//   psa_wgmma_kernel<kMT, false> or psa_tf32x3_kernel<kMT, false>. Its
//   softmax is online over stages of source rows, as the TPU flash kernel's
//   is over source tiles, and its shared memory does not depend on HW. The
//   TPU split its forward in two only to bound VMEM, so one kernel serves
//   both entry points; it writes m and l when asked.
// - _bwd_dx_kernel (:140): psa_wgmma_kernel<kMT, true> or
//   psa_tf32x3_kernel<kMT, true>, dx = inv_norm * g p^T in x's dtype.
// - _bwd_da_kernel (:125): psa_da_wgmma_kernel or psa_da_tf32x3_kernel,
//   da = p * (inv_norm * x^T g - delta) in A's dtype.
// - _flash_bwd_kernel (:383): the dx and da kernels, launched in turn by the
//   caller from the flash forward's m and l.
// The upstream gradient g is f32 [N, C, HW]. The backward kernels recompute
// p = exp(A - m) / l from the forward's statistics and take delta[n, j] =
// sum_c g * out (f32 [N, HW], computed by the caller), the flash identity
// sum_i p * dP = sum_c g * out. The TPU resident backward held whole columns
// of A in VMEM and formed sum_i p * dP in the tile; a Hopper block that owns
// an i-tile of da cannot, so every backward uses the identity. Each part's
// comment gives its bound on an H100 and its design.
//
// Interface: plain C, bound from Python with ctypes. Every launch goes on
// the caller's stream, does not synchronise and allocates nothing; the
// return value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// ---------------------------------------------------------------------------
// Tensor-core kernels for bf16 operands: the forward, dx and da.
//
// They replace, for bf16 operands, the TPU kernels
// - _fwd_kernel (psa_pallas.py:48, pallas_call :95) and _flash_fwd_kernel
//   (psa_pallas.py:303, pallas_call :354): psa_wgmma_kernel<kMT, false>;
// - _bwd_dx_kernel (psa_pallas.py:140, pallas_call :197): psa_wgmma_kernel<kMT, true>;
// - _bwd_da_kernel (psa_pallas.py:125, pallas_call :184): psa_da_wgmma_kernel.
// f32 operands run the 3xTF32 kernels (forward and dx, second part; da,
// third part). This is the TPU kernels' own
// rule (_precision_for, psa_pallas.py:75-81): f32 operands run at HIGHEST
// precision; bf16 operands at DEFAULT, one bf16 MXU pass, so p (and g for
// dx) is rounded to bf16 and the sums are f32. Here that product runs on
// Hopper's tensor cores: wgmma m64n64k16, bf16 x bf16 -> f32, both operands
// K-major in shared memory in the 128-byte swizzle.
//
// Bound on an H100 SXM at the Cityscapes PSANet shape (N, C, hw) =
// (8, 512, 2025): the product is 2 N C hw^2 = 33.6 GFLOP, 0.034 ms at 989
// TFLOP/s bf16; the bytes take as long at 3.35 TB/s: 115.4 MB for the
// forward (A 65.6 MB bf16, x 16.6 MB, the f32 output 33.2 MB), 115.5 MB
// for dx (A, f32 g 33.2 MB, m and l, the bf16 output 16.6 MB).
//
// Design. A block owns 64 columns of the output (query columns j for the
// forward, source rows i for dx) and up to 512 channels: two warpgroups,
// each with kMT accumulators of 64 x 64 f32 (kMT = 4 at C = 512, 128
// registers a thread). So each p is formed once and A's strip is read once
// per pass. K runs in stages of 64 (source rows i for the forward, query
// columns j for dx), double-buffered in shared memory: while the tensor
// cores work on stage s, the threads form stage s + 1's p from A values
// loaded into registers a stage earlier, round it to bf16 and store it as
// the B operand, then issue the loads of stage s + 2; cp.async brings stage
// s + 1 of the other operand.
// - The other operand (x for the forward, g for dx) is first packed by
//   psa_pack_bf16_kernel into a bf16 [N, Cp, HWp] copy, zero-padded to
//   whole tiles (HWp a multiple of 64, Cp of 128 kMT). At hw = 2025 a row of
//   x starts only 2-byte aligned and a row of g is 8100 bytes long, so no
//   16-byte copy (cp.async or TMA) can read them in place, and staging f32 g
//   for a 512-channel block would not fit in shared memory. The pack also
//   does dx's rounding of g to bf16. It moves 33 MB (forward) or 50 MB (dx)
//   at N = 8.
// - Forward B operand, p[i, j] with n = j, k = i: A's rows run along j, so
//   a thread loads 16 consecutive source rows of one column (lanes along j:
//   coalesced) and stores them as two 16-byte chunks of row j, which is
//   conflict-free in the swizzle.
// - dx B operand, p[i, j] with n = i, k = j: A's own layout; a lane loads a
//   pair of columns and stores one 4-byte word, conflict-free.
// - The forward's softmax is online, as in the TPU's flash kernel: per
//   stage the four threads of a column merge their maxima in shared memory,
//   p = exp(a - m_running) (at most 1, so its bf16 rounding is 2^-9
//   relative as before), and the accumulators are rescaled by exp(m_old -
//   m_new) before the stage's products; the column sums divide in the
//   epilogue, which writes m and l when asked. So A is read once. (A first
//   pass for the exact max and sum is latency-bound with eight warps on an
//   SM: the forward ran 0.27 ms with it and 0.22 ms without, at (8, 512,
//   2025) on an H100.) dx takes m and l from the forward.
// - Epilogue: the accumulators, times the column factor, go through shared
//   memory so that the output (f32 for the forward, bf16 for dx, the
//   caller's dtype) is written along its rows, coalesced.
// Edges: source rows and columns past hw give p = 0 (loaded as -inf);
// padded channels and columns are masked on store. Any C and hw. Nothing
// carries between blocks: two calls give bit-identical results.
//
// da (psa_da_wgmma_kernel): dP = x^T g / norm on the tensor cores with g
// rounded to bf16 once (the TPU's DEFAULT pass), then da = p (dP - delta)
// in the epilogue, p = exp(a - m) / l from the forward's statistics, delta
// = sum_c g out from the caller, written in bf16.
// - Bound at (16, 512, 2025): 67.2 GFLOP (0.068 ms at 989 TFLOP/s) against
//   428 MB (A read and da written, 131 MB each; x, f32 g and out; 0.128
//   ms at 3.35 TB/s): bytes.
// - GEMM M = i, N = j, K = c. A block owns 128 source rows x 128 query
//   columns and all channels (no split K, no atomics; grid n-slowest, so a
//   batch row's packs, 2 MB each, stay in L2); warpgroup w holds rows 64 w
//   .. 64 w + 63 in two m64n64 accumulators (64 registers), 2 blocks an SM.
// - Operands: x and g are packed by psa_pack_bf16_kernel into zero-padded
//   bf16 [N, Cp, HWp] copies (Cp a multiple of 64, HWp of 128; the pack
//   rounds g), whose channel rows are exactly wgmma's MN-major layout: a
//   stage of 64 channels is 64 rows of 128 bytes per 64-position half,
//   copied with cp.async into the 128-byte swizzle, and wgmma reads both
//   operands transposed (desc_sw128_mn: a K step of 16 is 2048 bytes). A
//   ring of three 32 KB stages keeps two stages of copies ahead.
// - Epilogue: dP (times 1/norm) goes through shared memory (the ring), then
//   a warp walks rows of the tile: A read and da written along the rows, 2
//   bytes a lane (rows of odd hw are 2-byte aligned), coalesced; m, l and
//   delta loaded once per column; exp as ex2 of an FMA.
// - Any C and hw: the packs are zero-padded and the store masks padded rows
//   and columns. The flash backward's route calls it, and the dx kernel, at
//   hw 7921.

namespace tc {

constexpr int kTile = 64;                   // N columns a block; K depth a stage
constexpr int kRow = 128;                   // bytes of one 64-element bf16 row
constexpr int kStageB = kTile * kRow;       // the B operand's stage, 8 KB
constexpr int kOutStride = kTile + 8;       // f32 epilogue row stride: conflict-free
constexpr unsigned short kNegInf = 0xFF80;  // bf16 -inf: p = 0

// The forward's online softmax: per-stage column max partials (at the end,
// the column sum partials), the per-stage rescale factors by stage parity,
// and the epilogue's per-column factor.
struct Online {
  float red[kThreads / kTile][kTile];
  float alpha[2][kTile];
  float scale[kTile];
};

// Bytes of the A operand's stage (both warpgroups' rows) and of the whole
// dynamic shared memory (1 KB of slack for the 1024-byte alignment that
// the swizzle needs).
__host__ __device__ constexpr int stage_a(int mt) { return 2 * mt * 64 * kRow; }
__host__ __device__ constexpr int smem_bytes(int mt) {
  return 1024 + 2 * (stage_a(mt) + kStageB) + (int)sizeof(Online);
}
static_assert(4 * 128 * kOutStride * 4 <= 2 * (stage_a(4) + kStageB),
              "the epilogue staging fits in the operand stages");

// M tiles of 64 channels per warpgroup: a block covers 128 kMT channels.
inline int m_tiles(int c) { return c <= 128 ? 1 : c <= 256 ? 2 : 4; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset of 16-byte chunk `chunk` (0..7) of row `row` in a tile of
// 128-byte rows in the 128-byte swizzle (wgmma layout type 1).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * kRow + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile at
// shared address `addr`: 8-row groups 1024 bytes apart; the leading offset
// is unused for this layout. A K step of 16 adds 32 bytes to `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor of an MN-major, 128-byte-swizzled tile of
// 64 M (or N) elements: each K index is one 128-byte row, 8-row groups 1024
// bytes apart. With one 64-element atom along MN the two byte offsets are
// the 8-row group stride and an unused atom stride; both are set to 1024.
// A K step of 16 adds 2048 bytes to `addr`.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 64] += A[64 x 16] B[16 x 64], both read from shared memory, K-major
// (kTrans = 0) or MN-major (kTrans = 1, both operands transposed).
// Thread t of the warpgroup holds d[4 q + 2 h + e] = row 16 (t / 32) +
// (t % 32) / 4 + 8 h, column 8 q + 2 (t % 4) + e.
template <int kTrans = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTrans));
}

// 2^x on the special function unit (flush-to-zero; x <= 0 where used).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float bf16_bits(unsigned short b) {
  return __uint_as_float((uint32_t)b << 16);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// src [N, C, HW] (bf16 or f32) -> dst bf16 [N, Cp, HWp], rounded to
// nearest even, zero outside C x HW. One thread per 8 outputs (16 bytes).
template <typename T>
__global__ void psa_pack_bf16_kernel(const T* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                     int C, int HW, int Cp, int HWp, long long total8) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= total8) return;
  const int k8 = (int)(id % (HWp / 8));
  const long long row = id / (HWp / 8);
  const int c = (int)(row % Cp);
  const long long n = row / Cp;
  const T* s = src + (n * C + c) * (long long)HW;
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = k8 * 8 + 2 * e;
    const float lo = (c < C && i < HW) ? ld(s + i) : 0.f;
    const float hi = (c < C && i + 1 < HW) ? ld(s + i + 1) : 0.f;
    w[e] = pack_bf16x2(lo, hi);
  }
  *reinterpret_cast<uint4*>(dst + id * 8) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Both tensor-core kernels. kDx = false: the resident forward; the block's
// tile is 64 query columns, K runs over source rows, the operand is packed
// x, out is f32 and m_out, l_out (when not null) get the column max and
// sum. kDx = true: dx; the tile is 64 source rows, K runs over query
// columns, the operand is packed g, m_in and l_in are the forward's, out is
// bf16. Grid (ceil(HW / 64), Cp / (128 kMT), N), 256 threads,
// smem_bytes(kMT) of dynamic shared memory.
template <int kMT, bool kDx>
__global__ void __launch_bounds__(kThreads, 1)
psa_wgmma_kernel(const __nv_bfloat16* __restrict__ op, const __nv_bfloat16* __restrict__ a,
                 const float* __restrict__ m_in, const float* __restrict__ l_in,
                 void* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                 int C, int HW, int Cp, int HWp, float inv_norm) {
  constexpr int kSA = stage_a(kMT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sa = smem_addr(smem);  // A operand stages, then B operand stages
  const uint32_t sb = sa + 2 * kSA;
  Online& on = *reinterpret_cast<Online*>(smem + 2 * kSA + 2 * kStageB);

  const int t0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * 128 * kMT;
  const long long n = blockIdx.z;
  const __nv_bfloat16* an = a + n * HW * HW;
  const unsigned short* araw = reinterpret_cast<const unsigned short*>(an);
  const __nv_bfloat16* opn = op + (n * Cp + c0) * (long long)HWp;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;

  // Each thread's part of the B operand (see the design note). Forward:
  // column jj, source rows 16 ig .. 16 ig + 15 of the stage, with the
  // column's running max and its share of the running sum. dx: query
  // columns 2 jp and 2 jp + 1 of the stage, source rows ir + 8 r.
  const int jj = tid % kTile, ig = tid / kTile;
  const int jp = tid % 32, ir = tid / 32;
  const bool jin = t0 + jj < HW;
  float m_run = -INFINITY, l_run = 0.f;
  unsigned short raw[16];
  float ml[4];  // dx: m and l of the thread's two columns

  auto load_operand = [&](int buf, int k0) {
#pragma unroll
    for (int u = 0; u < 4 * kMT; ++u) {
      const int id = tid + kThreads * u;
      const int r = id / 8, ch = id % 8;
      cp_async16(sa + buf * kSA + swz(r, ch), opn + (long long)r * HWp + k0 + ch * 8);
    }
    cp_async_commit();
  };
  auto fetch = [&](int k0) {
    if (!kDx) {
      const int j = t0 + jj;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int i = k0 + 16 * ig + r;
        raw[r] = (jin && i < HW) ? __ldg(araw + (long long)i * HW + j) : kNegInf;
      }
    } else {
      const int j = k0 + 2 * jp;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = t0 + ir + 8 * r;
        const unsigned short* row = araw + (long long)i * HW;
        raw[2 * r] = (i < HW && j < HW) ? __ldg(row + j) : kNegInf;
        raw[2 * r + 1] = (i < HW && j + 1 < HW) ? __ldg(row + j + 1) : kNegInf;
      }
      ml[0] = j < HW ? __ldg(m_in + n * HW + j) : 0.f;
      ml[1] = j + 1 < HW ? __ldg(m_in + n * HW + j + 1) : 0.f;
      ml[2] = j < HW ? __ldg(l_in + n * HW + j) : 1.f;
      ml[3] = j + 1 < HW ? __ldg(l_in + n * HW + j + 1) : 1.f;
    }
  };
  // Stage s's B operand into buffer s & 1. The forward's p is exp(a - m)
  // for the running column max m after this stage; alpha = exp(m_old - m)
  // rescales what the accumulators hold before stage s is added, and the
  // column sum divides at the end (an online softmax, so that A is read
  // once; the values rounded to bf16 are still at most 1).
  auto produce = [&](int s) {
    unsigned char* b = smem + 2 * kSA + (s & 1) * kStageB;
    if (!kDx) {
      float v[16];
      float tmax = -INFINITY;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        v[r] = bf16_bits(raw[r]);  // -inf past HW
        tmax = fmaxf(tmax, v[r]);
      }
      on.red[ig][jj] = tmax;
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kThreads / kTile; ++g) tmax = fmaxf(tmax, on.red[g][jj]);
      // Every stage has a source row < HW, so m is finite from stage 0 on
      // in a column < HW; columns past HW keep m = 0, alpha = 1, p = 0.
      const float m_new = jin ? fmaxf(m_run, tmax) : 0.f;
      const float alpha = jin ? expf(m_run - m_new) : 1.f;  // 0 on stage 0
      m_run = m_new;
      float sum = 0.f;
      uint32_t w[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float e0 = expf(v[2 * q] - m_new), e1 = expf(v[2 * q + 1] - m_new);
        sum += e0 + e1;
        w[q] = pack_bf16x2(e0, e1);
      }
      l_run = l_run * alpha + sum;
      if (ig == 0) on.alpha[s & 1][jj] = alpha;
      *reinterpret_cast<uint4*>(b + swz(jj, 2 * ig)) = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(b + swz(jj, 2 * ig + 1)) = make_uint4(w[4], w[5], w[6], w[7]);
    } else {
      const float r0 = 1.f / ml[2], r1 = 1.f / ml[3];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = ir + 8 * r;
        *reinterpret_cast<uint32_t*>(b + swz(row, jp / 4) + (jp % 4) * 4) =
            pack_bf16x2(expf(bf16_bits(raw[2 * r]) - ml[0]) * r0,
                        expf(bf16_bits(raw[2 * r + 1]) - ml[1]) * r1);
      }
    }
  };

  float acc[kMT][32];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[mt][e] = 0.f;
  }

  // A's loads for a stage are issued right after the previous stage's p
  // is formed, so they have a whole stage to arrive.
  const int stages = HWp / kTile;
  load_operand(0, 0);
  fetch(0);
  produce(0);
  if (stages > 1) fetch(kTile);
  for (int s = 0; s < stages; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < stages;
    if (more) {
      load_operand(cur ^ 1, (s + 1) * kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    if (!kDx) {  // rescale the thread's 16 columns by this stage's alpha
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 f = *reinterpret_cast<const float2*>(&on.alpha[cur][8 * q + 2 * (lane % 4)]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          acc[mt][4 * q] *= f.x;
          acc[mt][4 * q + 1] *= f.y;
          acc[mt][4 * q + 2] *= f.x;
          acc[mt][4 * q + 3] *= f.y;
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTile / 16; ++k) {
      const uint64_t db = desc_sw128(sb + cur * kStageB + k * 32);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint64_t da = desc_sw128(sa + cur * kSA + (wg * kMT + mt) * 64 * kRow + k * 32);
        wgmma_m64n64k16(acc[mt], da, db);
      }
    }
    wgmma_commit();
    if (more) produce(s + 1);
    if (s + 2 < stages) fetch((s + 2) * kTile);
    wgmma_wait_all();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) fence_regs(acc[mt]);
    __syncthreads();
  }

  if (!kDx) {  // the column sums; out = acc / (l norm)
    on.red[ig][jj] = l_run;
    __syncthreads();
    if (tid < kTile) {
      float l = 0.f;
#pragma unroll
      for (int g = 0; g < kThreads / kTile; ++g) l += on.red[g][tid];
      on.scale[tid] = jin ? inv_norm / l : 0.f;
      if (m_out != nullptr && blockIdx.y == 0 && jin) {
        m_out[n * HW + t0 + tid] = m_run;
        l_out[n * HW + t0 + tid] = l;
      }
    }
    __syncthreads();
  }

  // Epilogue: acc times the column factor -> shared [128 kMT rows]
  // [kOutStride] -> out rows.
  float* so = reinterpret_cast<float*>(smem);
  {
    const int warp = (tid % 128) / 32;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = 8 * q + 2 * (lane % 4);
      const float2 f = kDx ? make_float2(inv_norm, inv_norm)
                           : *reinterpret_cast<const float2*>(&on.scale[col]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wg * kMT + mt) * 64 + warp * 16 + lane / 4 + 8 * h;
          *reinterpret_cast<float2*>(so + row * kOutStride + col) =
              make_float2(acc[mt][4 * q + 2 * h] * f.x, acc[mt][4 * q + 2 * h + 1] * f.y);
        }
      }
    }
  }
  __syncthreads();
  for (int row = tid / 32; row < 128 * kMT && c0 + row < C; row += kThreads / 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = lane + 32 * h;
      if (t0 + col >= HW) continue;
      const long long o = (n * C + c0 + row) * (long long)HW + t0 + col;
      const float v = so[row * kOutStride + col];
      if (kDx) {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(out)[o] = v;
      }
    }
  }
}

// ---- da: dP = x^T g on the tensor cores, the softmax VJP in the epilogue.
constexpr int kDaTile = 128;                       // source rows i and query columns j a block
constexpr int kDaStages = 3;                       // ring of channel stages
constexpr int kDaHalf = kTile * kRow;              // 64 channels x 64 positions, 8 KB
constexpr int kDaStage = 2 * 2 * kDaHalf;          // x and g, two 64-position halves each
constexpr int kDaOutStride = kDaTile + 8;          // f32 epilogue row stride: conflict-free
constexpr int kDaSmem = 1024 + kDaStages * kDaStage;
static_assert(kDaTile * kDaOutStride * 4 <= kDaStages * kDaStage,
              "the epilogue staging fits in the ring");

// Packs for da: N x Cp x HWp with Cp a multiple of the 64-channel stage and
// HWp of the 128-position tile.
inline int da_cp(int c) { return (c + kTile - 1) / kTile * kTile; }
inline int da_hwp(int hw) { return (hw + kDaTile - 1) / kDaTile * kDaTile; }

// da[n, i, j] = p (inv_norm sum_c x[c, i] g[c, j] - delta[j]), p = exp(a -
// m[j]) / l[j], bf16. xp and gp are the bf16 packs of x and g ([N, Cp,
// HWp], zero-padded). Grid (HWp / 128 column tiles, HWp / 128 row tiles,
// N), 256 threads, kDaSmem bytes of dynamic shared memory. Warpgroup w owns
// rows 64 w .. 64 w + 63 of the block's i-tile and all 128 columns (two
// m64n64 accumulators). Both operands are read MN-major straight from the
// packs' rows (channel c: 64 consecutive positions, 128 bytes), so wgmma
// takes them transposed.
__global__ void __launch_bounds__(kThreads, 2)
psa_da_wgmma_kernel(const __nv_bfloat16* __restrict__ xp, const __nv_bfloat16* __restrict__ gp,
                    const __nv_bfloat16* __restrict__ a, const float* __restrict__ m_in,
                    const float* __restrict__ l_in, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ da, int HW, int Cp, int HWp, float inv_norm) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(smem);
  const int j0 = blockIdx.x * kDaTile;
  const int i0 = blockIdx.y * kDaTile;
  const long long n = blockIdx.z;
  const __nv_bfloat16* xn = xp + n * Cp * (long long)HWp + i0;
  const __nv_bfloat16* gn = gp + n * Cp * (long long)HWp + j0;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;

  // Stage layout: [x, g][64-position half][channel row of 128 bytes], each
  // 8 KB half in the 128-byte swizzle.
  auto load_stage = [&](int buf, int c0) {
    const uint32_t base = s0 + buf * kDaStage;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int id = tid + kThreads * u;
      const int op = u / 4, half = (id / 512) % 2, row = (id / 8) % kTile, ch = id % 8;
      const __nv_bfloat16* src =
          (op ? gn : xn) + (long long)(c0 + row) * HWp + half * kTile + ch * 8;
      cp_async16(base + (2 * op + half) * kDaHalf + swz(row, ch), src);
    }
    cp_async_commit();
  };

  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = 0.f;
  }
  // A commit group per stage slot, empty past the last stage, so that
  // "all but the newest kDaStages - 2 groups done" means stage s is in.
  const int stages = Cp / kTile;
#pragma unroll
  for (int s = 0; s < kDaStages - 1; ++s) {
    if (s < stages) {
      load_stage(s, s * kTile);
    } else {
      cp_async_commit();
    }
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kDaStages - 2>();
    fence_async_shared();
    __syncthreads();  // stage s is in for all; stage s - 1's products are done
    const int next = s + kDaStages - 1;
    if (next < stages) {
      load_stage(next % kDaStages, next * kTile);
    } else {
      cp_async_commit();
    }
    const uint32_t base = s0 + (s % kDaStages) * kDaStage;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTile / 16; ++k) {
      const uint64_t dx = desc_sw128_mn(base + wg * kDaHalf + k * 2048);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_m64n64k16<1>(acc[h], dx, desc_sw128_mn(base + (2 + h) * kDaHalf + k * 2048));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the epilogue's staging

  // dP tile -> shared [128 i][kDaOutStride] f32.
  float* so = reinterpret_cast<float*>(smem);
  {
    const int warp = (tid % 128) / 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wg * 64 + warp * 16 + lane / 4 + 8 * r;
          const int col = h * 64 + 8 * q + 2 * (lane % 4);
          *reinterpret_cast<float2*>(so + row * kDaOutStride + col) =
              make_float2(acc[h][4 * q + 2 * r] * inv_norm, acc[h][4 * q + 2 * r + 1] * inv_norm);
        }
      }
    }
  }
  __syncthreads();

  // A warp walks rows i; lane takes columns j0 + lane + 32 k, so A is read
  // and da written along the rows (2-byte aligned at odd hw), coalesced.
  float cm[4], cr[4], cd[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + lane + 32 * k;
    const bool in = j < HW;
    cm[k] = in ? __ldg(m_in + n * HW + j) * kLog2e : 0.f;
    cr[k] = in ? 1.f / __ldg(l_in + n * HW + j) : 0.f;
    cd[k] = in ? __ldg(delta + n * HW + j) : 0.f;
  }
  const unsigned short* araw = reinterpret_cast<const unsigned short*>(a);
  const int warp = tid / 32;
  for (int r0 = warp; r0 < kDaTile; r0 += 4 * (kThreads / 32)) {
    unsigned short av[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r0 + r * (kThreads / 32);
      const long long off = (n * HW + i) * (long long)HW + j0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + lane + 32 * k;
        av[r][k] = (i < HW && j < HW) ? __ldg(araw + off + lane + 32 * k) : (unsigned short)0;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + r * (kThreads / 32);
      const int i = i0 + row;
      const long long off = (n * HW + i) * (long long)HW + j0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = lane + 32 * k;
        if (i < HW && j0 + col < HW) {
          const float p = exp2_ftz(fmaf(bf16_bits(av[r][k]), kLog2e, -cm[k])) * cr[k];
          da[off + col] = __float2bfloat16_rn(p * (so[row * kDaOutStride + col] - cd[k]));
        }
      }
    }
  }
}

int launch_da(const __nv_bfloat16* x, const float* g, const __nv_bfloat16* a, const float* m,
              const float* l, const float* delta, __nv_bfloat16* da, __nv_bfloat16* pack, int n,
              int c, int hw, float inv_norm, cudaStream_t s) {
  if (n == 0 || hw == 0) return 0;
  const int cp = da_cp(c), hwp = da_hwp(hw);
  const long long total8 = (long long)n * cp * hwp / 8;
  __nv_bfloat16* xpk = pack;
  __nv_bfloat16* gpk = pack + (long long)n * cp * hwp;
  if (total8 > 0) {
    const unsigned blocks = (unsigned)((total8 + 255) / 256);
    psa_pack_bf16_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(x, xpk, c, hw, cp, hwp, total8);
    psa_pack_bf16_kernel<float><<<blocks, 256, 0, s>>>(g, gpk, c, hw, cp, hwp, total8);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(psa_da_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hwp / kDaTile, hwp / kDaTile, n);
  psa_da_wgmma_kernel<<<grid, kThreads, kDaSmem, s>>>(xpk, gpk, a, m, l, delta, da, hw, cp, hwp,
                                                      inv_norm);
  return (int)cudaGetLastError();
}

// Elements of the packed operand for (n, c, hw): N x Cp x HWp.
inline long long pack_elems(int n, int c, int hw) {
  const int rows = 128 * m_tiles(c);
  return (long long)n * ((c + rows - 1) / rows * rows) * ((hw + kTile - 1) / kTile * kTile);
}

template <int kMT, bool kDx, typename T>
int launch(const T* src, const __nv_bfloat16* a, const float* m_in, const float* l_in,
           void* out, float* m_out, float* l_out, __nv_bfloat16* pack, int n, int c, int hw,
           float inv_norm, cudaStream_t s) {
  const int rows = 128 * kMT;
  const int cp = (c + rows - 1) / rows * rows;
  const int hwp = (hw + kTile - 1) / kTile * kTile;
  const long long total8 = (long long)n * cp * hwp / 8;
  psa_pack_bf16_kernel<T><<<(unsigned)((total8 + 255) / 256), 256, 0, s>>>(
      src, pack, c, hw, cp, hwp, total8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int bytes = smem_bytes(kMT);
  err = cudaFuncSetAttribute(psa_wgmma_kernel<kMT, kDx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hw + kTile - 1) / kTile, cp / rows, n);
  psa_wgmma_kernel<kMT, kDx><<<grid, kThreads, bytes, s>>>(
      pack, a, m_in, l_in, out, m_out, l_out, c, hw, cp, hwp, inv_norm);
  return (int)cudaGetLastError();
}

template <bool kDx, typename T>
int dispatch(const T* src, const void* a, const float* m_in, const float* l_in, void* out,
             float* m_out, float* l_out, void* pack, int n, int c, int hw, float inv_norm,
             void* stream) {
  if (n == 0 || c == 0 || hw == 0) return 0;
  const auto* ab = (const __nv_bfloat16*)a;
  auto* pk = (__nv_bfloat16*)pack;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m_tiles(c)) {
    case 1:
      return launch<1, kDx>(src, ab, m_in, l_in, out, m_out, l_out, pk, n, c, hw, inv_norm, s);
    case 2:
      return launch<2, kDx>(src, ab, m_in, l_in, out, m_out, l_out, pk, n, c, hw, inv_norm, s);
    default:
      return launch<4, kDx>(src, ab, m_in, l_in, out, m_out, l_out, pk, n, c, hw, inv_norm, s);
  }
}

// ---------------------------------------------------------------------------
// f32 operands: the forward and dx on the tensor cores as 3xTF32.
//
// They replace, for f32 operands, the same TPU kernels as psa_wgmma_kernel
// (_fwd_kernel, psa_pallas.py:48, _flash_fwd_kernel, :303, and
// _bwd_dx_kernel, :140), whose f32
// contract is HIGHEST precision. Each f32 operand v is split into a TF32
// high part hi = rna(v) and a TF32 remainder lo = rna(v - hi) (hi + lo is v
// within 2^-22 |v|), and each product runs as lo*hi + hi*lo + hi*hi into
// f32 accumulators (wgmma m64n64k8 .tf32; the dropped lo*lo term is 2^-22
// relative). CUTLASS's 3xTF32 GEMMs do the same. One TF32 pass would
// be 2^-11 relative, far outside the 1e-5 bars.
//
// Bound on an H100 SXM at (8, 512, 2025): three passes of 33.6 GFLOP at 495
// TFLOP/s dense TF32, 0.204 ms; the bytes (A 131 MB of f32, x or g 33 MB,
// the f32 output 33 MB) take 0.059 ms. So operations bound it, three times
// over the bf16 kernel's work at half its rate.
//
// Design: psa_wgmma_kernel's skeleton (a block owns 64 output columns, the
// online-softmax forward, dx from the forward's m and l, the epilogue
// through shared memory), with both operands K-major in shared memory, as
// TF32 wgmma requires (it has no transpose bits): x's and g's rows run
// along K already, and p is formed in registers and stored K-major. What
// differs is the bytes: hi and lo of both operands, 4 bytes each, so a
// stage of 128 kMT channel rows holds a quarter of the bf16 kernel's depth
// in the same room.
// - Stages of K = 32: one 128-byte-swizzled row of f32, so swz and
//   desc_sw128 above hold unchanged and a K step of 8 adds 32 bytes. Up to
//   256 channels a block (kMT <= 2): a stage is 80 KB (A hi and lo 32 KB
//   each, p hi and lo 8 KB each), double-buffered in 160 KB; at C = 512 two
//   blocks share a query tile, each forming its p.
// - Accumulation: the tensor cores add each k8 product into the f32
//   accumulators without rounding to nearest (measured on an H100: with
//   768 such adds over K = 2048 in one accumulator, the sums drifted by
//   2.6 times JAX's element-wise 1e-4 / 1e-5 bar). So each stage's products
//   start from zero in `acc` (12 adds) and are then added to `sum` on the
//   CUDA cores, rounded to nearest; the forward's online-softmax rescaling
//   by alpha goes into that add. Two register tiles of 64 x 64 kMT: at
//   kMT = 4 (all 512 channels in a block) they would not fit.
// - Operand pack: psa_pack_tf32x3_kernel writes hi and lo of x (forward) or
//   g (dx) as f32 bit patterns into [2][N, Cp, HWp], zero-padded to whole
//   tiles: at hw 2025 an f32 row is 8100 bytes long, so rows are not 16-byte
//   aligned for cp.async. At N = 8 it reads 33 MB and writes 67 MB.
// - p is exp(a - m) for the running column max (forward; l divides at the
//   end) or exp(a - m) / l (dx), with expf, split in registers and stored as
//   hi and lo: a thread's stores are two 16-byte chunks of one row
//   (forward) or 4-byte words along a row (dx), conflict-free.
// No atomics: two calls give bit-identical results.

constexpr int kTf32K = 32;                        // K depth of a stage: one 128-byte row
constexpr int kTf32PartB = kTile * kRow;          // p's hi or lo in a stage, 8 KB
__host__ __device__ constexpr int tf32_part_a(int mt) { return 128 * mt * kRow; }
__host__ __device__ constexpr int tf32_stage(int mt) {
  return 2 * tf32_part_a(mt) + 2 * kTf32PartB;
}
__host__ __device__ constexpr int tf32_smem_bytes(int mt) {
  return 1024 + 2 * tf32_stage(mt) + (int)sizeof(Online);
}
static_assert(2 * 128 * kOutStride * 4 <= 2 * tf32_stage(2),
              "the epilogue staging fits in the operand stages");
static_assert(tf32_smem_bytes(2) <= 232448, "fits in the shared memory of a block");

// M tiles of 64 channels per warpgroup for f32 operands.
inline int tf32_m_tiles(int c) { return c <= 128 ? 1 : 2; }

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}
// v = hi + lo + O(2^-22 |v|), both TF32 bit patterns.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d[64 x 64] = (acc ? d : 0) + A[64 x 8] B[8 x 64], TF32 operands K-major in
// shared memory.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t da, uint64_t db,
                                                    int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// src f32 [N, C, HW] -> dst [2][N, Cp, HWp]: the TF32 high parts, then the
// remainders, as f32 bit patterns, zero outside C x HW. One thread per 4
// outputs of each part (16 bytes).
__global__ void psa_pack_tf32x3_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                       int C, int HW, int Cp, int HWp, long long total4) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= total4) return;
  const int k4 = (int)(id % (HWp / 4));
  const long long row = id / (HWp / 4);
  const int c = (int)(row % Cp);
  const long long n = row / Cp;
  const float* s = src + (n * C + c) * (long long)HW;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = k4 * 4 + e;
    split_tf32((c < C && i < HW) ? __ldg(s + i) : 0.f, hi[e], lo[e]);
  }
  *reinterpret_cast<uint4*>(dst + id * 4) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + (total4 + id) * 4) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Both 3xTF32 kernels, as psa_wgmma_kernel: kDx = false the resident
// forward (tile of 64 query columns, K over source rows, operand packed x,
// m_out and l_out written when not null); kDx = true dx (tile of 64 source
// rows, K over query columns, operand packed g, m_in and l_in the
// forward's). out is f32 for both. Grid (ceil(HW / 64), Cp / (128 kMT), N),
// 256 threads, tf32_smem_bytes(kMT) of dynamic shared memory. Stage buffer
// layout: A hi, A lo (128 kMT rows each), B hi, B lo (64 rows each).
template <int kMT, bool kDx>
__global__ void __launch_bounds__(kThreads, 1)
psa_tf32x3_kernel(const float* __restrict__ op, const float* __restrict__ a,
                  const float* __restrict__ m_in, const float* __restrict__ l_in,
                  float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                  int C, int HW, int Cp, int HWp, float inv_norm) {
  constexpr int kPA = tf32_part_a(kMT), kSt = tf32_stage(kMT);
  constexpr int kV = kTf32K * kTile / kThreads;  // B values a thread forms per stage (8)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(smem);
  Online& on = *reinterpret_cast<Online*>(smem + 2 * kSt);

  const int t0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * 128 * kMT;
  const long long n = blockIdx.z;
  const float* an = a + n * HW * HW;
  const float* hin = op + (n * Cp + c0) * (long long)HWp;
  const float* lon = hin + (long long)gridDim.z * Cp * HWp;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;

  // Each thread's part of the B operand. Forward: column jj, source rows
  // 8 ig .. 8 ig + 7 of the stage. dx: query column jp of the stage, source
  // rows ir + 8 r.
  const int jj = tid % kTile, ig = tid / kTile;
  const int jp = tid % kTf32K, ir = tid / kTf32K;
  const bool jin = t0 + jj < HW;
  float m_run = -INFINITY, l_run = 0.f;
  float raw[kV];
  float ml[2];  // dx: m and l of the thread's column

  auto load_operand = [&](int buf, int k0) {
#pragma unroll
    for (int u = 0; u < 4 * kMT; ++u) {
      const int id = tid + kThreads * u;
      const int r = id / 8, ch = id % 8;
      const long long src = (long long)r * HWp + k0 + ch * 4;
      const uint32_t dst = s0 + buf * kSt + swz(r, ch);
      cp_async16(dst, hin + src);
      cp_async16(dst + kPA, lon + src);
    }
    cp_async_commit();
  };
  auto fetch = [&](int k0) {
    if (!kDx) {
      const int j = t0 + jj;
#pragma unroll
      for (int r = 0; r < kV; ++r) {
        const int i = k0 + kV * ig + r;
        raw[r] = (jin && i < HW) ? __ldg(an + (long long)i * HW + j) : -INFINITY;
      }
    } else {
      const int j = k0 + jp;
#pragma unroll
      for (int r = 0; r < kV; ++r) {
        const int i = t0 + ir + 8 * r;
        raw[r] = (i < HW && j < HW) ? __ldg(an + (long long)i * HW + j) : -INFINITY;
      }
      ml[0] = j < HW ? __ldg(m_in + n * HW + j) : 0.f;
      ml[1] = j < HW ? __ldg(l_in + n * HW + j) : 1.f;
    }
  };
  // Stage s's B operand, hi and lo, into buffer s & 1 (see psa_wgmma_kernel
  // for the forward's online softmax).
  auto produce = [&](int s) {
    unsigned char* bh = smem + (s & 1) * kSt + 2 * kPA;
    unsigned char* bl = bh + kTf32PartB;
    if (!kDx) {
      float tmax = -INFINITY;
#pragma unroll
      for (int r = 0; r < kV; ++r) tmax = fmaxf(tmax, raw[r]);
      on.red[ig][jj] = tmax;
      __syncthreads();
#pragma unroll
      for (int g = 0; g < kThreads / kTile; ++g) tmax = fmaxf(tmax, on.red[g][jj]);
      const float m_new = jin ? fmaxf(m_run, tmax) : 0.f;
      const float alpha = jin ? expf(m_run - m_new) : 1.f;  // 0 on stage 0
      m_run = m_new;
      float sum = 0.f;
      uint32_t h[kV], w[kV];
#pragma unroll
      for (int r = 0; r < kV; ++r) {
        const float e = expf(raw[r] - m_new);
        sum += e;
        split_tf32(e, h[r], w[r]);
      }
      l_run = l_run * alpha + sum;
      if (ig == 0) on.alpha[s & 1][jj] = alpha;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t off = swz(jj, 2 * ig + q);
        *reinterpret_cast<uint4*>(bh + off) =
            make_uint4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        *reinterpret_cast<uint4*>(bl + off) =
            make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
      }
    } else {
      const float rl = 1.f / ml[1];
#pragma unroll
      for (int r = 0; r < kV; ++r) {
        uint32_t h, w;
        split_tf32(expf(raw[r] - ml[0]) * rl, h, w);
        const uint32_t off = swz(ir + 8 * r, jp / 4) + (jp % 4) * 4;
        *reinterpret_cast<uint32_t*>(bh + off) = h;
        *reinterpret_cast<uint32_t*>(bl + off) = w;
      }
    }
  };

  // acc: a stage's products on the tensor cores; sum: all stages so far.
  float acc[kMT][32], sum[kMT][32];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[mt][e] = sum[mt][e] = 0.f;
  }

  const int stages = HWp / kTf32K;
  load_operand(0, 0);
  fetch(0);
  produce(0);
  if (stages > 1) fetch(kTf32K);
  for (int s = 0; s < stages; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < stages;
    if (more) {
      load_operand(cur ^ 1, (s + 1) * kTf32K);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    wgmma_fence();
    const uint32_t sa = s0 + cur * kSt;
#pragma unroll
    for (int k = 0; k < kTf32K / 8; ++k) {
      const uint64_t bh = desc_sw128(sa + 2 * kPA + k * 32);
      const uint64_t bl = desc_sw128(sa + 2 * kPA + kTf32PartB + k * 32);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint32_t am = sa + (wg * kMT + mt) * 64 * kRow + k * 32;
        const uint64_t ah = desc_sw128(am), al = desc_sw128(am + kPA);
        wgmma_m64n64k8_tf32(acc[mt], al, bh, k);  // small terms first; k = 0 starts from 0
        wgmma_m64n64k8_tf32(acc[mt], ah, bl, 1);
        wgmma_m64n64k8_tf32(acc[mt], ah, bh, 1);
      }
    }
    wgmma_commit();
    if (more) produce(s + 1);
    if (s + 2 < stages) fetch((s + 2) * kTf32K);
    wgmma_wait_all();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) fence_regs(acc[mt]);
    // sum = sum * alpha + acc, the thread's 16 columns (forward; alpha = 1
    // for dx), rounded to nearest.
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 f = kDx ? make_float2(1.f, 1.f)
                           : *reinterpret_cast<const float2*>(&on.alpha[cur][8 * q + 2 * (lane % 4)]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& v = sum[mt][4 * q + e];
          v = kDx ? v + acc[mt][4 * q + e] : fmaf(v, e % 2 ? f.y : f.x, acc[mt][4 * q + e]);
        }
      }
    }
    __syncthreads();
  }

  if (!kDx) {  // the column sums; out = sum / (l norm)
    on.red[ig][jj] = l_run;
    __syncthreads();
    if (tid < kTile) {
      float l = 0.f;
#pragma unroll
      for (int g = 0; g < kThreads / kTile; ++g) l += on.red[g][tid];
      on.scale[tid] = jin ? inv_norm / l : 0.f;
      if (m_out != nullptr && blockIdx.y == 0 && jin) {
        m_out[n * HW + t0 + tid] = m_run;
        l_out[n * HW + t0 + tid] = l;
      }
    }
    __syncthreads();
  }

  // Epilogue: sum times the column factor -> shared [128 kMT rows]
  // [kOutStride] -> out rows, coalesced.
  float* so = reinterpret_cast<float*>(smem);
  {
    const int warp = (tid % 128) / 32;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = 8 * q + 2 * (lane % 4);
      const float2 f = kDx ? make_float2(inv_norm, inv_norm)
                           : *reinterpret_cast<const float2*>(&on.scale[col]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wg * kMT + mt) * 64 + warp * 16 + lane / 4 + 8 * h;
          *reinterpret_cast<float2*>(so + row * kOutStride + col) =
              make_float2(sum[mt][4 * q + 2 * h] * f.x, sum[mt][4 * q + 2 * h + 1] * f.y);
        }
      }
    }
  }
  __syncthreads();
  for (int row = tid / 32; row < 128 * kMT && c0 + row < C; row += kThreads / 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = lane + 32 * h;
      if (t0 + col < HW) out[(n * C + c0 + row) * (long long)HW + t0 + col] = so[row * kOutStride + col];
    }
  }
}

// Floats of the 3xTF32 operand pack for (n, c, hw): [2][N, Cp, HWp].
inline long long tf32_pack_elems(int n, int c, int hw) {
  const int rows = 128 * tf32_m_tiles(c);
  return 2LL * n * ((c + rows - 1) / rows * rows) * ((hw + kTile - 1) / kTile * kTile);
}

template <int kMT, bool kDx>
int launch_tf32x3(const float* src, const float* a, const float* m_in, const float* l_in,
                  float* out, float* m_out, float* l_out, float* pack, int n, int c, int hw,
                  float inv_norm, cudaStream_t s) {
  const int rows = 128 * kMT;
  const int cp = (c + rows - 1) / rows * rows;
  const int hwp = (hw + kTile - 1) / kTile * kTile;
  const long long total4 = (long long)n * cp * hwp / 4;
  psa_pack_tf32x3_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, s>>>(src, pack, c, hw, cp,
                                                                          hwp, total4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int bytes = tf32_smem_bytes(kMT);
  err = cudaFuncSetAttribute(psa_tf32x3_kernel<kMT, kDx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hw + kTile - 1) / kTile, cp / rows, n);
  psa_tf32x3_kernel<kMT, kDx><<<grid, kThreads, bytes, s>>>(pack, a, m_in, l_in, out, m_out,
                                                            l_out, c, hw, cp, hwp, inv_norm);
  return (int)cudaGetLastError();
}

template <bool kDx>
int dispatch_tf32x3(const float* src, const float* a, const float* m_in, const float* l_in,
                    float* out, float* m_out, float* l_out, float* pack, int n, int c, int hw,
                    float inv_norm, void* stream) {
  if (n == 0 || c == 0 || hw == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tf32_m_tiles(c)) {
    case 1:
      return launch_tf32x3<1, kDx>(src, a, m_in, l_in, out, m_out, l_out, pack, n, c, hw,
                                   inv_norm, s);
    default:
      return launch_tf32x3<2, kDx>(src, a, m_in, l_in, out, m_out, l_out, pack, n, c, hw,
                                   inv_norm, s);
  }
}

// ---------------------------------------------------------------------------
// f32 operands: da on the tensor cores as 3xTF32.
//
// Replaces, for f32 operands, _bwd_da_kernel (psa_pallas.py:125,
// pallas_call :184) at HIGHEST precision: dP = x^T g / norm with x and g
// split into TF32 high parts and remainders, lo*hi + hi*lo + hi*hi into f32
// sums, then da = p (dP - delta) in the epilogue from the forward's m and l
// and the caller's delta, written in f32. The flash backward's route calls
// it too (at hw 7921), so it takes any C and hw.
//
// Bound on an H100 SXM at (8, 512, 2025): three TF32 passes of 33.6 GFLOP
// at 495 TFLOP/s, 0.204 ms; the bytes (A read and da written, 131 MB each
// at N = 8) take 0.078 ms. Operations.
//
// Design. GEMM M = i, N = j, K = c; a block owns 128 source rows x 128
// query columns and all channels (no split K, no atomics: two calls give
// bit-identical results); warpgroup w holds rows 64 w .. 64 w + 63 in m64n128
// tiles (wgmma m64n128k8 .tf32: both operands read once per k8 step for 128
// columns). One block an SM.
// - Operands K-major: TF32 wgmma has no transpose bits, and K = c is the
//   slow axis of x and g [C, HW]. psa_pack_tf32x3_t_kernel transposes them
//   through shared memory into hi and lo [2][N, HWp, Cp] (channels along
//   each row), zero-padded (Cp a multiple of 32, HWp of 128), so padded
//   channels add nothing to dP. A stage of 32 channels is then one 128-byte
//   row per position: cp.async copies it into the 128-byte swizzle and
//   desc_sw128 of the forward holds unchanged. Chosen over transposing in
//   the kernel: each x and g tile is read by HW/128 blocks, so a split in
//   the kernel would be repeated 16 times at hw 2025, and x's rows at hw
//   2025 are 8100 bytes, too misaligned for 16-byte copies. The pack reads
//   67 MB and writes 134 MB at N = 8.
// - A stage is 64 KB (x hi, x lo, g hi, g lo, 16 KB each); a ring of three,
//   192 KB, keeps the copies two stages ahead.
// - Rounded sums: the tensor cores truncate as they accumulate (see the
//   forward above), so each stage's 12 products start from zero and a
//   rounded f32 add folds them into the running sum (64 + 64 registers).
//   Each stage waits for its own products before the fold: a second
//   accumulator that overlapped stage s's products with stage s - 1's fold
//   bought nothing (+0.1 % at N = 8, -0.6 % at N = 16, +2.1 % at hw 7921;
//   a fold is 64 adds a thread beside 12 m64n128 MMAs).
// - Epilogue, as the bf16 da's but in f32: x^T g through shared memory; a
//   warp walks rows of the tile, A read and da written along the rows
//   (4-byte aligned at odd hw), coalesced; m, l and delta loaded once per
//   column; p = expf(a - m) / l as the plain version forms it, and dP -
//   delta as one FMA (one rounding fewer where they nearly cancel).
// Edges: padded rows i and columns j are masked on the store.

constexpr int kTdTile = 128;                // source rows i and query columns j a block
constexpr int kTdK = 32;                    // channels a stage: one 128-byte row of f32
constexpr int kTdStages = 3;                // ring of channel stages
constexpr int kTdPart = kTdTile * kRow;     // hi or lo of one operand's stage, 16 KB
constexpr int kTdStage = 4 * kTdPart;       // x hi, x lo, g hi, g lo
constexpr int kTdOutStride = kTdTile + 8;   // f32 epilogue row stride: conflict-free
constexpr int kTdSmem = 1024 + kTdStages * kTdStage;
static_assert(kTdSmem <= 232448, "fits in the shared memory of a block");
static_assert(kTdTile * kTdOutStride * 4 <= kTdStages * kTdStage,
              "the epilogue staging fits in the ring");

inline int td_cp(int c) { return (c + kTdK - 1) / kTdK * kTdK; }
inline int td_hwp(int hw) { return (hw + kTdTile - 1) / kTdTile * kTdTile; }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] = (acc ? d : 0) + A[64 x 8] B[8 x 128], TF32 operands K-major
// in shared memory. Thread t of the warpgroup holds d[4 q + 2 h + e] = row
// 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 q + 2 (t % 4) + e, q < 16.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                     int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// src f32 [N, C, HW] -> dst [2][N, HWp, Cp]: the TF32 high parts, then the
// remainders, transposed (channels along each row), zero outside C x HW.
// Grid (HWp / 32, Cp / 32, N), block (32, 8): a 32 x 32 tile through shared
// memory, read along positions and written along channels.
__global__ void psa_pack_tf32x3_t_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                         int C, int HW, int Cp, int HWp) {
  __shared__ float t[32][33];
  const int i0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const long long n = blockIdx.z;
  const float* s = src + n * C * (long long)HW;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r, i = i0 + threadIdx.x;
    t[r][threadIdx.x] = (c < C && i < HW) ? __ldg(s + (long long)c * HW + i) : 0.f;
  }
  __syncthreads();
  const long long part = (long long)gridDim.z * HWp * Cp;
  float* d = dst + n * HWp * (long long)Cp + c0 + threadIdx.x;
  for (int r = threadIdx.y; r < 32; r += 8) {
    uint32_t hi, lo;
    split_tf32(t[threadIdx.x][r], hi, lo);
    const long long o = (long long)(i0 + r) * Cp;
    d[o] = __uint_as_float(hi);
    d[part + o] = __uint_as_float(lo);
  }
}

// da[n, i, j] = p (inv_norm sum_c x[c, i] g[c, j] - delta[j]), p = exp(a -
// m[j]) / l[j], f32. xp and gp are the transposed packs of x and g (hi then
// lo, [2][N, HWp, Cp] each). Grid (HWp / 128 column tiles, HWp / 128 row
// tiles, N), 256 threads, kTdSmem bytes of dynamic shared memory.
__global__ void __launch_bounds__(kThreads, 1)
psa_da_tf32x3_kernel(const float* __restrict__ xp, const float* __restrict__ gp,
                     const float* __restrict__ a, const float* __restrict__ m_in,
                     const float* __restrict__ l_in, const float* __restrict__ delta,
                     float* __restrict__ da, int HW, int Cp, int HWp, float inv_norm) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(smem);
  const int j0 = blockIdx.x * kTdTile;
  const int i0 = blockIdx.y * kTdTile;
  const long long n = blockIdx.z;
  const long long part = (long long)gridDim.z * HWp * Cp;
  const float* xn = xp + (n * HWp + i0) * (long long)Cp;
  const float* gn = gp + (n * HWp + j0) * (long long)Cp;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;

  // Stage layout: [x hi, x lo, g hi, g lo][128 positions][32 channels, 128
  // bytes], each part in the 128-byte swizzle.
  auto load_stage = [&](int buf, int c0) {
    const uint32_t base = s0 + buf * kTdStage;
#pragma unroll
    for (int u = 0; u < kTdTile * 8 / kThreads; ++u) {
      const int id = tid + kThreads * u;
      const int r = id / 8, ch = id % 8;
      const long long off = (long long)r * Cp + c0 + ch * 4;
      const uint32_t dst = base + swz(r, ch);
      cp_async16(dst, xn + off);
      cp_async16(dst + kTdPart, xn + part + off);
      cp_async16(dst + 2 * kTdPart, gn + off);
      cp_async16(dst + 3 * kTdPart, gn + part + off);
    }
    cp_async_commit();
  };
  // A commit group per stage slot, empty past the last stage.
  auto load_or_commit = [&](int s, int stages) {
    if (s < stages) {
      load_stage(s % kTdStages, s * kTdK);
    } else {
      cp_async_commit();
    }
  };

  // acc: a stage's products; sum: all stages so far.
  float acc[64], sum[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = sum[e] = 0.f;

  const int stages = Cp / kTdK;
  for (int s = 0; s < kTdStages - 1; ++s) load_or_commit(s, stages);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kTdStages - 2>();
    fence_async_shared();
    __syncthreads();  // stage s is in for all
    const uint32_t base = s0 + (s % kTdStages) * kTdStage;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kTdK / 8; ++k) {
      const uint32_t am = base + wg * 64 * kRow + k * 32;
      const uint64_t ah = desc_sw128(am), al = desc_sw128(am + kTdPart);
      const uint64_t bh = desc_sw128(base + 2 * kTdPart + k * 32);
      const uint64_t bl = desc_sw128(base + 3 * kTdPart + k * 32);
      wgmma_m64n128k8_tf32(acc, al, bh, k);  // small terms first; k = 0 starts from 0
      wgmma_m64n128k8_tf32(acc, ah, bl, 1);
      wgmma_m64n128k8_tf32(acc, ah, bh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // every warpgroup is done with stage s's buffer
    load_or_commit(s + kTdStages - 1, stages);
    fence_regs(acc);
#pragma unroll
    for (int e = 0; e < 64; ++e) sum[e] += acc[e];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the epilogue's staging

  // x^T g tile -> shared [128 i][kTdOutStride] f32.
  float* so = reinterpret_cast<float*>(smem);
  {
    const int warp = (tid % 128) / 32;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wg * 64 + warp * 16 + lane / 4 + 8 * h;
        const int col = 8 * q + 2 * (lane % 4);
        *reinterpret_cast<float2*>(so + row * kTdOutStride + col) =
            make_float2(sum[4 * q + 2 * h], sum[4 * q + 2 * h + 1]);
      }
    }
  }
  __syncthreads();

  // A warp walks rows i; lane takes columns j0 + lane + 32 k, so A is read
  // and da written along the rows, coalesced.
  float cm[4], cl[4], cd[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + lane + 32 * k;
    const bool in = j < HW;
    cm[k] = in ? __ldg(m_in + n * HW + j) : 0.f;
    cl[k] = in ? __ldg(l_in + n * HW + j) : 1.f;
    cd[k] = in ? __ldg(delta + n * HW + j) : 0.f;
  }
  const int warp = tid / 32;
  constexpr int kRows = 4;  // rows a warp loads at once: 16 loads in flight a thread
  for (int r0 = warp; r0 < kTdTile; r0 += kRows * (kThreads / 32)) {
    float av[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r0 + r * (kThreads / 32);
      const long long off = (n * HW + i) * (long long)HW + j0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + lane + 32 * k;
        av[r][k] = (i < HW && j < HW) ? __ldg(a + off + lane + 32 * k) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r * (kThreads / 32);
      const int i = i0 + row;
      const long long off = (n * HW + i) * (long long)HW + j0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = lane + 32 * k;
        if (i < HW && j0 + col < HW) {
          const float p = expf(av[r][k] - cm[k]) / cl[k];
          da[off + col] = p * fmaf(so[row * kTdOutStride + col], inv_norm, -cd[k]);
        }
      }
    }
  }
}

// Floats of the 3xTF32 da's packs: x, then g, each [2][N, HWp, Cp].
inline long long td_pack_elems(int n, int c, int hw) {
  return 4LL * n * td_hwp(hw) * td_cp(c);
}

int launch_da_tf32x3(const float* x, const float* g, const float* a, const float* m,
                     const float* l, const float* delta, float* da, float* pack, int n, int c,
                     int hw, float inv_norm, cudaStream_t s) {
  if (n == 0 || hw == 0) return 0;
  const int cp = td_cp(c), hwp = td_hwp(hw);
  float* xpk = pack;
  float* gpk = pack + 2LL * n * hwp * cp;
  if (cp > 0) {
    const dim3 grid(hwp / 32, cp / 32, n), block(32, 8);
    psa_pack_tf32x3_t_kernel<<<grid, block, 0, s>>>(x, xpk, c, hw, cp, hwp);
    psa_pack_tf32x3_t_kernel<<<grid, block, 0, s>>>(g, gpk, c, hw, cp, hwp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(psa_da_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTdSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hwp / kTdTile, hwp / kTdTile, n);
  psa_da_tf32x3_kernel<<<grid, kThreads, kTdSmem, s>>>(xpk, gpk, a, m, l, delta, da, hw, cp,
                                                       hwp, inv_norm);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" long long semseg_psa_wgmma_pack_elems(int n, int c, int hw) {
  return tc::pack_elems(n, c, hw);
}

extern "C" int semseg_psa_softmax_bmm_wgmma(const void* x, const void* a, void* out, void* m,
                                            void* l, void* xpack, int n, int c, int hw,
                                            float inv_norm, void* stream) {
  return tc::dispatch<false>((const __nv_bfloat16*)x, a, nullptr, nullptr, out, (float*)m,
                             (float*)l, xpack, n, c, hw, inv_norm, stream);
}

// Elements of one of da's two packs (x, then g, in one buffer).
extern "C" long long semseg_psa_da_wgmma_pack_elems(int n, int c, int hw) {
  return (long long)n * tc::da_cp(c) * tc::da_hwp(hw);
}

extern "C" int semseg_psa_bwd_da_wgmma(const void* x, const void* g, const void* a,
                                       const void* m, const void* l, const void* delta, void* da,
                                       void* pack, int n, int c, int hw, float inv_norm,
                                       void* stream) {
  return tc::launch_da((const __nv_bfloat16*)x, (const float*)g, (const __nv_bfloat16*)a,
                       (const float*)m, (const float*)l, (const float*)delta,
                       (__nv_bfloat16*)da, (__nv_bfloat16*)pack, n, c, hw, inv_norm,
                       (cudaStream_t)stream);
}

extern "C" int semseg_psa_bwd_dx_wgmma(const void* a, const void* g, const void* m,
                                       const void* l, void* dx, void* gpack, int n, int c,
                                       int hw, float inv_norm, void* stream) {
  return tc::dispatch<true>((const float*)g, a, (const float*)m, (const float*)l, dx,
                            nullptr, nullptr, gpack, n, c, hw, inv_norm, stream);
}

// Floats of the 3xTF32 kernels' operand pack (hi and lo of x or g).
extern "C" long long semseg_psa_tf32x3_pack_elems(int n, int c, int hw) {
  return tc::tf32_pack_elems(n, c, hw);
}

extern "C" int semseg_psa_softmax_bmm_tf32x3(const void* x, const void* a, void* out, void* m,
                                             void* l, void* xpack, int n, int c, int hw,
                                             float inv_norm, void* stream) {
  return tc::dispatch_tf32x3<false>((const float*)x, (const float*)a, nullptr, nullptr,
                                    (float*)out, (float*)m, (float*)l, (float*)xpack, n, c, hw,
                                    inv_norm, stream);
}

extern "C" int semseg_psa_bwd_dx_tf32x3(const void* a, const void* g, const void* m,
                                        const void* l, void* dx, void* gpack, int n, int c,
                                        int hw, float inv_norm, void* stream) {
  return tc::dispatch_tf32x3<true>((const float*)g, (const float*)a, (const float*)m,
                                   (const float*)l, (float*)dx, nullptr, nullptr,
                                   (float*)gpack, n, c, hw, inv_norm, stream);
}

// Floats of the 3xTF32 da's transposed packs (hi and lo of x, then of g).
extern "C" long long semseg_psa_da_tf32x3_pack_elems(int n, int c, int hw) {
  return tc::td_pack_elems(n, c, hw);
}

extern "C" int semseg_psa_bwd_da_tf32x3(const void* x, const void* g, const void* a,
                                        const void* m, const void* l, const void* delta,
                                        void* da, void* pack, int n, int c, int hw,
                                        float inv_norm, void* stream) {
  return tc::launch_da_tf32x3((const float*)x, (const float*)g, (const float*)a,
                              (const float*)m, (const float*)l, (const float*)delta, (float*)da,
                              (float*)pack, n, c, hw, inv_norm, (cudaStream_t)stream);
}
