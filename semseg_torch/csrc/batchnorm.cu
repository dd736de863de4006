// Inference-mode BatchNorm of bf16 NCHW activations, with the ReLU and the
// residual add that follow it in a residual block folded in.
//
// Replaces no TPU kernel. The JAX package computes eval BatchNorm as plain
// jnp (semseg_tpu/models/layers.py:142-145) and XLA fuses it into its
// neighbours, so it never costs a pass of its own there. PyTorch runs the
// same expression eagerly: a cast to f32, a subtract, a multiply, a
// multiply and an add over the whole activation, each in f32, a cast back,
// then the ReLU (and in a bottleneck's last BN the residual add). That is
// about 44 bytes of device memory traffic for each bf16 element, 48 with
// the ReLU. This kernel reads each element once and writes it once and
// does the arithmetic in registers.
//
// Bound on an H100: bytes. 4 B an element (bf16 in, bf16 out), 6 B with the
// residual; the per-channel values are a few KB that stay in L1 and L2.
// [8, 2048, 90, 90]: 0.158 ms at 3.35 TB/s, 0.238 ms with the residual.
//
// Rounding points, those of the eager path bit for bit:
//     t = bf16( ((f32(x) - mean) * invstd) * weight + bias )
// each operation rounded in f32 (__fsub_rn, __fmul_rn, __fadd_rn: nvcc may
// contract none of them into an FMA); invstd = rsqrtf(var + eps), the f32
// add and the rsqrtf that torch.rsqrt(running_var + eps) runs on the card
// (the card tests hold it bit for bit on seeded variances), computed here
// from the running variance at every launch, so no copy of it goes stale
// when training moves the statistics. With the
// residual, t = bf16(f32(t) + f32(residual)), the eager bf16 add. The ReLU
// acts on the bf16 value as the eager in-place ReLU does (NaN kept, else
// fmaxf(t, 0)).
//
// Design. A grid-stride loop over 16-byte vectors (8 bf16), neighbouring
// threads on neighbouring vectors, two vectors a thread in flight, as many
// blocks as fit on the SMs at once. A vector's first element gives its
// plane and channel by two multiply-shift divisions. A plane's size is
// often odd (357^2, 179^2), so a vector may straddle two planes, and at the
// pyramid pooling's 1x1 to 6x6 several: a vector that lies in one plane
// takes its channel's four values once, one that straddles steps the
// channel element by element. Nothing is padded. Elements past the last
// whole vector, and every element when a pointer is not 16-byte aligned
// (a view with an offset), take the scalar form of the same loop.
//
// A channels-last tensor ([N, H, W, C] in memory) is the same walk with
// plane 1: the channel changes every element.
//
// Interface: plain C, bound from Python with ctypes. The launch goes on the
// caller's stream, does not synchronise and allocates nothing; the return
// value is cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // vectors a thread keeps in flight
constexpr int kMaxDevices = 64;

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by a multiply and a shift
// (Granlund and Montgomery; PyTorch's IntDivider).
struct Divider {
  unsigned d, magic, shift;
};

Divider make_divider(unsigned d) {
  unsigned shift = 0;
  while ((1u << shift) < d) ++shift;
  const uint64_t one = 1;
  const uint64_t magic = ((one << 32) * ((one << shift) - d)) / d + 1;
  return Divider{d, (unsigned)magic, shift};
}

__device__ __forceinline__ unsigned divide(const Divider& v, unsigned n) {
  return (__umulhi(n, v.magic) + n) >> v.shift;
}

struct Channels {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

struct Affine {
  float mean, invstd, weight, bias;
};

__device__ __forceinline__ Affine affine(const Channels& ch, unsigned c) {
  return Affine{__ldg(ch.mean + c), rsqrtf(__fadd_rn(__ldg(ch.var + c), ch.eps)),
                __ldg(ch.weight + c), __ldg(ch.bias + c)};
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One element: a bf16-valued float.
template <bool kResidual>
__device__ __forceinline__ float normalize(float x, const Affine& a, float r, bool relu) {
  float t = round_bf16(
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, a.mean), a.invstd), a.weight), a.bias));
  if (kResidual) t = round_bf16(__fadd_rn(t, r));
  if (relu && !isnan(t)) t = fmaxf(t, 0.f);
  return t;
}

// V bf16 values moved as one load or store (16 bytes for V = 8).
template <int V>
struct alignas(2 * V) Pack {
  __nv_bfloat16 h[V];
};

// Elements [i, i + V) from `xs` (and `rs`), i the index of the first in the
// flattened [N, C, plane] tensor.
template <int V, bool kResidual>
__device__ __forceinline__ Pack<V> normalize_pack(const Pack<V>& xs, const Pack<V>& rs,
                                                  unsigned i, const Channels& ch,
                                                  const Divider& plane, const Divider& channels,
                                                  bool relu) {
  const unsigned p = divide(plane, i);  // plane index, n C + c
  unsigned r = i - p * plane.d;         // offset in the plane
  unsigned c = p - divide(channels, p) * channels.d;
  Pack<V> out;
  if (r + V <= plane.d) {  // one channel
    const Affine a = affine(ch, c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out.h[k] = __float2bfloat16_rn(normalize<kResidual>(
          __bfloat162float(xs.h[k]), a, kResidual ? __bfloat162float(rs.h[k]) : 0.f, relu));
    }
  } else {  // the vector crosses into the next plane (or several)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const Affine a = affine(ch, c);
      out.h[k] = __float2bfloat16_rn(normalize<kResidual>(
          __bfloat162float(xs.h[k]), a, kResidual ? __bfloat162float(rs.h[k]) : 0.f, relu));
      if (++r == plane.d) {
        r = 0;
        c = c + 1 == channels.d ? 0 : c + 1;
      }
    }
  }
  return out;
}

// n elements: n / V whole packs by the grid-stride loop, the n % V after
// them by the first threads of block 0.
template <int V, bool kResidual>
__global__ void __launch_bounds__(kThreads)
semseg_batchnorm_eval_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ residual,
                             __nv_bfloat16* __restrict__ out, Channels ch, unsigned n,
                             Divider plane, Divider channels, int relu) {
  const Pack<V>* xv = reinterpret_cast<const Pack<V>*>(x);
  const Pack<V>* rv = reinterpret_cast<const Pack<V>*>(residual);
  Pack<V>* ov = reinterpret_cast<Pack<V>*>(out);
  const unsigned n_vec = n / V;
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned v0 = blockIdx.x * kThreads + threadIdx.x; v0 < n_vec; v0 += kUnroll * stride) {
    Pack<V> xs[kUnroll], rs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * stride;
      if (v < n_vec) {
        xs[u] = xv[v];
        if (kResidual) rs[u] = rv[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * stride;
      if (v < n_vec) {
        ov[v] = normalize_pack<V, kResidual>(xs[u], rs[u], v * V, ch, plane, channels, relu);
      }
    }
  }
  if (V > 1 && blockIdx.x == 0 && threadIdx.x < n - n_vec * V) {
    const unsigned i = n_vec * V + threadIdx.x;
    Pack<1> xs, rs, o;
    xs.h[0] = x[i];
    if (kResidual) rs.h[0] = residual[i];
    o = normalize_pack<1, kResidual>(xs, rs, i, ch, plane, channels, relu);
    out[i] = o.h[0];
  }
}

// Blocks of `kernel` resident on one SM at once, times the SMs, per device.
template <int V, bool kResidual>
int resident_blocks() {
  static int cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, semseg_batchnorm_eval_kernel<V, kResidual>, kThreads, 0) != cudaSuccess) {
      return 0;
    }
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <int V, bool kResidual>
int launch(const void* x, const void* residual, void* out, const Channels& ch, unsigned n,
           unsigned channels, unsigned plane, int relu, cudaStream_t s) {
  const int most = resident_blocks<V, kResidual>();
  if (most == 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? (int)err : (int)cudaErrorUnknown;
  }
  const unsigned n_vec = n / V;
  const unsigned need = (n_vec + kThreads - 1) / kThreads;
  const unsigned grid = need == 0 ? 1 : (need < (unsigned)most ? need : (unsigned)most);
  semseg_batchnorm_eval_kernel<V, kResidual><<<grid, kThreads, 0, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)residual, (__nv_bfloat16*)out, ch, n,
      make_divider(plane), make_divider(channels), relu);
  return (int)cudaGetLastError();
}

}  // namespace

// out = relu?(bf16(BN(x)) [+ residual]) over bf16 tensors of n elements
// (n < 2^31) laid out as [n / (channels plane), channels, plane]; mean,
// var (the running variance), weight and bias are f32 [channels]; residual
// may be null.
extern "C" int semseg_batchnorm_eval(const void* x, const void* residual, void* out,
                                     const void* mean, const void* var, const void* weight,
                                     const void* bias, float eps, long long n, int channels,
                                     long long plane, int relu, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || n >= (1LL << 31) || channels < 1 || plane < 1 || plane >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Channels ch{(const float*)mean, (const float*)var, (const float*)weight,
                    (const float*)bias, eps};
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)residual | (uintptr_t)out) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned un = (unsigned)n, uc = (unsigned)channels, up = (unsigned)plane;
  if (residual != nullptr) {
    return aligned ? launch<8, true>(x, residual, out, ch, un, uc, up, relu, s)
                   : launch<1, true>(x, residual, out, ch, un, uc, up, relu, s);
  }
  return aligned ? launch<8, false>(x, residual, out, ch, un, uc, up, relu, s)
                 : launch<1, false>(x, residual, out, ch, un, uc, up, relu, s);
}
