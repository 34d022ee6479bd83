// bn_stats: the per-channel reductions of training-mode BatchNorm.
//
// Replaces the two TPU kernels of unet_tpu/ops/pallas_bn.py:
//
//   _stats_kernel (sum_and_sumsq)  out[0, c] = sum x,   out[1, c] = sum x*x
//   _bwd_kernel   (bn_bwd_sums)    out[0, c] = sum dy,  out[1, c] = sum dy*xhat,
//                                  xhat = (x - mean[c]) * inv[c]
//
// each over every (n, h, w) of an NCHW tensor, in float32, for bf16 or f32
// inputs read in their own type. Any N, C, H, W: the TPU kernels' (N, C)
// row-block view and its divisibility rule were VMEM-tiling artifacts and
// are not carried over.
//
// Design: a deterministic two-stage reduction, no atomics. Stage 1 runs a
// (C, S) grid: block (c, s) sums a fixed contiguous range of channel c's
// N*H*W values (N runs of H*W contiguous values in NCHW) and writes its two
// partial sums to scratch. Splitting N*H*W over S blocks fills the 132 SMs
// also where C is small or H*W is large. Each thread keeps one accumulator
// per lane of its 16-byte loads (8 for bf16, 4 for f32; 1 when H*W does not
// allow aligned vector loads), so its sequential chains stay short; the
// block then sums its threads in a fixed shuffle order. Stage 2 sums the S
// partials of each channel in order. The grid depends only on the shape,
// so two launches on the same input give bit-identical sums.
//
// Bound: bytes. Each input is read once, and one or two float adds and
// multiplies per element are far below the card's float rate. The 43
// training BatchNorms of the xresnet34 U-Net read 0.96 GB of bf16 per step
// forward (0.29 ms at 3.35 TB/s) and twice that backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Sums a and b over the block's threads in a fixed order; the result is
// valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32];
  __shared__ float sb[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.f;
    b = lane < kThreads / 32 ? sb[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
  }
}

// Stage 1. hwv = H*W/V packs per (n, c) run; block (c, s) covers packs
// [s*chunk, (s+1)*chunk) of channel c's N*hwv. With BWD false, dy and the
// statistics are unused and the sums are (x, x*x).
template <typename T, int V, bool BWD>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ mean, const float* __restrict__ inv,
               float* __restrict__ partial, int N, int C, long long hwv,
               long long chunk) {
  const int c = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const long long total = (long long)N * hwv;
  const long long lo = (long long)s * chunk;
  const long long hi = lo + chunk < total ? lo + chunk : total;
  const float m = BWD ? mean[c] : 0.f;
  const float iv = BWD ? inv[c] : 0.f;
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = 0.f;
    b[i] = 0.f;
  }
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(x);
  const Pack<T, V>* gp = reinterpret_cast<const Pack<T, V>*>(dy);
  for (long long v = lo; v < hi;) {
    const long long n = v / hwv;
    const long long run_end = (n + 1) * hwv < hi ? (n + 1) * hwv : hi;
    // pack v of channel c lies at ((n*C + c)*hwv + v - n*hwv)
    const long long shift = ((long long)n * C + c) * hwv - n * hwv;
#pragma unroll 4
    for (long long k = v + threadIdx.x; k < run_end; k += kThreads) {
      const Pack<T, V> p = xp[shift + k];
      if (BWD) {
        const Pack<T, V> g = gp[shift + k];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float gi = to_f32(g.v[i]);
          const float xh = (to_f32(p.v[i]) - m) * iv;
          a[i] += gi;
          b[i] += gi * xh;
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float f = to_f32(p.v[i]);
          a[i] += f;
          b[i] += f * f;
        }
      }
    }
    v = run_end;
  }
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sa += a[i];
    sb += b[i];
  }
  block_sum2(sa, sb);
  if (threadIdx.x == 0) {
    partial[((long long)c * S + s) * 2] = sa;
    partial[((long long)c * S + s) * 2 + 1] = sb;
  }
}

// Stage 2: out[0, c] and out[1, c] are channel c's S partials summed in
// order.
__global__ void finish_kernel(const float* __restrict__ partial,
                              float* __restrict__ out, int C, int S) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int s = 0; s < S; ++s) {
    a += partial[((long long)c * S + s) * 2];
    b += partial[((long long)c * S + s) * 2 + 1];
  }
  out[c] = a;
  out[C + c] = b;
}

template <typename T, bool BWD>
int launch(const void* x, const void* dy, const float* mean, const float* inv,
           float* partial, float* out, int N, int C, long long HW, int V,
           int S, long long chunk, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid(C, S);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  if (V == 1) {
    partial_kernel<T, 1, BWD><<<grid, kThreads, 0, stream>>>(
        xt, gt, mean, inv, partial, N, C, HW, chunk);
  } else if (V == kVec && HW % kVec == 0) {
    partial_kernel<T, kVec, BWD><<<grid, kThreads, 0, stream>>>(
        xt, gt, mean, inv, partial, N, C, HW / kVec, chunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish_kernel<<<(C + 127) / 128, 128, 0, stream>>>(partial, out, C, S);
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(int dtype, const void* x, const void* dy, const float* mean,
             const float* inv, float* partial, float* out, int N, int C,
             long long HW, int V, int S, long long chunk, cudaStream_t stream) {
  if (N <= 0 || C <= 0 || HW <= 0 || S <= 0 || S > 65535 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, BWD>(x, dy, mean, inv, partial, out, N, C, HW, V, S,
                              chunk, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, BWD>(x, dy, mean, inv, partial, out, N, C,
                                      HW, V, S, chunk, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (N, C, H, W) contiguous, dtype 0 = float32, 1 = bfloat16. V: 1, or the
// values per 16-byte load (4 for float32, 8 for bf16) when H*W is a multiple
// of it and x is 16-byte aligned. chunk: packs of V values per block of the
// (C, S) grid, with S*chunk >= N*H*W/V. partial: 2*C*S floats of scratch;
// out: (2, C) float32. Launches on `stream`; returns cudaGetLastError().
extern "C" int bn_stats_launch(const void* x, float* partial, float* out,
                               int dtype, int N, int C, long long HW, int V,
                               int S, long long chunk, cudaStream_t stream) {
  return dispatch<false>(dtype, x, nullptr, nullptr, nullptr, partial, out, N,
                         C, HW, V, S, chunk, stream);
}

// The same for the backward sums; dy has x's shape and dtype, mean and inv
// are (C,) float32.
extern "C" int bn_bwd_launch(const void* dy, const void* x, const float* mean,
                             const float* inv, float* partial, float* out,
                             int dtype, int N, int C, long long HW, int V,
                             int S, long long chunk, cudaStream_t stream) {
  return dispatch<true>(dtype, x, dy, mean, inv, partial, out, N, C, HW, V, S,
                        chunk, stream);
}
