// blend_count: overlap-blend mosaic accumulation for whole-scene serving.
//
// Replaces the TPU blend family of unet_tpu/ops/blend.py — _blend_kernel
// (blend_tiles), _blocked_kernel (blend_tiles_blocked, DeviceMosaic's Pallas
// path) and _shift_kernel_body (blend_tiles_shift) — which are three TPU
// layouts of one function, plus the overlap counter the JAX package runs in
// XLA beside them (count_windows, blend_and_count):
//
//     for i in 0..N-1 (in order):
//         mosaic[:, r_i:r_i+th, c_i:c_i+tw] += tiles[i]
//         count[r_i:r_i+th, c_i:c_i+tw]     += 1
//
// Layout: mosaic (C, H, W) f32, count (H, W) f32, tiles (N, C, th, tw) f32,
// all contiguous; rowcol is (2N,) int32 on the device, rows then cols.
//
// Design: a deterministic gather. One thread per mosaic pixel of the batch's
// bounding box [y0, y0+bh) x [x0, x0+bw) (computed on the host). Each thread
// marks the tiles that cover its pixel in a bit mask, adds exactly those in
// tile order into a register, and writes its pixel once (once per 32 tiles
// for larger batches). Per pixel the adds happen in exactly the order of the
// sequential loop above, so the result is bit-identical to it (no atomics:
// their order would vary from run to run). Neighbouring threads of a warp
// read neighbouring addresses of the tiles and the mosaic.
//
// Bound: bytes. The function reads every tile once and reads and writes the
// covered mosaic and count once; it does one add per element. At 16 tiles of
// 3x512x512 that is ~50 MB of tiles against a few hundred thousand adds per
// SM, so device memory bandwidth is the limit. The TPU's folding, quadrant
// splits and 128-lane alignment were layout workarounds and are not carried
// over.

#include <cuda_runtime.h>

namespace {

__global__ void blend_count_kernel(float* __restrict__ mosaic,
                                   float* __restrict__ count,
                                   const float* __restrict__ tiles,
                                   const int* __restrict__ rowcol,
                                   int n, int c, int H, int W, int th, int tw,
                                   int y0, int x0, int bh, int bw) {
  extern __shared__ int sh[];  // rows[0..n), cols[0..n)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 2 * n; i += blockDim.x * blockDim.y) sh[i] = rowcol[i];
  __syncthreads();

  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  const int by = blockIdx.y * blockDim.y + threadIdx.y;
  if (bx >= bw || by >= bh) return;
  const int x = x0 + bx;
  const int y = y0 + by;
  const long long pix = (long long)y * W + x;
  const long long hw = (long long)H * W;
  const long long tile_px = (long long)th * tw;

  // Tiles are taken 32 at a time: one pass marks the covering ones in a
  // bit mask, then each channel adds exactly those, lowest index first.
  for (int base = 0; base < n; base += 32) {
    const int m = min(32, n - base);
    unsigned mask = 0u;
    for (int j = 0; j < m; ++j) {
      const int r = sh[base + j], q = sh[n + base + j];
      if (y >= r && y < r + th && x >= q && x < q + tw) mask |= 1u << j;
    }
    if (mask == 0u) continue;
    float cnt = count[pix];
    for (unsigned b = mask; b; b &= b - 1) cnt += 1.0f;
    count[pix] = cnt;
    for (int ch = 0; ch < c; ++ch) {
      float acc = mosaic[ch * hw + pix];
      for (unsigned b = mask; b; b &= b - 1) {
        const int i = base + __ffs(b) - 1;
        acc += tiles[((long long)i * c + ch) * tile_px +
                     (long long)(y - sh[i]) * tw + (x - sh[n + i])];
      }
      mosaic[ch * hw + pix] = acc;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// host checks shapes, dtypes and offsets before calling.
extern "C" int blend_count_launch(float* mosaic, float* count,
                                  const float* tiles, const int* rowcol,
                                  int n, int c, int H, int W, int th, int tw,
                                  int y0, int x0, int bh, int bw,
                                  cudaStream_t stream) {
  if (n <= 0 || bh <= 0 || bw <= 0) return 0;
  const size_t shmem = 2 * (size_t)n * sizeof(int);
  if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((bw + block.x - 1) / block.x, (bh + block.y - 1) / block.y);
  blend_count_kernel<<<grid, block, shmem, stream>>>(
      mosaic, count, tiles, rowcol, n, c, H, W, th, tw, y0, x0, bh, bw);
  return (int)cudaGetLastError();
}
