// flip_scale: per-sample flip and value scaling of a training batch.
//
// Replaces the TPU kernel _kernel of unet_tpu/ops/pallas_aug.py
// (_flip_pass, fused_flip_scale):
//
//   out[b, c, y, x]   = float(img[b, c, y', x']) * scales[b]
//   mask_out[b, y, x] = mask[b, y', x']
//   y' = vflip[b] ? H-1-y : y,   x' = hflip[b] ? W-1-x : x
//
// Layout: img (B, C, H, W) in its storage type (uint8, uint16, int16 or
// float32) and mask (B, H, W) of 1, 2, 4 or 8-byte integers, both
// contiguous; out (B, C, H, W) float32; mask_out like mask. flags is (B, 2)
// int32 (hflip, vflip); scales (B,) float32.
//
// Design: one thread per output value; block (x-block, y, plane) covers a
// row piece of one image plane (b, c) or, for planes B*C.., of one mask.
// The source is a mirrored index load, which is exact, so the TPU kernel's
// bf16 split permutation matmuls and its lane-folded view (workarounds for
// Mosaic's missing reversal) are not carried over. The widening cast and
// one float multiply give the same bits as float(x).flip(...) * scale.
// Each tile is read once in its storage type (1 byte a pixel for uint8)
// and written once as float32, in a single launch for images and masks.
//
// Bound: bytes. At 16 x 3 x 512^2 uint8 tiles with uint8 masks: 12.6 MB
// read and 50.3 MB written for the images, 4.2 MB each way for the masks;
// one multiply per value.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename TI, typename TM>
__global__ void flip_scale_kernel(const TI* __restrict__ img,
                                  float* __restrict__ out,
                                  const TM* __restrict__ mask,
                                  TM* __restrict__ mask_out,
                                  const int* __restrict__ flags,
                                  const float* __restrict__ scales, int B,
                                  int C, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y;
  const int plane = blockIdx.z;
  const int b = plane < B * C ? plane / C : plane - B * C;
  const int sx = flags[2 * b] ? W - 1 - x : x;
  const int sy = flags[2 * b + 1] ? H - 1 - y : y;
  const long long dst = (long long)y * W + x;
  const long long src = (long long)sy * W + sx;
  if (plane < B * C) {
    const long long base = (long long)plane * H * W;
    out[base + dst] = static_cast<float>(img[base + src]) * scales[b];
  } else {
    const long long base = (long long)b * H * W;
    mask_out[base + dst] = mask[base + src];
  }
}

template <typename TI, typename TM>
int launch(const void* img, float* out, const void* mask, void* mask_out,
           const int* flags, const float* scales, int B, int C, int H, int W,
           cudaStream_t stream) {
  const int planes = B * C + (mask != nullptr ? B : 0);
  if (planes > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((W + block.x - 1) / block.x, H, planes);
  flip_scale_kernel<TI, TM><<<grid, block, 0, stream>>>(
      static_cast<const TI*>(img), out, static_cast<const TM*>(mask),
      static_cast<TM*>(mask_out), flags, scales, B, C, H, W);
  return (int)cudaGetLastError();
}

template <typename TI>
int by_mask(int mask_bytes, const void* img, float* out, const void* mask,
            void* mask_out, const int* flags, const float* scales, int B,
            int C, int H, int W, cudaStream_t stream) {
  switch (mask_bytes) {
    case 0:
      return launch<TI, uint8_t>(img, out, nullptr, nullptr, flags, scales, B,
                                 C, H, W, stream);
    case 1:
      return launch<TI, uint8_t>(img, out, mask, mask_out, flags, scales, B,
                                 C, H, W, stream);
    case 2:
      return launch<TI, uint16_t>(img, out, mask, mask_out, flags, scales, B,
                                  C, H, W, stream);
    case 4:
      return launch<TI, uint32_t>(img, out, mask, mask_out, flags, scales, B,
                                  C, H, W, stream);
    case 8:
      return launch<TI, uint64_t>(img, out, mask, mask_out, flags, scales, B,
                                  C, H, W, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// img_kind: 0 uint8, 1 uint16, 2 int16, 3 float32. mask_bytes: 0 (no mask;
// mask pointers unused), 1, 2, 4 or 8 (masks are copied bit for bit).
// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// host checks shapes, types and contiguity before calling.
extern "C" int flip_scale_launch(const void* img, float* out, const void* mask,
                                 void* mask_out, const int* flags,
                                 const float* scales, int img_kind,
                                 int mask_bytes, int B, int C, int H, int W,
                                 cudaStream_t stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return 0;
  switch (img_kind) {
    case 0:
      return by_mask<uint8_t>(mask_bytes, img, out, mask, mask_out, flags,
                              scales, B, C, H, W, stream);
    case 1:
      return by_mask<uint16_t>(mask_bytes, img, out, mask, mask_out, flags,
                               scales, B, C, H, W, stream);
    case 2:
      return by_mask<int16_t>(mask_bytes, img, out, mask, mask_out, flags,
                              scales, B, C, H, W, stream);
    case 3:
      return by_mask<float>(mask_bytes, img, out, mask, mask_out, flags,
                            scales, B, C, H, W, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
