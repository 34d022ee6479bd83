// flip_scale: per-sample flip and value scaling of a training batch.
//
// Replaces the TPU kernel _kernel of unet_tpu/ops/pallas_aug.py:126
// (_flip_pass, fused_flip_scale):
//
//   out[b, c, y, x]   = float(img[b, c, y', x']) * scale[b]
//   mask_out[b, y, x] = mask[b, y', x']
//   y' = vflip[b] ? H-1-y : y,   x' = hflip[b] ? W-1-x : x
//
// Layout: img (B, C, H, W) in its storage type (uint8, uint16, int16 or
// float32) and mask (B, H, W) of 1, 2, 4 or 8-byte integers, both
// contiguous; out (B, C, H, W) float32; mask_out like mask. The flags and
// scales of up to kMaxB samples come by value, in FlipParams; the host
// launches once per kMaxB samples. The widening cast and one float multiply
// (no add, so no FMA) give the bits of float(x).flip(...) * scale.
//
// Bound: bytes. At 16 x 3 x 512^2 uint8 tiles with uint8 masks: 12.6 MB
// read and 50.3 MB written for the images, 4.2 MB each way for the masks,
// 71.3 MB in all: 21.3 us at 3.35 TB/s.
//
// Design (the first version ran one element per thread, read the flags
// and scales from device memory in every thread, and needed two
// host-to-device copies of them per call):
// - Flags and scales go by value: FlipParams (hflip and vflip as bit words,
//   one float scale a sample) is a __grid_constant__ kernel parameter, so
//   a call makes no copy and a warp reads its sample's flags and scale
//   from the constant cache once per item.
// - Work items are (row, chunk): the B*C*H image rows, then the B*H mask
//   rows, each cut into chunks of kChunk groups. A warp takes one item at a
//   time in a grid-stride loop; the host sizes the grid from the SM count.
//   The row and sample arithmetic runs once per item, in 32-bit integers.
// - Word path: a group is 4 consecutive elements moved as one word. Lane l
//   takes groups l, l+32, l+64, l+96 of its chunk, so each load instruction
//   of a warp reads 32 contiguous words (128 bytes for uint8) and each image
//   store writes 32 contiguous float4 (512 bytes). All kUnroll loads are
//   issued before the first store: 16 bytes of uint8 loads in flight per
//   thread.
// - The h-flip happens in registers: output group j reads source group
//   W/4-1-j and reverses its 4 elements (__byte_perm for 1- and 2-byte
//   elements, word order for 4- and 8-byte ones). The v-flip only picks the
//   source row.
// - Element path: where W % 4 != 0 or a pointer is not 16-byte aligned the
//   launcher picks groups of one element, the same kernel with the first
//   version's indexing (still one coalesced access per warp instruction).
// - Stores are streaming (__stcs, evict-first): the 50 MB float32 output
//   would otherwise fill the 50 MB L2. PERF.md §6 has both policies'
//   times.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kMaxB = 512;     // samples per launch (aug.py MAX_B)
constexpr int kThreads = 256;  // aug.py WARPS_PER_BLOCK * 32
constexpr int kUnroll = 4;     // groups per lane and item
constexpr int kWord = 4;       // elements per group on the word path
constexpr int kChunk = 32 * kUnroll;  // groups per item (aug.py CHUNK)

struct FlipParams {
  uint32_t hbits[kMaxB / 32];  // bit b % 32 of word b / 32: sample b flips
  uint32_t vbits[kMaxB / 32];
  float scale[kMaxB];
};
static_assert(sizeof(FlipParams) == 2176, "layout shared with ops/aug.py");

struct alignas(16) Words8 {  // four 8-byte elements
  uint4 lo, hi;
};

// Four elements of S bytes as one word, and the word with them reversed.
template <int S>
struct Quad;
template <>
struct Quad<1> {
  using W = unsigned int;
  static __device__ W rev(W w) { return __byte_perm(w, 0, 0x0123); }
};
template <>
struct Quad<2> {
  using W = uint2;
  static __device__ W rev(W w) {
    return make_uint2(__byte_perm(w.y, 0, 0x1032), __byte_perm(w.x, 0, 0x1032));
  }
};
template <>
struct Quad<4> {
  using W = uint4;
  static __device__ W rev(W w) { return make_uint4(w.w, w.z, w.y, w.x); }
};
template <>
struct Quad<8> {
  using W = Words8;
  static __device__ W rev(W w) {
    return {make_uint4(w.hi.z, w.hi.w, w.hi.x, w.hi.y),
            make_uint4(w.lo.z, w.lo.w, w.lo.x, w.lo.y)};
  }
};

// One element of S bytes.
template <int S>
struct One {
  using W = std::conditional_t<
      S == 1, unsigned char,
      std::conditional_t<S == 2, unsigned short,
                         std::conditional_t<S == 4, unsigned int,
                                            unsigned long long>>>;
  static __device__ W rev(W w) { return w; }
};

template <typename T, int G>
using Group = std::conditional_t<G == kWord, Quad<sizeof(T)>, One<sizeof(T)>>;

template <typename W>
__device__ __forceinline__ void put(W* p, W v) {
  __stcs(p, v);
}
__device__ __forceinline__ void put(Words8* p, Words8 v) {
  put(&p->lo, v.lo);
  put(&p->hi, v.hi);
}

// The G elements of T in word w, widened to float and scaled.
template <typename T, int G, typename W>
__device__ __forceinline__ std::conditional_t<G == kWord, float4, float> widen(
    W w, float s) {
  T e[G];
  memcpy(e, &w, sizeof e);
  float f[G];
#pragma unroll
  for (int k = 0; k < G; ++k) f[k] = static_cast<float>(e[k]) * s;
  std::conditional_t<G == kWord, float4, float> o;
  memcpy(&o, f, sizeof o);
  return o;
}

// One lane's share of a warp item: groups j0, j0+32, ... of the output row
// `to` from the source row `from` (mirrored when hf); `fn` turns a source
// word of Grp into the output word. All loads go out before any store.
template <typename Grp, typename Out, typename Fn>
__device__ __forceinline__ void move_chunk(const typename Grp::W* __restrict__ from,
                                           Out* __restrict__ to, int j0,
                                           int groups, bool hf, Fn fn) {
  typename Grp::W w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + 32 * u;
    if (j < groups) w[u] = from[hf ? groups - 1 - j : j];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + 32 * u;
    if (j < groups) put(to + j, fn(hf ? Grp::rev(w[u]) : w[u]));
  }
}

template <typename TI, typename TM, int G>
__global__ void __launch_bounds__(kThreads)
flip_scale_kernel(const TI* __restrict__ img, float* __restrict__ out,
                  const TM* __restrict__ mask, TM* __restrict__ mask_out,
                  const __grid_constant__ FlipParams p, int B, int C, int H,
                  int W) {
  using IG = Group<TI, G>;
  using MG = Group<TM, G>;
  using OutW = std::conditional_t<G == kWord, float4, float>;
  const int groups = W / G;
  const unsigned chunks = (groups + kChunk - 1) / kChunk;
  const unsigned img_rows = (unsigned)B * C * H;
  const unsigned rows = img_rows + (mask != nullptr ? (unsigned)B * H : 0u);
  const unsigned items = rows * chunks;
  const int lane = threadIdx.x & 31;
  const unsigned warps = gridDim.x * (kThreads / 32);
  for (unsigned item = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       item < items; item += warps) {
    const unsigned row = item / chunks;
    const int j0 = (int)(item - row * chunks) * kChunk + lane;
    const bool is_img = row < img_rows;
    const unsigned r = is_img ? row : row - img_rows;  // plane * H + y
    const unsigned plane = r / (unsigned)H;
    const int y = (int)(r - plane * H);
    const int b = is_img ? (int)(plane / (unsigned)C) : (int)plane;
    const bool hf = (p.hbits[b >> 5] >> (b & 31)) & 1u;
    const bool vf = (p.vbits[b >> 5] >> (b & 31)) & 1u;
    const size_t dst = (size_t)r * groups;
    const size_t src = ((size_t)plane * H + (vf ? H - 1 - y : y)) * groups;
    if (is_img) {
      const float s = p.scale[b];
      move_chunk<IG>(reinterpret_cast<const typename IG::W*>(img) + src,
                     reinterpret_cast<OutW*>(out) + dst, j0, groups, hf,
                     [s](typename IG::W w) { return widen<TI, G>(w, s); });
    } else {
      move_chunk<MG>(reinterpret_cast<const typename MG::W*>(mask) + src,
                     reinterpret_cast<typename MG::W*>(mask_out) + dst, j0,
                     groups, hf, [](typename MG::W w) { return w; });
    }
  }
}

template <typename TI, typename TM>
int launch(const void* img, float* out, const void* mask, void* mask_out,
           const FlipParams& p, int B, int C, int H, int W, bool words,
           int blocks, cudaStream_t stream) {
  const TI* i = static_cast<const TI*>(img);
  const TM* m = static_cast<const TM*>(mask);
  TM* mo = static_cast<TM*>(mask_out);
  if (words)
    flip_scale_kernel<TI, TM, kWord>
        <<<blocks, kThreads, 0, stream>>>(i, out, m, mo, p, B, C, H, W);
  else
    flip_scale_kernel<TI, TM, 1>
        <<<blocks, kThreads, 0, stream>>>(i, out, m, mo, p, B, C, H, W);
  return (int)cudaGetLastError();
}

template <typename TI>
int by_mask(int mask_bytes, const void* img, float* out, const void* mask,
            void* mask_out, const FlipParams& p, int B, int C, int H, int W,
            bool words, int blocks, cudaStream_t stream) {
  switch (mask_bytes) {
    case 0:
      return launch<TI, uint8_t>(img, out, nullptr, nullptr, p, B, C, H, W,
                                 words, blocks, stream);
    case 1:
      return launch<TI, uint8_t>(img, out, mask, mask_out, p, B, C, H, W,
                                 words, blocks, stream);
    case 2:
      return launch<TI, uint16_t>(img, out, mask, mask_out, p, B, C, H, W,
                                  words, blocks, stream);
    case 4:
      return launch<TI, uint32_t>(img, out, mask, mask_out, p, B, C, H, W,
                                  words, blocks, stream);
    case 8:
      return launch<TI, unsigned long long>(img, out, mask, mask_out, p, B, C,
                                            H, W, words, blocks, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// sizeof(FlipParams), for the host's check of its packing.
extern "C" int flip_scale_param_bytes() { return (int)sizeof(FlipParams); }

// params: a host copy of FlipParams for the B <= kMaxB samples of this
// launch. img_kind: 0 uint8, 1 uint16, 2 int16, 3 float32. mask_bytes: 0
// (no mask; mask pointers unused), 1, 2, 4 or 8 (masks are copied bit for
// bit). blocks: the grid, sized by the host. The launcher takes the word
// path where W % 4 == 0 and every pointer is 16-byte aligned, else the
// element path. Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not
// take; the host checks shapes, types and contiguity before calling.
extern "C" int flip_scale_launch(const void* img, float* out, const void* mask,
                                 void* mask_out, const void* params,
                                 int img_kind, int mask_bytes, int B, int C,
                                 int H, int W, int blocks,
                                 cudaStream_t stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return 0;
  if (B > kMaxB || blocks <= 0) return (int)cudaErrorInvalidValue;
  const bool words = W % kWord == 0 && aligned16(img) && aligned16(out) &&
                     (!mask_bytes || (aligned16(mask) && aligned16(mask_out)));
  FlipParams p;
  memcpy(&p, params, sizeof p);
  switch (img_kind) {
    case 0:
      return by_mask<uint8_t>(mask_bytes, img, out, mask, mask_out, p, B, C,
                              H, W, words, blocks, stream);
    case 1:
      return by_mask<uint16_t>(mask_bytes, img, out, mask, mask_out, p, B, C,
                               H, W, words, blocks, stream);
    case 2:
      return by_mask<int16_t>(mask_bytes, img, out, mask, mask_out, p, B, C,
                              H, W, words, blocks, stream);
    case 3:
      return by_mask<float>(mask_bytes, img, out, mask, mask_out, p, B, C, H,
                            W, words, blocks, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
