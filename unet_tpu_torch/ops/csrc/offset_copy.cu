// offset_copy: copy 8 rows of a (R, 128) float32 array, chosen by an offset
// that lives in device memory, through shared memory into an (8, 128) output.
//
// Replaces the kernel inside unet_tpu/ops/probe.py _probe_scalar_prefetch_dma
// (the closure at :136, pallas_call at :153). There an int32[1] offset is
// scalar-prefetched, a DMA copies src[off*8 : off*8+8, :] from HBM into an
// (8, 128) VMEM scratch buffer and signals a DMA semaphore, and the scratch
// is then stored to the output:
//
//     out = src[off*8 : off*8 + 8, :]
//
// Mechanism, the same on Hopper: one block. Thread 0 reads the offset from
// device memory (the counterpart of the scalar prefetch: the host never
// learns it), initialises an mbarrier in shared memory, arms it with
// expect_tx for 4096 bytes and issues one 1-D bulk async copy
// (cp.async.bulk ... mbarrier::complete_tx::bytes, the TMA path without a
// tensor map) from global memory into a 128-byte-aligned shared buffer.
// Every thread waits on the barrier's phase 0 (mbarrier.try_wait.parity, in
// a loop), then the block stores shared memory to `out` in 16-byte stores.
//
// Bad offsets: outside 0 <= off and off*8 + 8 <= R the kernel writes 1 to
// `status` and copies nothing; otherwise it writes 0. The host reads the
// status back and raises.
//
// Bound: launch latency. The function moves 4 KiB in and 4 KiB out (about
// 2.4 ns at 3.35 TB/s), so the card's time is the launch and the copy's
// round trip, not bytes or operations. The design keeps it to one block and
// one copy; nothing here is worth tuning. It exists to run, on this card,
// the mechanism that later kernels build their pipelines from: a copy one
// thread starts and that completes into shared memory through an mbarrier.
//
// offset_copy_empty_launch launches a kernel that does nothing, as the
// yardstick of the launch latency that bounds offset_copy.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 128;
constexpr uint32_t kBytes = kRows * kCols * sizeof(float);  // 4096
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kThreads)
offset_copy_kernel(const float* __restrict__ src, const int* __restrict__ off,
                   float* __restrict__ out, int* __restrict__ status,
                   int n_rows) {
  __shared__ __align__(128) float buf[kRows * kCols];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int ok;

  const uint32_t bar_addr = smem_addr(&bar);
  if (threadIdx.x == 0) {
    const long long o = off[0];
    const int good = o >= 0 && o * kRows + kRows <= n_rows;
    ok = good;
    *status = good ? 0 : 1;
    if (good) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(bar_addr), "r"(1) : "memory");
      // make the initialised barrier visible to the async proxy that the
      // bulk copy completes through
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar_addr), "r"(kBytes) : "memory");
      const float* from = src + o * kRows * kCols;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(buf)), "l"(from), "r"(kBytes), "r"(bar_addr)
          : "memory");
    }
  }
  __syncthreads();  // the barrier is initialised and `ok` is set
  if (!ok) return;

  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar_addr), "r"(0) : "memory");
  }
  const float4* s4 = reinterpret_cast<const float4*>(buf);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int i = threadIdx.x; i < kRows * kCols / 4; i += kThreads) o4[i] = s4[i];
}

__global__ void empty_kernel() {}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// host checks shapes, dtypes, devices and the 16-byte alignment of src and
// out before calling; the offset is checked on the device.
extern "C" int offset_copy_launch(const float* src, const int* off, float* out,
                                  int* status, int n_rows,
                                  cudaStream_t stream) {
  offset_copy_kernel<<<1, kThreads, 0, stream>>>(src, off, out, status,
                                                 n_rows);
  return (int)cudaGetLastError();
}

extern "C" int offset_copy_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 1, 0, stream>>>();
  return (int)cudaGetLastError();
}
