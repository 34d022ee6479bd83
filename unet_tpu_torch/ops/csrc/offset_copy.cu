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
// Mechanism, the same on Hopper: one warp, in which thread 0 does all the
// work. It reads the offset from device memory (the counterpart of the
// scalar prefetch: the host never learns it), checks it, initialises an mbarrier in shared memory, arms it with expect_tx for 4096
// bytes and issues one 1-D bulk async copy (cp.async.bulk ...
// mbarrier::complete_tx::bytes, the TMA path without a tensor map) from
// global memory into a 128-byte-aligned shared buffer. It waits on the
// barrier's phase 0 (mbarrier.try_wait.parity, in a loop), then sends the
// buffer to `out` with one bulk copy shared -> global (bulk_group; commit,
// then wait_group.read 0 so that shared memory outlives the read).
//
// Status: `status` is a word of pinned host memory, mapped into the
// device's address space (the launcher asks cudaHostGetDevicePointer for
// its device address). The host clears it to 0 before the launch and reads
// it after waiting on the stream; the kernel writes 1 there for an offset
// outside 0 <= off and off*8 + 8 <= R, and then copies nothing. A good
// call writes nothing to the host: such a write crosses PCIe, and a kernel
// ends only once it has landed, about 1 us later (PERF.md §6). The call
// makes one device operation, the kernel, and no device-to-host copy. A
// kernel that fails to launch or faults shows as the launcher's error or
// as an error of the stream's synchronisation, not through the word.
//
// Bound: launch latency. The function moves 4 KiB in and 4 KiB out (about
// 2.4 ns at 3.35 TB/s), so the card's time is the launch and three
// dependent memory round trips (offset, rows in, rows out), not bytes or
// operations. The design keeps it to one
// warp and two bulk copies (the bulk store out measured the same as
// 16-byte stores by the warp, PERF.md §6). It exists to run, on this card,
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(32)
offset_copy_kernel(const float* __restrict__ src, const int* __restrict__ off,
                   float* __restrict__ out, int* __restrict__ status,
                   int n_rows) {
  __shared__ __align__(128) float buf[kRows * kCols];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;

  const long long o = off[0];
  if (o < 0 || o * kRows + kRows > n_rows) {
    *status = 1;
    return;
  }
  const uint32_t bar_addr = smem_addr(&bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar_addr), "r"(1) : "memory");
  // make the initialised barrier visible to the async proxy that the bulk
  // copy completes through
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar_addr), "r"(kBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(buf)), "l"(src + o * kRows * kCols), "r"(kBytes),
         "r"(bar_addr)
      : "memory");

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
  // order the completed load before the bulk store's read of the buffer
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(out), "r"(smem_addr(buf)), "r"(kBytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__global__ void empty_kernel() {}

}  // namespace

// `status` is the host address of a pinned int32 word; its device address
// comes from cudaHostGetDevicePointer. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of
// cudaHostGetDevicePointer. The host checks shapes, dtypes, devices and the
// 16-byte alignment of src and out (both bulk copies need it) before
// calling; the offset is checked on the device.
extern "C" int offset_copy_launch(const float* src, const int* off, float* out,
                                  int* status, int n_rows,
                                  cudaStream_t stream) {
  int* status_dev = nullptr;
  const cudaError_t e = cudaHostGetDevicePointer(
      reinterpret_cast<void**>(&status_dev), status, 0);
  if (e != cudaSuccess) return (int)e;
  offset_copy_kernel<<<1, 32, 0, stream>>>(src, off, out, status_dev, n_rows);
  return (int)cudaGetLastError();
}

extern "C" int offset_copy_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 1, 0, stream>>>();
  return (int)cudaGetLastError();
}
