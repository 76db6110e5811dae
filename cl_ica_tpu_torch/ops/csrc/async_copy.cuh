// Bulk copies from device memory into shared memory that complete on an
// mbarrier (sm_90). The copy engine moves the bytes while the threads
// compute, and spends none of their registers or instructions on the
// addresses of what it moves.
//
// A ring slot's barrier completes one phase per use: one arrival (the
// thread that announces the bytes, mbar_expect) and the announced bytes
// (bulk_load). The u-th use of a slot is waited for with parity u & 1.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace clica {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier whose phase completes at one arrival and its announced bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// After the barriers are initialised and before __syncthreads: makes them
// visible to the copy engine.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of the barrier's current phase, announcing `bytes` of
// copies to come (0 completes the phase at once).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of this parity has completed: its bytes are in
// shared memory and visible to the waiting thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory at src to shared memory at dst, counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders the threads' earlier reads of shared memory (after a
// __syncthreads) before copies that overwrite it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace clica
