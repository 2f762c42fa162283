// Asynchronous copies from device memory into shared memory (cp.async), as
// the compositor kernels stage their batches (composite_batch.cuh) and K4
// stages its samples (shading.cu). A copy of BYTES = 4, 8 or 16 needs both
// addresses aligned to BYTES. The caller commits a stage's copies as one
// group and waits for all but its newest groups before it reads them.
#pragma once

#include <cuda_runtime.h>

namespace r3dg {

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES));
}

// A 16-byte copy cached in L2 only, not in L1: for data read once.
__device__ __forceinline__ void cp_async_stream16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace r3dg
