// cp.async for the CUDA-core kernels (moe_gmm_fp32.cu, flash_attention_fp32.cu, rmsnorm.cu):
// copies from device memory to shared memory that hold no registers,
// committed in groups and waited for by count, so a ring of shared tiles
// fills while the block computes on an earlier tile.  A copy moves the
// first `bytes` of its size from src and zero-fills the rest (cp.async's
// source size), so ragged edges load zeros; src must be a valid address
// even when bytes is 0.
#pragma once

namespace cuda_core {

// 16 bytes, bypassing L1; dst and src 16-byte aligned, bytes in [0, 16].
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src),
               "r"(bytes));
}

// 4 bytes (one float), for operands without 16-byte rows; bytes 0 or 4.
__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src),
               "r"(bytes));
}

// Closes this thread's group of copies issued since the last commit.
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's groups are in flight; a barrier
// then makes every thread's landed copies visible to all.
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace cuda_core
