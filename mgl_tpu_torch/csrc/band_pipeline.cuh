// What the kernels that pipeline a pair's or a read's bands across the
// warps of one block share (sw_banded.cu, pairhmm_shared.cu):
// * the handoff: each warp publishes how far its band has written the
//   carry row with a release store to its counter in shared memory; the
//   band below polls that counter with acquire loads before it reads the
//   row;
// * where the carry row lies: in shared memory when that costs the launch
//   no resident blocks, else in global memory.
#pragma once

#include <algorithm>
#include <cstddef>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// every lane waits until the band above has published `target`
__device__ __forceinline__ void wait_for(const int* counter, int target) {
  while (load_acquire(counter) < target) __nanosleep(64);
  __syncwarp();
}

// Lets `kernel` take `smem` bytes of dynamic shared memory a block (above
// the default 48 KB a kernel must opt in).
template <typename Kernel>
cudaError_t allow_shared_memory(Kernel kernel, size_t smem) {
  if (smem <= (size_t{48} << 10)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int* blocks) {
  const cudaError_t e = allow_shared_memory(kernel, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

// Whether the carry row (`row_bytes` a block, after `head_bytes` of its
// own shared memory) goes to shared memory: when head and row fit the
// block's opt-in limit and `shared_kernel` then keeps at least as many
// blocks resident on each SM as n_blocks blocks of `global_kernel`, which
// reads the row from global memory, put there.
template <typename Kernel>
cudaError_t carry_in_shared(Kernel global_kernel, Kernel shared_kernel, int n_blocks,
                            int threads, size_t head_bytes, size_t row_bytes,
                            bool* shared) {
  int dev = 0, sms = 0, optin = 0, global_blocks = 0, shared_blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = resident_blocks(global_kernel, threads, head_bytes, &global_blocks);
  *shared = false;
  if (e != cudaSuccess || head_bytes + row_bytes > static_cast<size_t>(optin)) return e;
  e = resident_blocks(shared_kernel, threads, head_bytes + row_bytes, &shared_blocks);
  const int wanted = std::min((n_blocks + sms - 1) / sms, global_blocks);
  *shared = e == cudaSuccess && shared_blocks >= wanted;
  return e;
}

}  // namespace
