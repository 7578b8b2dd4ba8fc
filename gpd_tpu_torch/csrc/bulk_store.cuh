// The output side of the persistent raster kernels (raster_blocks.cu,
// raster_sums.cu): a work item's histogram is built in one of two
// shared-memory buffers, handed to the copy engine as one asynchronous bulk
// store (cp.async.bulk shared -> global, no tensor map), and the block goes
// straight on to clear the other buffer and accumulate the next item while
// the store drains.
//
// Ordering, per the PTX memory model:
//  - every thread that wrote the buffer issues fence.proxy.async.shared::cta
//    before the barrier that precedes the store, so the copy engine (the
//    async proxy) sees the generic-proxy atomics;
//  - a buffer is cleared again only after cp.async.bulk.wait_group.read has
//    seen its store finish reading it, and a barrier has passed that on;
//  - the block waits for its last store to finish reading shared memory
//    before it exits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread: store `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from shared memory to global memory as one bulk group.
__device__ __forceinline__ void store(void* dst, const void* src,
                                      uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(s), "r"(bytes)
      : "memory");
}

// One thread: wait until every bulk group it committed has read its source.
__device__ __forceinline__ void wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The block clears n4 float4s of shared memory.
__device__ __forceinline__ void clear(float* p, int n4) {
  float4* p4 = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Ends one work item of the block: `hist` holds its n finished floats,
// which go to `out`; then the buffer of the next item (`next`, next_n4
// float4s; next == nullptr when there is none) is cleared. With
// `use_bulk` (n*4 and both addresses multiples of 16) thread 0 issues one
// bulk store; otherwise every thread copies. With two buffers the store of
// this item runs on while the next is accumulated; with one it is waited
// for before the buffer is cleared. Every thread of the block calls this;
// it ends on a barrier, after which the next item's atomics may start.
__device__ __forceinline__ void finish_item(float* hist, float* out, int n,
                                            bool use_bulk, bool two_buffers,
                                            float* next, int next_n4) {
  if (use_bulk) fence_proxy_async();
  if (two_buffers) {
    // The other buffer's store (the previous item's) must be done reading
    // before `next`, which is that buffer, is cleared.
    if (use_bulk && threadIdx.x == 0) wait_read_all();
    __syncthreads();
  } else {
    __syncthreads();
  }
  if (use_bulk) {
    if (threadIdx.x == 0) store(out, hist, static_cast<uint32_t>(n) * 4u);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = hist[i];
  }
  if (!two_buffers) {
    if (use_bulk && threadIdx.x == 0) wait_read_all();
    __syncthreads();
  }
  if (next != nullptr) clear(next, next_n4);
  __syncthreads();
}

}  // namespace bulk
