// raster_sums: per-cell sums of one image projection for a batch of hands
// (the 1- and 3-channel grasp images), and a two-row-set mode that builds
// two histograms against one column index and one value set.
//
// Replaces gpd_tpu's Pallas TPU kernels _raster_sums_pallas
// (gpd_tpu/ops/images.py:53, pallas_call at :118) and _raster_sums_pallas2
// (:136, pallas_call at :185). Those contract a row one-hot (R, K) against a
// column-masked, channel-tiled value operand (size*Cp, K) on the MXU. Here
// each hand is one thread block holding its histogram in dynamic shared
// memory: the block clears it, adds every point's Cp values into its cell
// with shared-memory atomics, and writes the histogram out whole.
//
// Layout (see gpd_tpu_torch/ops/images.py, raster_sums / raster_sums2):
//   rows_a, rows_b, cols (G, K) int32   an entry whose row or column is
//                                       outside [0, size) adds nothing
//   aug  (G, K, Cp) f32                 pre-masked values, count last
//   out  (G, size, size, Cp) f32        one row set, channel-minor
//        (G, 2, size, size, Cp) f32     two row sets: [:, 0] rows_a,
//                                       [:, 1] rows_b
//
// Bound on an H100 SXM: bytes. At G = 512, K = 2048, size 60 the function
// moves 54.7 MB at Cp = 4 (29.5 MB of it the output) and 126 MB in the
// two-row-set mode at Cp = 6, so ~16 us and ~38 us at 3.35 TB/s; at most
// 4.2 M (8.4 M) f32 adds, which are negligible. This design reads each input
// once and writes each output once; whether it reaches that bound is
// measured by chip_smoke.py (PERF.md). A histogram takes size*size*Cp*4
// bytes of shared memory (57.6 KB at Cp = 4, twice that per row set), so a
// block opts in above 48 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add_point(float* cell, const float* v,
                                          int Cp) {
  for (int j = 0; j < Cp; ++j) atomicAdd(cell + j, v[j]);
}

template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
raster_sums_kernel(const int* __restrict__ rows_a,
                   const int* __restrict__ rows_b,
                   const int* __restrict__ cols,
                   const float* __restrict__ aug, float* __restrict__ out,
                   int K, int Cp, int size) {
  extern __shared__ float4 smem4[];
  float* hist = reinterpret_cast<float*>(smem4);
  const int64_t g = blockIdx.x;
  const int cells = size * size * Cp;  // floats of one histogram
  const int n = kTwo ? 2 * cells : cells;
  // Output rows are n floats apart; with n a multiple of 4 every hand's
  // histogram starts 16-byte aligned and moves as float4.
  const bool vec = (n & 3) == 0;

  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads)
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) hist[i] = 0.f;
  }
  __syncthreads();

  const unsigned usize = size;
  const int* ra = rows_a + g * K;
  const int* cc = cols + g * K;
  const float* v = aug + g * K * Cp;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    // One column test serves both row sets.
    const unsigned c = cc[k];
    if (c >= usize) continue;
    const float* vk = v + (int64_t)k * Cp;
    const unsigned r = ra[k];
    if (r < usize) add_point(hist + (r * usize + c) * Cp, vk, Cp);
    if (kTwo) {
      const unsigned rb = rows_b[g * K + k];
      if (rb < usize) add_point(hist + cells + (rb * usize + c) * Cp, vk, Cp);
    }
  }
  __syncthreads();

  if (vec) {
    float4* o = reinterpret_cast<float4*>(out + g * n);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) o[i] = smem4[i];
  } else {
    float* o = out + g * n;
    for (int i = threadIdx.x; i < n; i += kThreads) o[i] = hist[i];
  }
}

using Kernel = void (*)(const int*, const int*, const int*, const float*,
                        float*, int, int, int);

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success). rows_b
// NULL selects the one-row-set mode.
int raster_sums_launch(const void* rows_a, const void* rows_b,
                       const void* cols, const void* aug, void* out, int G,
                       int K, int Cp, int size, void* stream) {
  const bool two = rows_b != nullptr;
  const int smem = (two ? 2 : 1) * size * size * Cp * (int)sizeof(float);
  Kernel kernel = two ? raster_sums_kernel<true> : raster_sums_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (G == 0) return 0;
  kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)rows_a, (const int*)rows_b, (const int*)cols,
      (const float*)aug, (float*)out, K, Cp, size);
  return (int)cudaGetLastError();
}

const char* gpd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
