// raster_blocks: every per-cell sum of the 12/15-channel grasp images of a
// batch of hands, in one launch.
//
// Replaces gpd_tpu's Pallas TPU kernel _raster_blocks_pallas
// (gpd_tpu/ops/images.py:204, pallas_call at :319). That kernel builds row
// and column one-hots of each hand's points and contracts
// (row one-hot x value) against the column one-hot on the MXU. Here each
// block is a shared-memory histogram instead: one thread block per
// (hand, projection group) clears its 64x64 float planes, adds every point
// of the hand into its cell with shared-memory atomics, and writes the
// planes out whole.
//
// Layout (see gpd_tpu_torch/ops/images.py, raster_blocks):
//   midx  (G, 4, Km) int32   [rows_u, rows_w, cols_v, cols_u], sentinel size
//   mvals (G, 6, Km) bf16    [|n|x, |n|y, |n|z, u, v, w], pre-masked
//   sidx  (G, 4, Ks) int32   shadow points, same index rows
//   svals (G, 3, Ks) bf16    [u, v, w]
//   out   (G, NB, R, R) f32  NB = 15 (+6 shadow planes), R = size+1 up to 8
// Group g < 3 is projection P_g with planes [ax, ay, az, depth, count] at
// 5g; group 3 + s is shadow projection s with planes [depth, count] at
// 15 + 2s. Rows and columns >= size stay exactly zero.
//
// Bound on an H100 SXM: the function moves ~229 MB per 512-hand chunk at
// Km = Ks = 2048 with shadows, 176 MB of it the f32 output, so the least
// time is ~68 us at 3.35 TB/s. The f32 additions are negligible: 15 for
// each point and 6 for each shadow point that falls in the image, 13.2 M
// when 60% of them do, 22 M at most. This simple design does nothing about
// the output traffic yet: it writes all planes, zero tails included. A tensor-core one-hot contraction (wgmma)
// with TMA loads, or fusing the mean/dilate/minmax epilogue so the planes
// never reach device memory, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMainPlanes = 5;

// Index row of the image rows and of the image columns per projection,
// and the value row holding each projection's depth.
__constant__ int kRowSel[3] = {0, 1, 1};
__constant__ int kColSel[3] = {2, 2, 3};
__constant__ int kMainDepth[3] = {5, 3, 4};    // mvals rows w, u, v
__constant__ int kShadowDepth[3] = {2, 0, 1};  // svals rows w, u, v

__global__ void __launch_bounds__(kThreads)
raster_blocks_kernel(const int* __restrict__ midx,
                     const __nv_bfloat16* __restrict__ mvals,
                     const int* __restrict__ sidx,
                     const __nv_bfloat16* __restrict__ svals,
                     float* __restrict__ out, int Km, int Ks, int size, int R,
                     int NB) {
  extern __shared__ float4 smem4[];
  float* hist = reinterpret_cast<float*>(smem4);
  const int64_t g = blockIdx.x;
  const bool shadow = blockIdx.y >= 3;
  const int p = shadow ? blockIdx.y - 3 : blockIdx.y;
  const int planes = shadow ? 2 : kMainPlanes;
  const int plane = R * R;

  for (int i = threadIdx.x; i < planes * plane / 4; i += kThreads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  if (!shadow) {
    const int* idx = midx + g * 4 * Km;
    const int* rows = idx + kRowSel[p] * Km;
    const int* cols = idx + kColSel[p] * Km;
    const __nv_bfloat16* v = mvals + g * 6 * Km;
    const __nv_bfloat16* depth = v + kMainDepth[p] * Km;
    for (int k = threadIdx.x; k < Km; k += kThreads) {
      const int r = rows[k], c = cols[k];
      if ((unsigned)r < (unsigned)size && (unsigned)c < (unsigned)size) {
        float* cell = hist + r * R + c;
        atomicAdd(cell, __bfloat162float(v[k]));
        atomicAdd(cell + plane, __bfloat162float(v[Km + k]));
        atomicAdd(cell + 2 * plane, __bfloat162float(v[2 * Km + k]));
        atomicAdd(cell + 3 * plane, __bfloat162float(depth[k]));
        atomicAdd(cell + 4 * plane, 1.f);
      }
    }
  } else {
    const int* idx = sidx + g * 4 * Ks;
    const int* rows = idx + kRowSel[p] * Ks;
    const int* cols = idx + kColSel[p] * Ks;
    const __nv_bfloat16* depth = svals + g * 3 * Ks + kShadowDepth[p] * Ks;
    for (int k = threadIdx.x; k < Ks; k += kThreads) {
      const int r = rows[k], c = cols[k];
      if ((unsigned)r < (unsigned)size && (unsigned)c < (unsigned)size) {
        float* cell = hist + r * R + c;
        atomicAdd(cell, __bfloat162float(depth[k]));
        atomicAdd(cell + plane, 1.f);
      }
    }
  }
  __syncthreads();

  // The group's planes are contiguous in the output; R is a multiple of 8,
  // so every plane starts 16-byte aligned.
  const int first = shadow ? 15 + 2 * p : kMainPlanes * p;
  float4* o = reinterpret_cast<float4*>(out + (g * NB + first) * plane);
  for (int i = threadIdx.x; i < planes * plane / 4; i += kThreads)
    o[i] = smem4[i];
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success). Shadow
// pointers are ignored when with_shadow is 0.
int raster_blocks_launch(const void* midx, const void* mvals, const void* sidx,
                         const void* svals, void* out, int G, int Km, int Ks,
                         int size, int with_shadow, void* stream) {
  const int R = ((size + 1 + 7) / 8) * 8;
  const int NB = with_shadow ? 21 : 15;
  const int smem = kMainPlanes * R * R * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      raster_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (G == 0) return 0;
  dim3 grid(G, with_shadow ? 6 : 3);
  raster_blocks_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)midx, (const __nv_bfloat16*)mvals, (const int*)sidx,
      (const __nv_bfloat16*)svals, (float*)out, Km, Ks, size, R, NB);
  return (int)cudaGetLastError();
}

const char* gpd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
