// raster_sums: per-cell sums of one image projection for a batch of hands
// (the 1- and 3-channel grasp images), and a two-row-set mode that builds
// two histograms against one column index and one value set.
//
// Replaces gpd_tpu's Pallas TPU kernels _raster_sums_pallas
// (gpd_tpu/ops/images.py:53, pallas_call at :118) and _raster_sums_pallas2
// (:136, pallas_call at :185). Those contract a row one-hot (R, K) against a
// column-masked, channel-tiled value operand (size*Cp, K) on the MXU. Here
// each hand's histogram lives in dynamic shared memory and every point's Cp
// values are added into their cell with shared-memory atomics.
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
// moves 54.7 MB at Cp = 4 (29.5 MB of it the output), and in the two-row-set
// mode 126.2 MB at Cp = 6 (88.5 MB output) and 69.4 MB at Cp = 3, so ~16,
// ~38 and ~21 us at 3.35 TB/s; at most 4.2 M f32 adds at Cp = 4 and
// 12.6 M with two row sets at Cp = 6, which are negligible at 67 TFLOP/s.
//
// Design, for Cp <= 8 in both modes: the persistent design of
// raster_blocks.cu. A work item is one hand against one row set; with two
// row sets hand g's items are 2g and 2g + 1, and item i writes the i-th
// histogram of the output, contiguous. What held the first version (one
// block per hand, clear -> add -> store in series) at 3.3x the bound with
// one row set and 4.7x with two was that few blocks fit an SM (one at Cp = 6
// with two sets: 172.8 KB of shared memory), so the hands ran in waves with
// an idle tail, and nothing overlapped a block's store with its loads. Now:
//  - one 512-thread block per SM walks a contiguous run of items in
//    hand-major order, one item's histogram at a time (60 x 60 x Cp floats:
//    57.6 KB at Cp = 4, 86.4 KB at Cp = 6), so a hand's second item re-reads
//    its columns and values from L2 on the same SM. Splitting a hand into
//    row bands, each its own item, re-read the hand's points per band and
//    measured slower (PERF.md);
//  - two histogram buffers: one thread hands a finished item to the copy
//    engine as one cp.async.bulk store (bulk_store.cuh) while the block
//    clears the other buffer and sums the next item. The wrapper admits two
//    row sets only where one hand's pair of histograms fits a block, so in
//    that mode two item buffers always fit;
//  - a thread takes 4 points at a time, one 16-byte load for their rows,
//    one for their columns and Cp for their 4*Cp values, and loads its next
//    4 (in this item or the next) before it adds the current ones. K not a
//    multiple of 4, or a misaligned operand, takes the same walk one point
//    at a time;
//  - a shared-memory f32 atomicAdd compiles to a compare-and-swap loop
//    (LDS, FADD, ATOMS.CAST.SPIN), one per channel, so a cell takes the
//    widest compare-and-swap loops its alignment allows (add_cell).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py, in turns
// against the earlier sources and against variants of these; PERF.md), at
// 512 hands: one row set 0.0238 ms at Cp = 4 and 0.0130 ms at Cp = 2; two
// row sets 0.0689 ms (1.83x the bound) at Cp = 6 and 0.0309 ms (1.49x) at
// Cp = 3, from 0.1773 and 0.0619 ms with the first design. At Cp = 6,
// 128 + 64-bit loops (2 a point) beat three 64-bit loops (0.0800 ms) and
// six atomicAdds (0.0760 ms). With every row on the sentinel, so that
// no point adds anything, the two-row-set mode still takes 0.0530 ms at
// Cp = 6 (1.41x) and 0.0283 ms at Cp = 3: loads, clears and stores set that
// floor, and the additions take the rest. Cp > 8 keeps the first design.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_store.cuh"

namespace {

constexpr int kThreads = 256;           // first design
constexpr int kPersistentThreads = 512;
constexpr int kMaxSmem = 232448;

// ---- First design: one block per hand, for Cp > 8. ----

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

// ---- Persistent design: Cp <= 8, one or two row sets. ----

struct Operands {
  const int* rows_a;
  const int* rows_b;  // the second row set, or nullptr
  const int* cols;
  const float* aug;
  float* out;
  bool two_sets;  // item i is hand i >> 1 against row set i & 1, else hand i
  int items;      // G, or 2G with two row sets
  int K, size;
  bool vec;       // 4-point loads are aligned
  bool use_bulk;  // an item's output is a multiple of 16 bytes
};

// One work item: a hand against one row set, and its histogram's place in
// the output.
struct Item {
  const int* rows;
  const int* cols;
  const float* aug;
  float* out;
};

template <int CP>
__device__ __forceinline__ Item item_at(const Operands& op, int i) {
  const int64_t g = op.two_sets ? i >> 1 : i;
  Item it;
  it.rows = (op.two_sets && (i & 1) ? op.rows_b : op.rows_a) + g * op.K;
  it.cols = op.cols + g * op.K;
  it.aug = op.aug + g * op.K * CP;
  // Item i writes the i-th histogram of the output: hand g's, or with two
  // row sets hand g's set s at 2g + s.
  it.out = op.out + static_cast<int64_t>(i) * op.size * op.size * CP;
  return it;
}

// Up to 4 points: rows, columns and their 4*CP values, point-major.
template <int CP>
struct Unit {
  int4 r, c;
  float4 a[CP];
};

__device__ __forceinline__ int lane(const int4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ float lane(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ void set_lane(float4& a, int i, float v) {
  if (i == 0) a.x = v;
  else if (i == 1) a.y = v;
  else if (i == 2) a.z = v;
  else a.w = v;
}

template <int CP>
__device__ __forceinline__ void load(Unit<CP>& u, const Item& it, bool vec,
                                     int k) {
  if (vec) {
    u.r = __ldg(reinterpret_cast<const int4*>(it.rows) + k);
    u.c = __ldg(reinterpret_cast<const int4*>(it.cols) + k);
    // Points 4k..4k+3 hold 4*CP floats from float 4k*CP: 16-byte aligned.
    const float4* a = reinterpret_cast<const float4*>(it.aug) + k * CP;
#pragma unroll
    for (int q = 0; q < CP; ++q) u.a[q] = __ldg(a + q);
  } else {
    u.r.x = __ldg(it.rows + k);
    u.c.x = __ldg(it.cols + k);
    const float* a = it.aug + static_cast<int64_t>(k) * CP;
#pragma unroll
    for (int q = 0; q < CP; ++q) set_lane(u.a[q / 4], q % 4, __ldg(a + q));
  }
}

__device__ __forceinline__ uint64_t pack2(float a, float b) {
  return static_cast<uint64_t>(__float_as_uint(a)) |
         static_cast<uint64_t>(__float_as_uint(b)) << 32;
}

__device__ __forceinline__ float lo(uint64_t x) {
  return __uint_as_float(static_cast<uint32_t>(x));
}

__device__ __forceinline__ float hi(uint64_t x) {
  return __uint_as_float(static_cast<uint32_t>(x >> 32));
}

// cell[0..1] += (a, b) with one 64-bit compare-and-swap loop.
__device__ __forceinline__ void add2(float* cell, float a, float b) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(cell);
  unsigned long long want = *p;
  while (true) {
    const unsigned long long seen =
        atomicCAS(p, want, pack2(lo(want) + a, hi(want) + b));
    if (seen == want) break;
    want = seen;
  }
}

// cell[0..3] += v with one 128-bit compare-and-swap loop (sm_90).
__device__ __forceinline__ void add4(float* cell, float4 v) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(cell));
  const float4 first = *reinterpret_cast<const float4*>(cell);
  uint64_t want_lo = pack2(first.x, first.y), want_hi = pack2(first.z, first.w);
  while (true) {
    const uint64_t new_lo = pack2(lo(want_lo) + v.x, hi(want_lo) + v.y);
    const uint64_t new_hi = pack2(lo(want_hi) + v.z, hi(want_hi) + v.w);
    uint64_t seen_lo, seen_hi;
    asm volatile(
        "{\n\t.reg .b128 d, b, c;\n\t"
        "mov.b128 b, {%2, %3};\n\t"
        "mov.b128 c, {%4, %5};\n\t"
        "atom.shared.cas.b128 d, [%6], b, c;\n\t"
        "mov.b128 {%0, %1}, d;\n\t}"
        : "=l"(seen_lo), "=l"(seen_hi)
        : "l"(want_lo), "l"(want_hi), "l"(new_lo), "l"(new_hi), "r"(s)
        : "memory");
    if (seen_lo == want_lo && seen_hi == want_hi) break;
    want_lo = seen_lo;
    want_hi = seen_hi;
  }
}

// Adds one point's CP values into its cell (cell index `at`) with the
// fewest compare-and-swap loops the cell's alignment allows. CP a multiple
// of 4: the cell is 16-byte aligned, one 128-bit loop per 4 channels. CP =
// 4m + 2: the cell is 8-byte aligned, and 16-byte aligned where `at` is
// even; then the 4m channels from the start take 128-bit loops and the last
// 2 one 64-bit loop, else the first 2 and then the rest (CP = 6: 2 loops a
// point, where 64-bit pairs take 3 and per-channel atomicAdd 6). Odd CP:
// one f32 atomicAdd each.
template <int CP>
__device__ __forceinline__ void add_cell(float* cell, const float (&v)[CP],
                                         int at) {
  if constexpr (CP % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CP; q += 4)
      add4(cell + q, make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
  } else if constexpr (CP % 2 == 0) {
    // 128-bit runs from channel 0 and the pair last (even cell), or the
    // pair first and the runs from channel 2 (odd cell).
    const bool odd = at & 1;
#pragma unroll
    for (int q = 0; q + 2 < CP; q += 4)
      add4(cell + (odd ? q + 2 : q),
           make_float4(odd ? v[q + 2] : v[q], odd ? v[q + 3] : v[q + 1],
                       odd ? v[q + 4] : v[q + 2], odd ? v[q + 5] : v[q + 3]));
    add2(cell + (odd ? 0 : CP - 2), odd ? v[0] : v[CP - 2],
         odd ? v[1] : v[CP - 1]);
  } else {
#pragma unroll
    for (int j = 0; j < CP; ++j) atomicAdd(cell + j, v[j]);
  }
}

// Adds up to N points of a unit into the histogram.
template <int CP, int N>
__device__ __forceinline__ void add_points(float* hist, const Unit<CP>& u,
                                           int size) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = lane(u.r, i), c = lane(u.c, i);
    if ((unsigned)c < (unsigned)size && (unsigned)r < (unsigned)size) {
      const int at = r * size + c;
      float v[CP];
#pragma unroll
      for (int j = 0; j < CP; ++j)
        v[j] = lane(u.a[(i * CP + j) / 4], (i * CP + j) % 4);
      add_cell<CP>(hist + at * CP, v, at);
    }
  }
}

template <int CP>
__global__ void __launch_bounds__(kPersistentThreads)
raster_sums_persistent(const Operands op, bool two_buffers) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int floats = op.size * op.size * CP;  // one item's histogram
  const int slot = (floats + 3) / 4 * 4;
  const int first = static_cast<int>(
      static_cast<int64_t>(op.items) * blockIdx.x / gridDim.x);
  const int n = static_cast<int>(
      static_cast<int64_t>(op.items) * (blockIdx.x + 1) / gridDim.x) - first;
  if (n <= 0) return;
  const int units = op.vec ? op.K / 4 : op.K;

  // The walk over (item j, unit u): cur is loaded one step ahead of its
  // additions. Every item has the same number of units.
  int cj = units > static_cast<int>(threadIdx.x) ? 0 : n;
  int cu = threadIdx.x;
  Unit<CP> cur, nxt;
  if (cj < n) load(cur, item_at<CP>(op, first), op.vec, cu);

  bulk::clear(smem, slot / 4);
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    float* hist = smem + (two_buffers ? (j & 1) * slot : 0);
    const Item it = item_at<CP>(op, first + j);
    while (cj == j) {
      int nj = cj, nu = cu + kPersistentThreads;
      if (nu >= units) {
        nu = threadIdx.x;
        ++nj;
      }
      if (nj < n)
        load(nxt, nj == j ? it : item_at<CP>(op, first + nj), op.vec, nu);
      if (op.vec)
        add_points<CP, 4>(hist, cur, op.size);
      else
        add_points<CP, 1>(hist, cur, op.size);
      cur = nxt;
      cj = nj;
      cu = nu;
    }
    const bool more = j + 1 < n;
    float* next = !more ? nullptr
                  : two_buffers ? smem + ((j + 1) & 1) * slot : hist;
    bulk::finish_item(hist, it.out, floats, op.use_bulk, two_buffers, next,
                      more ? slot / 4 : 0);
  }
  if (threadIdx.x == 0) bulk::wait_read_all();
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

template <int CP>
int launch_persistent(const void* rows_a, const void* rows_b, const void* cols,
                      const void* aug, void* out, int G, int K, int size,
                      int num_sms, cudaStream_t stream) {
  Operands op;
  op.rows_a = (const int*)rows_a;
  op.rows_b = (const int*)rows_b;
  op.cols = (const int*)cols;
  op.aug = (const float*)aug;
  op.out = (float*)out;
  op.two_sets = rows_b != nullptr;
  op.items = op.two_sets ? 2 * G : G;
  op.K = K;
  op.size = size;
  op.vec = K % 4 == 0 && aligned(rows_a, 16) && aligned(rows_b, 16) &&
           aligned(cols, 16) && aligned(aug, 16);
  op.use_bulk = (size * CP) % 4 == 0 && aligned(out, 16);
  const int slot_bytes = (size * size * CP + 3) / 4 * 4 * (int)sizeof(float);
  const bool two = 2 * slot_bytes <= kMaxSmem;
  const int smem = (two ? 2 : 1) * slot_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      raster_sums_persistent<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (G == 0) return 0;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, raster_sums_persistent<CP>, kPersistentThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = op.items < num_sms * per_sm ? op.items : num_sms * per_sm;
  raster_sums_persistent<CP>
      <<<grid, kPersistentThreads, smem, stream>>>(op, two);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 on success). rows_b NULL
// selects the one-row-set mode. For Cp <= 8 either mode runs the persistent
// kernel over a grid sized by num_sms, the card's SM count.
int raster_sums_launch(const void* rows_a, const void* rows_b,
                       const void* cols, const void* aug, void* out, int G,
                       int K, int Cp, int size, int num_sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (Cp) {
    case 1: return launch_persistent<1>(rows_a, rows_b, cols, aug, out, G, K, size, num_sms, s);
    case 2: return launch_persistent<2>(rows_a, rows_b, cols, aug, out, G, K, size, num_sms, s);
    case 3: return launch_persistent<3>(rows_a, rows_b, cols, aug, out, G, K, size, num_sms, s);
    case 4: return launch_persistent<4>(rows_a, rows_b, cols, aug, out, G, K, size, num_sms, s);
    case 5: return launch_persistent<5>(rows_a, rows_b, cols, aug, out, G, K, size, num_sms, s);
    case 6: return launch_persistent<6>(rows_a, rows_b, cols, aug, out, G, K, size, num_sms, s);
    case 7: return launch_persistent<7>(rows_a, rows_b, cols, aug, out, G, K, size, num_sms, s);
    case 8: return launch_persistent<8>(rows_a, rows_b, cols, aug, out, G, K, size, num_sms, s);
    default: break;
  }
  const bool two = rows_b != nullptr;
  const int smem = (two ? 2 : 1) * size * size * Cp * (int)sizeof(float);
  Kernel kernel = two ? raster_sums_kernel<true> : raster_sums_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (G == 0) return 0;
  kernel<<<G, kThreads, smem, s>>>(
      (const int*)rows_a, (const int*)rows_b, (const int*)cols,
      (const float*)aug, (float*)out, K, Cp, size);
  return (int)cudaGetLastError();
}

const char* gpd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
