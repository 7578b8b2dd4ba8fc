// outlier_knn: every live point's mean distance to its k nearest other live
// points, the statistic of the statistical outlier filter (the port's
// outlier_knn, gpd_tpu_torch/ops/neighbors.py, behind _outlier_mask in
// ops/preprocess.py):
//
//   mean_d[q] = (1 / c) sum_{i = 1..c} sqrt(d2_(i)(q)),  c = min(k, L - 1)
//
// where d2_(0) <= d2_(1) <= ... are the squared distances from point q to
// the L unmasked points, q itself included (d2_(0) is its own 0, or a
// duplicate's), so the k + 1 smallest are kept and the smallest dropped;
// a point with fewer than k other live points averages over those it has;
// 0 where q is masked (PCL's StatisticalOutlierRemoval, cloud.cpp:166-174;
// the plain route's rule, outlier_knn_ref).
//
// It replaces no Pallas kernel: gpd_tpu's _outlier_kernel
// (gpd_tpu/ops/preprocess.py:101-146) is plain XLA. It was added because
// the plain PyTorch body, blocks of 1024 queries against the whole padded
// cloud, wrote and re-read a dense (1024, N) distance matrix about ten
// times (the distance GEMM and its elementwise terms, the pad mask, the
// radix passes of torch.topk(k + 1), the square roots and the masked
// mean): ~10 GB for a one-camera cloud of ~8.5k points at capacity 16384.
//
// Layout (see outlier_knn in gpd_tpu_torch/ops/neighbors.py):
//   points (N, 3) f32; mask (N,) bool; k + 1 = K1, 1 <= K1 <= kMaxKept
//   packed (G * 32,) float4 scratch, G = ceil(N / 32): each point's
//                 position, NaN where masked or past N (no compare admits
//                 NaN)
//   boxes  (G, 2) float4 scratch: each 32-point group's bounding box over
//                 its unmasked points (lo, hi)
//   spans  (B, 2) float4 scratch, B = ceil(G / 32): the box of each run of
//                 32 groups (1024 points)
//   out: mean_d (N,) f32
//
// Bound on an H100 SXM: operations. A pair's distance and its test against
// the list's bound are 9 f32 flops (three differences, a product, two
// fused multiply-adds counted as two each, the compare); the full sweep of
// the benchmark's first pcd cloud (~8.5k live points at capacity 16384,
// every live point a query) is ~0.65 G flops, ~0.01 ms at 67 TFLOP/s. The
// bytes are the operands, a few hundred KB. Culling leaves a small share of
// those pair tests, so the kernel runs at launch and latency cost.
// Times on the H100 are in PERF.md's kernel table (chip_smoke.py).
//
// Design:
//  - One warp per query: its sorted list of the 64 smallest squared
//    distances seen so far, two slots a lane (lane l holds slots 2l and
//    2l + 1), and the list's bound, slot K1 - 1, in every lane. ~8.5k live
//    queries give ~8.5k warps, which fill the 132 SMs; one thread a query
//    would give ~270 warps, and a register list's insertion costs each of
//    them ~K1 instructions, where the warp's costs one shuffle and a few
//    selects a lane.
//  - The distance is the direct difference |q - p|^2 in f32 (three
//    subtractions, a product, two fused multiply-adds, in that order:
//    radius_moments.cu's), nearer the float64 value than the plain route's
//    q^2 + p^2 - 2 q.p, and exactly 0 to itself.
//  - A swept group: each lane loads one point (a 16-byte read, the group
//    512 contiguous bytes) and takes its distance; the lanes whose distance
//    lies below the bound are inserted one at a time, each broadcast to the
//    warp, each insertion moving the larger slots up one place.
//  - Culling: a first kernel packs the points and writes each group's box
//    and each run of 32 groups' box. A warp visits the runs outward from
//    its own (its own run, then the next above and below, ...), skips a run
//    whose box lies at least the bound from its query, judges the run's
//    groups one a lane, and sweeps those below the bound nearest box first,
//    judging each again against the bound as it falls. The box distance
//    takes the pair's operations in the pair's order on the box's facing
//    corner, and f32 rounding is monotone, so it is never above the
//    distance of any pair it stands for; the list takes a value only below
//    its bound, which only falls. So a skipped group holds no value the
//    list would take, and the kept K1 values are the full sweep's bit for
//    bit, in whatever order the groups are visited. The voxel filter
//    leaves the cloud in lexicographic cell order, so neighbours in index
//    are near in space: the first runs set a tight bound and the rest are
//    mostly skipped whole.
//  - The mean: the K1 - 1 kept values above the smallest, in ascending
//    order, each square-rooted (__fsqrt_rn) and added in f32
//    (__fadd_rn), then divided by their count (__fdiv_rn). No atomics
//    outside the probe: an eager call and a CUDA graph replay give the
//    same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxKept = 64;  // two list slots a lane
constexpr int kWarps = 8;     // queries a block of the sweep
constexpr int kThreads = 32 * kWarps;
constexpr int kBoxThreads = 1024;  // one run of 32 groups a block
constexpr unsigned kAll = 0xffffffffu;

struct Operands {
  const float* points;
  const uint8_t* mask;
  float4* packed;
  float4* boxes;
  float4* spans;
  float* out;
  // The probe's counts (kCount), else unused: (query, group) pairs judged
  // and swept, queries whose list filled; the sum of their bounds.
  unsigned long long* counts;
  double* bound_sum;
  int N, K1;
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// |a - b|^2 in the pair's operations and order; no contraction.
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// The gap between a and [lo, hi] along one axis, as the pair's difference
// rounds it at the facing end: at most |fl(a - b)| for every b in the
// interval. An empty box (lo = +inf, hi = -inf) gives +inf.
__device__ __forceinline__ float gap(float a, float lo, float hi) {
  return fmaxf(0.f, fmaxf(__fsub_rn(lo, a), __fsub_rn(a, hi)));
}

__device__ __forceinline__ float box_dist2(const float4& q, const float4& lo,
                                           const float4& hi) {
  return dist2(gap(q.x, lo.x, hi.x), gap(q.y, lo.y, hi.y),
               gap(q.z, lo.z, hi.z));
}

// One block a run of 32 groups, one warp a group: the packed points, the
// group's box over its unmasked points, and the run's box.
__global__ void __launch_bounds__(kBoxThreads)
    outlier_knn_boxes_kernel(Operands op) {
  __shared__ float4 run[32][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = (op.N + 31) >> 5;
  const int g = blockIdx.x * 32 + warp;
  const int i = g * 32 + lane;
  const bool live = i < op.N && op.mask[i];
  float x = NAN, y = NAN, z = NAN;
  if (live) {
    x = op.points[3 * (size_t)i];
    y = op.points[3 * (size_t)i + 1];
    z = op.points[3 * (size_t)i + 2];
  }
  if (g < G) op.packed[i] = make_float4(x, y, z, 0.f);
  const float4 lo = make_float4(warp_min(live ? x : INFINITY),
                                warp_min(live ? y : INFINITY),
                                warp_min(live ? z : INFINITY), 0.f);
  const float4 hi = make_float4(warp_max(live ? x : -INFINITY),
                                warp_max(live ? y : -INFINITY),
                                warp_max(live ? z : -INFINITY), 0.f);
  if (lane == 0) {
    if (g < G) {
      op.boxes[2 * (size_t)g] = lo;
      op.boxes[2 * (size_t)g + 1] = hi;
    }
    run[warp][0] = lo;
    run[warp][1] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const float4 l = run[lane][0], h = run[lane][1];
    const float4 rl = make_float4(warp_min(l.x), warp_min(l.y),
                                  warp_min(l.z), 0.f);
    const float4 rh = make_float4(warp_max(h.x), warp_max(h.y),
                                  warp_max(h.z), 0.f);
    if (lane == 0) {
      op.spans[2 * (size_t)blockIdx.x] = rl;
      op.spans[2 * (size_t)blockIdx.x + 1] = rh;
    }
  }
}

// The warp's list: lane l holds slots 2l (a0) and 2l + 1 (a1), ascending
// over the slots. Inserts v (the same in every lane) and drops slot 63.
__device__ __forceinline__ void insert(float v, float& a0, float& a1,
                                       int lane) {
  float prev = __shfl_up_sync(kAll, a1, 1);  // slot 2l - 1
  if (lane == 0) prev = -INFINITY;
  const float n0 = prev > v ? prev : fminf(a0, v);
  const float n1 = a0 > v ? a0 : fminf(a1, v);
  a0 = n0;
  a1 = n1;
}

// Grid (ceil(N / kWarps)): warp w of block b takes query b * kWarps + w.
// The launch runs kCull and not kCount; the probe
// (outlier_knn_probe_launch) counts, and without kCull sweeps every group.
template <bool kCull, bool kCount>
__global__ void __launch_bounds__(kThreads)
    outlier_knn_kernel(Operands op) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= op.N) return;  // the whole warp
  if (!op.mask[q]) {
    if (lane == 0) op.out[q] = 0.f;
    return;
  }
  const int G = (op.N + 31) >> 5, B = (G + 31) >> 5;
  const int K1 = op.K1;
  const int bound_lane = (K1 - 1) >> 1;
  const bool bound_hi = (K1 - 1) & 1;
  const float4 qp = op.packed[q];
  float a0 = INFINITY, a1 = INFINITY;
  float bound = INFINITY;
  unsigned long long judged = 0, swept = 0;

  const int b0 = q >> 10;  // the run of the query's own group
  for (int r = 0;; ++r) {
    const int up = b0 + r, down = b0 - r;
    const bool has_up = up < B, has_down = r > 0 && down >= 0;
    if (!has_up && !has_down) break;
    for (int side = 0; side < 2; ++side) {
      const int b = side ? down : up;
      if (!(side ? has_down : has_up)) continue;
      if (kCull) {
        const float4 lo = op.spans[2 * (size_t)b];
        const float4 hi = op.spans[2 * (size_t)b + 1];
        if (!(box_dist2(qp, lo, hi) < bound)) continue;
      }
      const int g = b * 32 + lane;
      const bool in = g < G;
      float bd = INFINITY;
      if (in) {
        bd = 0.f;
        if (kCull)
          bd = box_dist2(qp, op.boxes[2 * (size_t)g],
                         op.boxes[2 * (size_t)g + 1]);
      }
      unsigned todo = __ballot_sync(kAll, in && bd < bound);
      if (kCount) judged += __popc(__ballot_sync(kAll, in));
      while (todo) {
        int j;
        if (kCull) {
          // The nearest box left, judged again against the fallen bound.
          const float m = warp_min((todo >> lane) & 1 ? bd : INFINITY);
          if (!(m < bound)) break;
          j = __ffs(__ballot_sync(kAll, ((todo >> lane) & 1) && bd == m)) -
              1;
        } else {
          j = __ffs(todo) - 1;
        }
        todo &= ~(1u << j);
        if (kCount) ++swept;
        const float4 p = op.packed[(size_t)(b * 32 + j) * 32 + lane];
        const float d2 = dist2(__fsub_rn(qp.x, p.x), __fsub_rn(qp.y, p.y),
                               __fsub_rn(qp.z, p.z));
        unsigned hit = __ballot_sync(kAll, d2 < bound);
        while (hit) {
          const int h = __ffs(hit) - 1;
          hit &= hit - 1;
          const float v = __shfl_sync(kAll, d2, h);
          if (v < bound) {
            insert(v, a0, a1, lane);
            bound = __shfl_sync(kAll, bound_hi ? a1 : a0, bound_lane);
          }
        }
      }
    }
  }

  // Slots 1..K1-1 in ascending order; the unfilled ones are +inf.
  float s = 0.f;
  int c = 0;
  for (int i = 1; i < K1; ++i) {
    const float v = __shfl_sync(kAll, (i & 1) ? a1 : a0, i >> 1);
    if (v < INFINITY) {
      s = __fadd_rn(s, __fsqrt_rn(v));
      ++c;
    }
  }
  if (lane == 0) {
    op.out[q] = __fdiv_rn(s, (float)(c > 0 ? c : 1));
    if (kCount) {
      atomicAdd(op.counts, judged);
      atomicAdd(op.counts + 1, swept);
      if (bound < INFINITY) {
        atomicAdd(op.counts + 2, 1ull);
        atomicAdd(op.bound_sum, (double)bound);
      }
    }
  }
}

// The two kernels of a launch on `st`, in order.
template <bool kCull, bool kCount>
int launch_all(const Operands& op, cudaStream_t st) {
  const int G = (op.N + 31) / 32, B = (G + 31) / 32;
  outlier_knn_boxes_kernel<<<B, kBoxThreads, 0, st>>>(op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  outlier_knn_kernel<kCull, kCount>
      <<<(op.N + kWarps - 1) / kWarps, kThreads, 0, st>>>(op);
  return (int)cudaGetLastError();
}

// Fills `op` and checks the parameters; returns cudaErrorInvalidValue for
// those the kernel cannot take.
int operands(Operands& op, const void* points, const void* mask,
             void* packed, void* boxes, void* spans, void* out, int N,
             int K1) {
  if (N < 0 || K1 < 1 || K1 > kMaxKept) return (int)cudaErrorInvalidValue;
  op.points = (const float*)points;
  op.mask = (const uint8_t*)mask;
  op.packed = (float4*)packed;
  op.boxes = (float4*)boxes;
  op.spans = (float4*)spans;
  op.out = (float*)out;
  op.counts = nullptr;
  op.bound_sum = nullptr;
  op.N = N;
  op.K1 = K1;
  return 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for parameters the kernel cannot take. With
// G = ceil(N / 32): `packed` holds G * 32 float4s, `boxes` 2 * G and
// `spans` 2 * ceil(G / 32).
int outlier_knn_launch(const void* points, const void* mask, void* packed,
                       void* boxes, void* spans, void* out, int N, int K1,
                       void* stream) {
  Operands op;
  const int bad = operands(op, points, mask, packed, boxes, spans, out, N,
                           K1);
  if (bad || N == 0) return bad;
  return launch_all<true, false>(op, (cudaStream_t)stream);
}

// The same means from the sweep compiled with counts, for tests and
// measurements: adds to `counts` (three zeroed uint64s) the (query, group)
// pairs judged (a group's box tested, or every pair without culling) and
// swept and the queries whose list filled, and to `bound_sum` (a zeroed
// double) the sum of those queries' final bounds; `cull` 0 sweeps every
// group (the means are the culled sweep's bit for bit).
int outlier_knn_probe_launch(const void* points, const void* mask,
                             void* packed, void* boxes, void* spans,
                             void* out, int N, int K1, int cull,
                             void* counts, void* bound_sum, void* stream) {
  Operands op;
  const int bad = operands(op, points, mask, packed, boxes, spans, out, N,
                           K1);
  if (bad || N == 0) return bad;
  op.counts = (unsigned long long*)counts;
  op.bound_sum = (double*)bound_sum;
  const cudaStream_t st = (cudaStream_t)stream;
  return cull ? launch_all<true, true>(op, st)
              : launch_all<false, true>(op, st);
}

const char* gpd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
