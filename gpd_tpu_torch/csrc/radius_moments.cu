// radius_moments: per-query sums of per-point features over every point
// within a radius, and the count of those points (the port's
// radius_moments, gpd_tpu_torch/ops/neighbors.py): the moments behind the
// surface normals (ops/normals.py) and the local frames (ops/frames.py).
//
//   sums[q]   = sum_p [|query[q] - points[p]|^2 <= r2] feats[p]
//   counts[q] = sum_p [|query[q] - points[p]|^2 <= r2]
//
// over unmasked points p, both 0 where query q is masked; every in-radius
// point counts, with no cap and no sort (the reference's kd-tree radius
// search, frame_estimator.cpp:74 / cloud.cpp:497-535).
//
// It replaces no Pallas kernel: gpd_tpu's radius_moments
// (gpd_tpu/ops/neighbors.py:176) is plain XLA. It was added because the
// plain PyTorch body, blocks of 1024 queries against the whole cloud, wrote
// and re-read a dense (1024, N) matrix in about ten passes (the distance
// GEMM and its elementwise terms, the compare, the masks, the cast, the
// product with the features and the row sums), ~50 bytes a point pair:
// 5-10 GB for each cloud of 10-14k points at the table cell's capacity.
//
// Layout (see radius_moments in gpd_tpu_torch/ops/neighbors.py):
//   query (Q, 3) f32; qmask (Q,) bool; points (N, 3) f32; pmask (N,) bool;
//   feats (N, F) f32, 1 <= F <= 12; r2 the squared radius in f32
//   boxes (G, 2) float4 scratch, G = ceil(N / 32): each 32-point group's
//                 bounding box over its unmasked points (lo, hi)
//   part  (P, F + 1, Q) f32 scratch: the sums of point partition p, the
//                 count last
//   out: sums (Q, F) f32, counts (Q,) f32
//
// Bound on an H100 SXM: operations. A pair's membership test is 9 f32
// flops (three differences, a product, two fused multiply-adds counted
// as two each, the compare) and an in-radius pair adds F + 1 more; the
// full sweep of the benchmark's first table cloud (capacity 14336, the
// normals: every live point a query) is 1.60 G flops, 0.024 ms at 67
// TFLOP/s. The bytes are the operands, a few hundred KB. Culling leaves
// about an eighth of the pair tests there, so the work the kernel does
// is bound far lower and the kernel runs at launch and latency cost.
// Times on the H100 are in PERF.md's kernel table (chip_smoke.py).
//
// Design:
//  - One thread per query, its xyz and F + 1 accumulators in registers.
//    The distance is the direct difference |q - p|^2 in f32 (three
//    subtractions, a product, two fused multiply-adds, in that order),
//    nearer the float64 value than the plain route's q^2 + p^2 - 2 q.p.
//  - A warp sweeps the points in groups of 32: each lane loads one point
//    (a masked point's position becomes NaN, which no compare admits) and
//    its features into the warp's shared memory, then every lane tests all
//    32 against its query. The position is one 16-byte broadcast read; the
//    features are read only when the pair is in radius (a few percent of
//    pairs), also as broadcasts. Nothing of size (Q, N) exists anywhere.
//  - Culling: a first kernel writes each group's box; a warp skips a group
//    whose box lies farther than the radius from the box of its 32 queries.
//    The box distance takes the pair's operations in the pair's order on
//    the boxes' facing corners, and f32 rounding is monotone, so it is
//    never above the distance of any pair it stands for: a skipped group
//    holds no in-radius pair, and the sums are the full sweep's bit for
//    bit. The voxel filter leaves the cloud in lexicographic cell order, so
//    groups and query warps are compact and most groups are skipped.
//  - The points are split into P partitions of interleaved groups (group g
//    to partition g mod P), one grid row each, so that every shape fills
//    the 132 SMs: the wrapper picks P from (Q, N), ~32 warps an SM (of 4
//    to 64 warps an SM, 32 was fastest at Q = N; the frames' shapes did
//    not move). Interleaving spreads a query warp's near groups over the
//    partitions. Each partition's sums go to `part`; a last kernel adds
//    them in the order p = 0..P-1, so results are bit-identical from
//    launch to launch and between an eager call and a graph replay. No
//    float atomics.
//  - A warp loads its next near group into registers while it sweeps the
//    current one, which hides most of the load's latency where a warp has
//    few groups to sweep (the frames' 1000 or 50 samples).
//  - Order of the sums: within a partition, the in-radius points in
//    ascending index; then the partitions in order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxF = 12;  // features a point; three 16-byte reads
constexpr int kBoxThreads = 256;
constexpr int kSumThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

struct Operands {
  const float* query;
  const uint8_t* qmask;
  const float* points;
  const uint8_t* pmask;
  const float* feats;
  float4* boxes;
  float* part;
  float* sums;
  float* counts;
  unsigned long long* groups;  // the probe's counts (kCount), else unused
  int Q, N, F, P;
  float r2;
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

// The gap between [alo, ahi] and [blo, bhi] along one axis, as the pair's
// difference rounds it at the facing ends: at most |fl(a - b)| for every a
// in the first interval and b in the second. Empty boxes (lo = +inf,
// hi = -inf) give +inf.
__device__ __forceinline__ float gap(float alo, float ahi, float blo,
                                     float bhi) {
  return fmaxf(0.f, fmaxf(__fsub_rn(alo, bhi), __fsub_rn(blo, ahi)));
}

// One warp a group: the box of its unmasked points.
__global__ void __launch_bounds__(kBoxThreads)
    radius_moments_boxes_kernel(Operands op) {
  const int t = blockIdx.x * kBoxThreads + threadIdx.x;
  const int g = t >> 5, lane = t & 31;
  const int G = (op.N + 31) >> 5;
  if (g >= G) return;  // whole warps: G * 32 threads cover every group
  const int i = t;
  const bool live = i < op.N && op.pmask[i];
  float x = 0.f, y = 0.f, z = 0.f;
  if (live) {
    x = op.points[3 * (size_t)i];
    y = op.points[3 * (size_t)i + 1];
    z = op.points[3 * (size_t)i + 2];
  }
  const float lx = warp_min(live ? x : INFINITY);
  const float ly = warp_min(live ? y : INFINITY);
  const float lz = warp_min(live ? z : INFINITY);
  const float hx = warp_max(live ? x : -INFINITY);
  const float hy = warp_max(live ? y : -INFINITY);
  const float hz = warp_max(live ? z : -INFINITY);
  if (lane == 0) {
    op.boxes[2 * (size_t)g] = make_float4(lx, ly, lz, 0.f);
    op.boxes[2 * (size_t)g + 1] = make_float4(hx, hy, hz, 0.f);
  }
}

// Takes the lowest near group of `todo` (bit j: group base + j * P) off
// it and loads this lane's point of that group: its position (NaN where
// masked or past N, which no compare admits) and its features (0 past F).
__device__ __forceinline__ void load_point(const Operands& op, int base,
                                           int P, unsigned& todo, int lane,
                                           float4& pt, float* v) {
  const int j = __ffs(todo) - 1;
  todo &= todo - 1;
  const int i = (base + j * P) * 32 + lane;
  pt = make_float4(NAN, NAN, NAN, 0.f);
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) v[f] = 0.f;
  if (i < op.N) {
    // The mask, position and features load together: one round trip.
    const bool live = op.pmask[i];
    const float x = op.points[3 * (size_t)i];
    const float y = op.points[3 * (size_t)i + 1];
    const float z = op.points[3 * (size_t)i + 2];
    const float* src = op.feats + (size_t)i * op.F;
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f < op.F) v[f] = src[f];
    if (live) pt = make_float4(x, y, z, 0.f);
  }
}

// Grid (ceil(Q / kThreads), P): block (b, p) sums partition p's points for
// queries [b * kThreads, (b + 1) * kThreads). The launch runs kCull and
// not kCount; the probe (radius_moments_probe_launch) counts, in
// groups[0] and groups[1], the (query warp, point group) pairs that warps
// with a live query judge and sweep, with or without culling.
template <bool kCull, bool kCount>
__global__ void __launch_bounds__(kThreads)
    radius_moments_kernel(Operands op) {
  __shared__ float4 spos[kWarps][32];
  __shared__ float4 sfeat[kWarps][32][kMaxF / 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int p = blockIdx.y, P = op.P;
  const int G = (op.N + 31) >> 5;
  const bool live = q < op.Q && op.qmask[q];
  float qx = NAN, qy = NAN, qz = NAN;
  if (live) {
    qx = op.query[3 * (size_t)q];
    qy = op.query[3 * (size_t)q + 1];
    qz = op.query[3 * (size_t)q + 2];
  }
  float acc[kMaxF];
#pragma unroll
  for (int f = 0; f < kMaxF; ++f) acc[f] = 0.f;
  float cnt = 0.f;

  if (__any_sync(kAll, live)) {
    // The box of the warp's live queries.
    const float lx = warp_min(live ? qx : INFINITY);
    const float ly = warp_min(live ? qy : INFINITY);
    const float lz = warp_min(live ? qz : INFINITY);
    const float hx = warp_max(live ? qx : -INFINITY);
    const float hy = warp_max(live ? qy : -INFINITY);
    const float hz = warp_max(live ? qz : -INFINITY);
    float4* pos = spos[warp];
    float4(*feat)[kMaxF / 4] = sfeat[warp];
    // Lane l judges group base + l * P; the warp then sweeps the near ones
    // in ascending order.
    for (int base = p; base < G; base += 32 * P) {
      const int g = base + lane * P;
      bool near = g < G;
      if (kCull && near) {
        const float4 lo = op.boxes[2 * (size_t)g];
        const float4 hi = op.boxes[2 * (size_t)g + 1];
        near = dist2(gap(lx, hx, lo.x, hi.x), gap(ly, hy, lo.y, hi.y),
                     gap(lz, hz, lo.z, hi.z)) <= op.r2;
      }
      unsigned todo = __ballot_sync(kAll, near);
      if (kCount) {
        const unsigned judged = __ballot_sync(kAll, g < G);
        if (lane == 0) {
          atomicAdd(op.groups, (unsigned long long)__popc(judged));
          atomicAdd(op.groups + 1, (unsigned long long)__popc(todo));
        }
      }
      if (!todo) continue;
      // The next near group's point and features are loaded into
      // registers while the warp sweeps the current one in shared memory.
      float4 pt;
      float v[kMaxF];
      load_point(op, base, P, todo, lane, pt, v);
      for (;;) {
        __syncwarp();  // every lane is done with the previous group
        pos[lane] = pt;
#pragma unroll
        for (int c = 0; c < kMaxF / 4; ++c)
          feat[lane][c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2],
                                      v[4 * c + 3]);
        __syncwarp();
        const bool more = todo != 0;
        if (more) load_point(op, base, P, todo, lane, pt, v);
#pragma unroll 4
        for (int k = 0; k < 32; ++k) {
          const float4 pp = pos[k];
          const float d2 = dist2(__fsub_rn(qx, pp.x), __fsub_rn(qy, pp.y),
                                 __fsub_rn(qz, pp.z));
          if (d2 <= op.r2) {
            cnt = __fadd_rn(cnt, 1.f);
#pragma unroll
            for (int c = 0; c < kMaxF / 4; ++c) {
              const float4 w = feat[k][c];
              acc[4 * c] = __fadd_rn(acc[4 * c], w.x);
              acc[4 * c + 1] = __fadd_rn(acc[4 * c + 1], w.y);
              acc[4 * c + 2] = __fadd_rn(acc[4 * c + 2], w.z);
              acc[4 * c + 3] = __fadd_rn(acc[4 * c + 3], w.w);
            }
          }
        }
        if (!more) break;
      }
    }
  }
  if (q < op.Q) {
    float* out = op.part + (size_t)p * (op.F + 1) * op.Q + q;
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f < op.F) out[(size_t)f * op.Q] = acc[f];
    out[(size_t)op.F * op.Q] = cnt;
  }
}

// One thread per (feature, query), the count as feature F: the
// partitions' sums in the order p = 0..P-1.
__global__ void __launch_bounds__(kSumThreads)
    radius_moments_sum_kernel(Operands op) {
  const size_t t = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (t >= (size_t)(op.F + 1) * op.Q) return;
  const int f = (int)(t / op.Q), q = (int)(t % op.Q);
  const size_t stride = (size_t)(op.F + 1) * op.Q;
  const float* src = op.part + t;
  float s = src[0];
#pragma unroll 8
  for (int p = 1; p < op.P; ++p) s = __fadd_rn(s, src[p * stride]);
  if (f < op.F)
    op.sums[(size_t)q * op.F + f] = s;
  else
    op.counts[q] = s;
}

// The three kernels of a launch on `st`, in order.
template <bool kCull, bool kCount>
int launch_all(const Operands& op, cudaStream_t st) {
  const int G = (op.N + 31) / 32;
  if (G > 0) {
    radius_moments_boxes_kernel<<<(G * 32 + kBoxThreads - 1) / kBoxThreads,
                                  kBoxThreads, 0, st>>>(op);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  radius_moments_kernel<kCull, kCount>
      <<<dim3((op.Q + kThreads - 1) / kThreads, op.P), kThreads, 0, st>>>(op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)(op.F + 1) * op.Q;
  radius_moments_sum_kernel<<<(unsigned)((items + kSumThreads - 1) /
                                         kSumThreads),
                              kSumThreads, 0, st>>>(op);
  return (int)cudaGetLastError();
}

// Fills `op` and checks the parameters; returns cudaErrorInvalidValue for
// those the kernel cannot take.
int operands(Operands& op, const void* query, const void* qmask,
             const void* points, const void* pmask, const void* feats,
             void* boxes, void* part, void* sums, void* counts, int Q, int N,
             int F, int P, float r2) {
  if (Q < 0 || N < 0 || F < 1 || F > kMaxF || P < 1 || P > 65535)
    return (int)cudaErrorInvalidValue;
  op.query = (const float*)query;
  op.qmask = (const uint8_t*)qmask;
  op.points = (const float*)points;
  op.pmask = (const uint8_t*)pmask;
  op.feats = (const float*)feats;
  op.boxes = (float4*)boxes;
  op.part = (float*)part;
  op.sums = (float*)sums;
  op.counts = (float*)counts;
  op.groups = nullptr;
  op.Q = Q;
  op.N = N;
  op.F = F;
  op.P = P;
  op.r2 = r2;
  return 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for parameters the kernel cannot take. `boxes`
// holds 2 * ceil(N / 32) float4s, `part` P * (F + 1) * Q floats.
int radius_moments_launch(const void* query, const void* qmask,
                          const void* points, const void* pmask,
                          const void* feats, void* boxes, void* part,
                          void* sums, void* counts, int Q, int N, int F,
                          int P, float r2, void* stream) {
  Operands op;
  const int bad = operands(op, query, qmask, points, pmask, feats, boxes,
                           part, sums, counts, Q, N, F, P, r2);
  if (bad || Q == 0) return bad;
  return launch_all<true, false>(op, (cudaStream_t)stream);
}

// The same sums from the sweep compiled with counts, for tests and
// measurements: adds to `groups` (two zeroed uint64s) the (query warp,
// point group) pairs judged and swept; `cull` 0 sweeps every group (the
// sums are the culled sweep's bit for bit).
int radius_moments_probe_launch(const void* query, const void* qmask,
                                const void* points, const void* pmask,
                                const void* feats, void* boxes, void* part,
                                void* sums, void* counts, int Q, int N, int F,
                                int P, float r2, int cull, void* groups,
                                void* stream) {
  Operands op;
  const int bad = operands(op, query, qmask, points, pmask, feats, boxes,
                           part, sums, counts, Q, N, F, P, r2);
  if (bad || Q == 0) return bad;
  op.groups = (unsigned long long*)groups;
  const cudaStream_t st = (cudaStream_t)stream;
  return cull ? launch_all<true, true>(op, st)
              : launch_all<false, true>(op, st);
}

const char* gpd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
