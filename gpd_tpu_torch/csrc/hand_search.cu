// hand_search: every (axis, orientation) hand of every sample in one
// launch, the port's form of the hand search's orientation pass
// (gpd_tpu_torch/ops/candidates.py, _eval_orientations: hand_set.cpp:49-116,
// finger_hand.cpp and antipodal.cpp of the reference).
//
// It replaces no Pallas kernel: gpd_tpu's counterpart (_search_kernel,
// gpd_tpu/ops/candidates.py:282) is plain XLA. It was added because the
// plain PyTorch chain took most of a grasp request on the H100: 80.9 ms of
// 105.9 (table scenes, capacity 10240-14336) and 60.8 of 90.2 (one-camera
// PCD scenes, capacity 8192-16384) in program A, in ATen's generic
// reduce and elementwise kernels over (M, S, K) tensors whose K is the
// padded cloud. 82-91% of those elements are points outside the sample's
// radius (1268-2326 members on average of each 8192-14336-point row).
//
// Layout (see hand_search in gpd_tpu_torch/ops/candidates.py):
//   points, normals (N, 3) f32; spos (S, 3) f32; frames (S, 3, 3) f32;
//   rfix (M, 3, 3) f32
//   member (S, L) bool   the plain path's radius mask, read as input so
//                        the radius test rounds as it does there
//   idx (S, L) int64     the capped route's nearest-K indices, or null:
//                        identity rows, L == N, member j is point j
//   out: R (M, S, 3, 3), pos (M, S, 3), top, bottom, center, width (M, S)
//   f32; mid (M, S) int64; valid, full, half (M, S) bool; members (S,)
//   int32, each sample's member count.
//
// Bound on an H100 SXM: operations. The mask is 14.3 MB at S = 1000 and
// L = 14336 (4.3 us at 3.35 TB/s); the arithmetic is ~99 f32 operations
// per (member, orientation): the hand-frame coordinates, the height crop
// and 2P = 20 finger-slab tests and minima, then the closing-region test.
// At ~2000 members, M = 8 and S = 1000 that is ~1.6 G operations, ~24 us
// at 67 TFLOP/s. Times against it: PERF.md.
//
// Design:
//  - One block per sample; compact first. The block scans its sample's
//    row and keeps only the members in shared memory, 16 B each: the
//    offset from the sample (the plain path's float32 subtraction) and
//    the point's index. Min, max, any and count do not depend on order and
//    skip what is masked, so dropping the non-members and reordering the
//    rest changes no bit of any statistic.
//  - One warp per orientation slot (warps loop when M exceeds the block's
//    8). The warp forms R = frame @ rfix[m] once, then makes the dependent
//    passes over the member list with the hand-frame x, y, z in registers:
//    (a) the min x over the height crop and over each finger slab; then
//    the middle placement, the deepen count, top and bottom, the same
//    scalars in every lane; (b) the closing region's y extremes and any;
//    (c) the left and right contact sets' x and z extremes (their normals
//    read from L2 for closing-region points only); (d) the in-box counts.
//    Reductions are warp shuffles; nothing goes through device memory.
//    A pass that cannot change the outputs (no placement fits, no point
//    closes the hand, a contact set is empty) is skipped.
//  - A neighbourhood larger than the tile (set by the wrapper) is swept
//    in tiles: each pass visits every tile, re-compacting from the row
//    (its points come from L2), so the path is right at any count, and the
//    sweep starts from the tile in shared memory.
//  - Every comparison and add is the plain path's, in float32 with its
//    constants rounded to float32 as PyTorch rounds a Python scalar; the
//    coordinates are fused multiply-adds, within an ulp of its einsum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSlabs = 64;   // 2 x finger placements
constexpr int kMaxDepths = 64;  // deepenHand's depths
constexpr float kPos = 1e9f;    // the plain path's _POS / _NEG
constexpr float kNeg = -1e9f;
constexpr unsigned kAll = 0xffffffffu;

// The search's parameters, as float32 scalars and arrays.
struct Geometry {
  float hand_height;   // height crop: -h < z < h
  float bite;          // init_bite
  float bite_abort;    // init_bite - hand_depth, rounded once
  float hand_depth;
  float finger_width;
  float friction_cos;
  float margin;        // the antipodal test's 0.003
  int P, num_depths, min_viable;
  float lo[kMaxSlabs];  // finger slab q: lo[q] < y < hi[q]; lo = spacing
  float hi[kMaxSlabs];
  float depths[kMaxDepths];
};

struct Operands {
  const float* points;
  const float* normals;
  const float* spos;
  const float* frames;
  const float* rfix;
  const uint8_t* member;
  const int64_t* idx;
  float* R;
  float* pos;
  float* top;
  float* bottom;
  float* center;
  float* width;
  int64_t* mid;
  uint8_t* valid;
  uint8_t* full;
  uint8_t* half;
  int* members;
  int S, M, L, tile;
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

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// Hand-frame coordinates of an offset: p_i = sum_j rel_j R[j][i].
__device__ __forceinline__ void hand_xyz(const float* R, float4 p, float& x,
                                         float& y, float& z) {
  x = fmaf(p.z, R[6], fmaf(p.y, R[3], p.x * R[0]));
  y = fmaf(p.z, R[7], fmaf(p.y, R[4], p.x * R[1]));
  z = fmaf(p.z, R[8], fmaf(p.y, R[5], p.x * R[2]));
}

// Block-wide: the members of rank [first, first + tile) of sample s's row,
// in row order, into `tile` (offset from the sample, point index in w).
// Returns the row's member count. Starts and ends with every thread past a
// __syncthreads, so the caller may overwrite a tile other warps have read.
__device__ int compact(const Operands& op, int s, int first, float4* tile,
                       int* wsum, float sx, float sy, float sz) {
  const uint8_t* row = op.member + (size_t)s * op.L;
  const int64_t* irow = op.idx ? op.idx + (size_t)s * op.L : nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < op.L; c0 += 4 * kThreads) {
    const int i0 = c0 + 4 * (int)threadIdx.x;
    bool f[4];
    int n = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = i0 + k < op.L && row[i0 + k] != 0;
      n += f[k];
    }
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int r = base + incl - n, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) r += wsum[w];
      total += wsum[w];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!f[k]) continue;
      if (r >= first && r < first + op.tile) {
        const int64_t j = irow ? irow[i0 + k] : (int64_t)(i0 + k);
        const float* p = op.points + 3 * j;
        tile[r - first] = make_float4(p[0] - sx, p[1] - sy, p[2] - sz,
                                      __int_as_float((int)j));
      }
      ++r;
    }
    base += total;
    __syncthreads();
  }
  return base;
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 2)
    hand_search_kernel(const __grid_constant__ Operands op,
                       const __grid_constant__ Geometry g) {
  extern __shared__ float4 tile[];
  __shared__ int wsum[kWarps];
  __shared__ float slab_min[kWarps][kMaxSlabs];
  __shared__ float s_lo[kMaxSlabs];
  __shared__ float s_depth[kMaxDepths];
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = g.P, nslab = 2 * g.P;
  if (threadIdx.x < kMaxSlabs) s_lo[threadIdx.x] = g.lo[threadIdx.x];
  if (threadIdx.x < kMaxDepths) s_depth[threadIdx.x] = g.depths[threadIdx.x];
  __syncthreads();

  const float sx = op.spos[3 * s], sy = op.spos[3 * s + 1],
              sz = op.spos[3 * s + 2];
  const int total = compact(op, s, 0, tile, wsum, sx, sy, sz);
  if (threadIdx.x == 0) op.members[s] = total;
  const int ntiles = total > op.tile ? (total + op.tile - 1) / op.tile : 1;
  int loaded = 0;

  // body(n) over the tile in shared memory, n members, for every tile.
  // With one tile the members stay put and nothing synchronises; with
  // more, every warp takes part in each sweep (need or not) and the block
  // skips a sweep no warp needs.
  auto sweep = [&](bool need, auto&& body) {
    if (ntiles == 1) {
      if (need) body(total);
      return;
    }
    if (!__syncthreads_or(need)) return;
    const int start = loaded;
    for (int k = 0; k < ntiles; ++k) {
      const int t = (start + k) % ntiles;
      if (t != loaded) {
        compact(op, s, t * op.tile, tile, wsum, sx, sy, sz);
        loaded = t;
      }
      const int n = total - t * op.tile;
      if (need) body(n < op.tile ? n : op.tile);
    }
  };

  float F[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) F[i] = op.frames[9 * s + i];
  const float h = g.hand_height;

  for (int m0 = 0; m0 < op.M; m0 += kWarps) {
    const int m = m0 + warp;
    const bool active = m < op.M;
    const float* rf = op.rfix + 9 * (active ? m : 0);
    float R[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        R[3 * i + k] = fmaf(F[3 * i + 2], rf[6 + k],
                            fmaf(F[3 * i + 1], rf[3 + k], F[3 * i] * rf[k]));

    // (a) min x over the height crop, and over each finger slab.
    float minx_all = kPos;
    float ms[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) ms[q] = kPos;
    sweep(active, [&](int n) {
      for (int i = lane; i < n; i += 32) {
        float x, y, z;
        hand_xyz(R, tile[i], x, y, z);
        if (!(z > -h && z < h)) continue;
        minx_all = fminf(minx_all, x);
#pragma unroll
        for (int q = 0; q < NS; ++q)
          if (q < nslab && y > g.lo[q] && y < g.hi[q]) ms[q] = fminf(ms[q], x);
      }
    });

    int mid = 0;
    bool valid0 = false;
    float top = g.bite;
    if (active) {
      minx_all = warp_min(minx_all);
#pragma unroll
      for (int q = 0; q < NS; ++q)
        if (q < nslab) {
          const float v = warp_min(ms[q]);
          if (lane == 0) slab_min[warp][q] = v;
        }
      __syncwarp();
      const float* sm = slab_min[warp];
      // Fingers at the initial bite; the middle of the placements where
      // both fit (chooseMiddleHand: the ceil(n/2)-th, else 0).
      const bool base_ok = minx_all < g.bite && !(minx_all < g.bite_abort);
      int cnt = 0;
      for (int p = 0; p < P; ++p)
        cnt += base_ok && !(sm[p] < g.bite) && !(sm[p + P] < g.bite);
      const int target = (cnt + 1) / 2;
      for (int p = 0, seen = 0; p < P; ++p) {
        if (base_ok && !(sm[p] < g.bite) && !(sm[p + P] < g.bite) &&
            ++seen == target) {
          mid = p;
          break;
        }
      }
      valid0 = cnt > 0;
      if (g.num_depths > 0) {
        // deepenHand: the depths up to the first collision.
        const float dmax = fminf(fminf(sm[mid], sm[mid + P]),
                                 minx_all + g.hand_depth);
        int alive = 0;
        if (s_depth[0] > minx_all)
          for (int d = 0; d < g.num_depths; ++d) alive += s_depth[d] <= dmax;
        top = alive > 0 ? s_depth[alive - 1] : g.bite;
      }
    }
    const float bottom = top - g.hand_depth;
    const float left = s_lo[mid] + g.finger_width;
    const float right = s_lo[mid + P];
    const float center = 0.5f * (left + right);
    auto closing = [&](float x, float y, float z) {
      return z > -h && z < h && x > bottom && x < top && y > left &&
             y < right;
    };

    // (b) the closing region: y extremes and whether it holds a point.
    float miny = kPos, maxy = kNeg;
    bool any_close = false;
    const bool need_b = active && valid0;
    sweep(need_b, [&](int n) {
      for (int i = lane; i < n; i += 32) {
        float x, y, z;
        hand_xyz(R, tile[i], x, y, z);
        if (closing(x, y, z)) {
          miny = fminf(miny, y);
          maxy = fmaxf(maxy, y);
          any_close = true;
        }
      }
    });
    if (need_b) {
      miny = warp_min(miny);
      maxy = warp_max(maxy);
      any_close = __any_sync(kAll, any_close);
    }
    const bool valid = valid0 && any_close;

    // (c) the antipodal contact sets: normals against the closing axis,
    // beyond the margins; their x and z extremes.
    const float lo_y = miny + g.margin, hi_y = maxy - g.margin;
    const float fc = g.friction_cos;
    bool any_l = false, any_r = false;
    float lx0 = kPos, lx1 = kNeg, lz0 = kPos, lz1 = kNeg;
    float rx0 = kPos, rx1 = kNeg, rz0 = kPos, rz1 = kNeg;
    auto normal_y = [&](float4 p) {
      const float* n = op.normals + 3 * (int64_t)__float_as_int(p.w);
      return fmaf(n[2], R[7], fmaf(n[1], R[4], n[0] * R[1]));
    };
    sweep(valid, [&](int n) {
      for (int i = lane; i < n; i += 32) {
        const float4 p = tile[i];
        float x, y, z;
        hand_xyz(R, p, x, y, z);
        if (!closing(x, y, z)) continue;
        const float ny = normal_y(p);
        if (-ny > fc && y < lo_y) {
          any_l = true;
          lx0 = fminf(lx0, x); lx1 = fmaxf(lx1, x);
          lz0 = fminf(lz0, z); lz1 = fmaxf(lz1, z);
        }
        if (ny > fc && y > hi_y) {
          any_r = true;
          rx0 = fminf(rx0, x); rx1 = fmaxf(rx1, x);
          rz0 = fminf(rz0, z); rz1 = fmaxf(rz1, z);
        }
      }
    });
    if (valid) {
      any_l = __any_sync(kAll, any_l);
      any_r = __any_sync(kAll, any_r);
    }
    const bool need_d = valid && any_l && any_r;
    if (need_d) {
      lx0 = warp_min(lx0); lx1 = warp_max(lx1);
      lz0 = warp_min(lz0); lz1 = warp_max(lz1);
      rx0 = warp_min(rx0); rx1 = warp_max(rx1);
      rz0 = warp_min(rz0); rz1 = warp_max(rz1);
    }

    // (d) the contact points inside both sets' common box.
    const float top_x = fminf(lx1, rx1), bot_x = fmaxf(lx0, rx0);
    const float top_z = fminf(lz1, rz1), bot_z = fmaxf(lz0, rz0);
    int nl = 0, nr = 0;
    sweep(need_d, [&](int n) {
      for (int i = lane; i < n; i += 32) {
        const float4 p = tile[i];
        float x, y, z;
        hand_xyz(R, p, x, y, z);
        if (!closing(x, y, z) || !(x >= bot_x && x <= top_x && z >= bot_z &&
                                   z <= top_z))
          continue;
        const float ny = normal_y(p);
        nl += -ny > fc && y < lo_y;
        nr += ny > fc && y > hi_y;
      }
    });
    bool full = false;
    if (need_d) {
      nl = warp_sum(nl);
      nr = warp_sum(nr);
      full = nl >= g.min_viable && nr >= g.min_viable;
    }

    if (active && lane == 0) {
      const size_t o = (size_t)m * op.S + s;
#pragma unroll
      for (int i = 0; i < 9; ++i) op.R[9 * o + i] = R[i];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        op.pos[3 * o + i] = fmaf(R[3 * i + 2], 0.f,
                                 fmaf(R[3 * i + 1], center,
                                      R[3 * i] * bottom));
      op.top[o] = top;
      op.bottom[o] = bottom;
      op.center[o] = center;
      op.width[o] = valid ? maxy - miny : 0.f;
      op.mid[o] = mid;
      op.valid[o] = valid;
      op.full[o] = full;
      op.half[o] = valid && (any_l || any_r);
    }
  }
}

template <int NS>
int launch(const Operands& op, const Geometry& g, cudaStream_t stream) {
  const int smem = op.tile * (int)sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      hand_search_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  hand_search_kernel<NS><<<op.S, kThreads, smem, stream>>>(op, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 on success), or
// cudaErrorInvalidValue for parameters the kernel cannot hold. `geom` is a
// host array: hand_height, init_bite, init_bite - hand_depth, hand_depth,
// finger_width, friction_cos, margin, then the 2P slab starts, the 2P slab
// ends and the num_depths deepening depths. `idx` may be null (identity
// rows, L == N). `tile` is the members a block keeps in shared memory.
int hand_search_launch(const void* points, const void* normals,
                       const void* spos, const void* frames, const void* rfix,
                       const void* member, const void* idx, void* R, void* pos,
                       void* top, void* bottom, void* center, void* width,
                       void* mid, void* valid, void* full, void* half,
                       void* members, int S, int M, int L, int tile,
                       const float* geom, int P, int num_depths,
                       int min_viable, void* stream) {
  if (P < 1 || 2 * P > kMaxSlabs || num_depths < 0 ||
      num_depths > kMaxDepths || tile < 1)
    return (int)cudaErrorInvalidValue;
  Geometry g = {};
  g.hand_height = geom[0];
  g.bite = geom[1];
  g.bite_abort = geom[2];
  g.hand_depth = geom[3];
  g.finger_width = geom[4];
  g.friction_cos = geom[5];
  g.margin = geom[6];
  g.P = P;
  g.num_depths = num_depths;
  g.min_viable = min_viable;
  for (int q = 0; q < 2 * P; ++q) {
    g.lo[q] = geom[7 + q];
    g.hi[q] = geom[7 + 2 * P + q];
  }
  for (int d = 0; d < num_depths; ++d) g.depths[d] = geom[7 + 4 * P + d];

  Operands op;
  op.points = (const float*)points;
  op.normals = (const float*)normals;
  op.spos = (const float*)spos;
  op.frames = (const float*)frames;
  op.rfix = (const float*)rfix;
  op.member = (const uint8_t*)member;
  op.idx = (const int64_t*)idx;
  op.R = (float*)R;
  op.pos = (float*)pos;
  op.top = (float*)top;
  op.bottom = (float*)bottom;
  op.center = (float*)center;
  op.width = (float*)width;
  op.mid = (int64_t*)mid;
  op.valid = (uint8_t*)valid;
  op.full = (uint8_t*)full;
  op.half = (uint8_t*)half;
  op.members = (int*)members;
  op.S = S;
  op.M = M;
  op.L = L;
  op.tile = tile;
  if (S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return 2 * P == 20 ? launch<20>(op, g, st) : launch<kMaxSlabs>(op, g, st);
}

const char* gpd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
