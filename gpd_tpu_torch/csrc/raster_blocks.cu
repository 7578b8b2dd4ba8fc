// raster_blocks: every per-cell sum of the 12/15-channel grasp images of a
// batch of hands, in one launch.
//
// Replaces gpd_tpu's Pallas TPU kernel _raster_blocks_pallas
// (gpd_tpu/ops/images.py:204, pallas_call at :319). That kernel builds row
// and column one-hots of each hand's points and contracts
// (row one-hot x value) against the column one-hot on the MXU. Here each
// (hand, projection group) is a work item whose planes are a histogram in
// shared memory: the points are added into their cells with shared-memory
// atomics and the planes go out whole.
//
// Layout (see gpd_tpu_torch/ops/images.py, raster_blocks):
//   midx  (G, 4, Km) int32   [rows_u, rows_w, cols_v, cols_u], sentinel size
//   mvals (G, 6, Km) bf16    [|n|x, |n|y, |n|z, u, v, w], pre-masked
//   sidx  (G, 4, Ks) int32   shadow points, same index rows
//   svals (G, 3, Ks) bf16    [u, v, w]
//   out   (G, NB, R, R) f32  NB = 15 (+6 shadow planes), R = size+1 up to 8
//   img   (G, C, size, size) uint8, C = 15 (12 without shadows): the
//         images kernel's output instead of out
// Group g < 3 is projection P_g with planes [ax, ay, az, depth, count] at
// 5g; group 3 + s is shadow projection s with planes [depth, count] at
// 15 + 2s. Rows and columns >= size stay exactly zero.
//
// Bound on an H100 SXM: bytes. The function moves ~229 MB per 512-hand
// chunk at Km = Ks = 2048 with shadows, 176 MB of it the f32 output, so the
// least time is ~68 us at 3.35 TB/s. The f32 additions are negligible: 15
// for each point and 6 for each shadow point that falls in the image,
// 13.2 M when 60% of them do.
//
// Design, against what held the first version (one block per item, 80 KB
// of shared memory each, clear -> add -> store in series) at 3.5x that
// bound:
//  - Persistent blocks: one 512-thread block per SM walks a contiguous run
//    of the (hand, group) items in hand-major order, so a hand's six groups
//    follow each other on one SM and re-read its rows from L2, not HBM. (A
//    strided walk would pin each block to one group kind, since 132 SMs is
//    a multiple of 6, and leave the main-group SMs 2.2x the bytes of the
//    shadow ones.)
//  - Two 80 KB histogram buffers: when an item is summed, one thread hands
//    its planes (80 KB or 32 KB, contiguous in the output) to the copy
//    engine as one cp.async.bulk store (bulk_store.cuh), and the block
//    clears the other buffer and sums the next item while it drains, so
//    the output stream, 77% of the bound's bytes, does not stop.
//  - Wide loads one step ahead: a thread takes 4 points at a time (one
//    16-byte load per index row, one 8-byte load per bf16 value row) and
//    loads its next 4 points, in this item or the next, before it adds the
//    current ones. K not a multiple of 4, or a misaligned operand, takes
//    the same walk one point at a time with scalar loads.
//  - What bounds it now is the additions, not the bytes. In the SASS
//    (cuobjdump -sass), a shared-memory f32 atomicAdd is no native add but
//    a loop: LDS, FADD, ATOMS.CAST.SPIN (compare-and-swap), branch back,
//    one dependent chain per value. The count plane therefore takes a
//    native integer atomic (ATOMS.POPC.INC), turned into floats in place
//    before the store. Four value planes interleaved per cell, each point
//    one 128-bit compare-and-swap and a transpose before the store, was
//    measured slower and is not used. Times: PERF.md.
//
// raster_blocks_images: the same walk, with each item's planes finished
// into uint8 image channels in shared memory instead of stored, so the
// 12/15-channel images leave the kernel done and the f32 planes never
// reach HBM (the output falls from ~176 MB to 27.6 MB per 512-hand chunk
// at 15 channels). What gpd_tpu_torch/ops/images.py's _raster_finish
// computes over the whole batch, each item computes over its own planes:
//  - main group P_g: mean_k = sum_k / max(count, 1) (k = 0..3), the depth
//    image count > 0 ? 1 - mean_3 : 0; the three normal means dilated 3x3
//    and minmax-normalised jointly, the depth image alone; channels 5g..5g+3
//    (4g..4g+3 at 12 channels);
//  - shadow group s: smean = sum / max(count, 1), mx the max of smean over
//    the cells with a count (0 without one), the image count > 0 ?
//    mx - smean : 0, dilated and normalised alone; channel 5s + 4.
// The dilation is the max over the in-bounds 3x3 neighbours (max_pool2d's
// -inf padding); minmax is (x - min) / (max - min) where max > min, else
// 0, times 255, rounded half to even. All in IEEE f32 in _raster_finish's
// order (__fdiv_rn and friends, never contracted), so from the same sums
// the bytes are _raster_finish's. One buffer a block: nothing drains from
// shared memory, so two blocks share an SM and one block's finish overlaps
// the other's atomics (1.4x faster than one block at 95 registers). Its
// bound is bytes, 80 MB per 512-hand chunk at 15 channels (operands read
// once, images written once), ~24 us; the atomics and the finish's
// per-pixel IEEE divisions (skipped where exact: a count <= 1, a pixel at
// the minimum) hold it at ~9x that. Times: PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_store.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMainPlanes = 5;
// Blocks of the images kernel on one SM: each holds one 80 KB buffer.
constexpr int kImagesBlocksPerSm = 2;
// Shared memory after the images kernel's buffer: block_max's partials.
constexpr int kRedBytes = kWarps * 4 * (int)sizeof(float);
// Dynamic shared memory one block may use on Hopper.
constexpr int kMaxSmem = 232448;

struct Operands {
  const int* midx;
  const uint16_t* mvals;  // bf16 bits
  const int* sidx;
  const uint16_t* svals;
  float* out;      // sums (raster_blocks), else null
  uint8_t* img;    // images (raster_blocks_images), else null
  int Km, Ks, size, R, NB, groups, items;
  int C;           // image channels: 15, or 12 without shadows
  bool vec_main, vec_shadow;  // 4-point loads are aligned
};

// One (hand, group) work item.
struct Item {
  const int* rows;
  const int* cols;
  const uint16_t* val[4];  // main: |n|x, |n|y, |n|z, depth; shadow: depth
  float* out;
  int units;  // 4-point units (vec) or points
  bool shadow, vec;
};

__device__ __forceinline__ bool is_shadow(const Operands& op, int item) {
  return item % op.groups >= 3;
}

__device__ __forceinline__ Item item_at(const Operands& op, int item) {
  const int64_t g = item / op.groups;
  const int grp = item - static_cast<int>(g) * op.groups;
  Item it;
  it.shadow = grp >= 3;
  const int p = it.shadow ? grp - 3 : grp;
  // Projection p: image rows from index row 0 (P0) or 1, columns from index
  // row 2 (P0, P1) or 3; depth is w, u, v (mvals rows 5, 3, 4; svals rows
  // 2, 0, 1).
  const int rsel = p == 0 ? 0 : 1;
  const int csel = p == 2 ? 3 : 2;
  const int K = it.shadow ? op.Ks : op.Km;
  const int* idx = (it.shadow ? op.sidx : op.midx) + g * 4 * K;
  it.rows = idx + rsel * K;
  it.cols = idx + csel * K;
  if (it.shadow) {
    it.val[0] = op.svals + (g * 3 + (p == 0 ? 2 : p - 1)) * K;
    it.val[1] = it.val[2] = it.val[3] = it.val[0];
  } else {
    const uint16_t* v = op.mvals + g * 6 * K;
    it.val[0] = v;
    it.val[1] = v + K;
    it.val[2] = v + 2 * K;
    it.val[3] = v + (p == 0 ? 5 : p + 2) * K;
  }
  it.vec = it.shadow ? op.vec_shadow : op.vec_main;
  it.units = it.vec ? K / 4 : K;
  const int first = it.shadow ? 15 + 2 * p : kMainPlanes * p;
  it.out = op.out + (g * op.NB + first) * static_cast<int64_t>(op.R * op.R);
  return it;
}

// Up to 4 points: cell indices and bf16 value bits (two per word).
struct Unit {
  int4 r, c;
  uint2 v[4];
};

__device__ __forceinline__ void load(Unit& u, const Item& it, int k) {
  const int nv = it.shadow ? 1 : 4;
  if (it.vec) {
    u.r = __ldg(reinterpret_cast<const int4*>(it.rows) + k);
    u.c = __ldg(reinterpret_cast<const int4*>(it.cols) + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nv) u.v[j] = __ldg(reinterpret_cast<const uint2*>(it.val[j]) + k);
  } else {
    u.r.x = __ldg(it.rows + k);
    u.c.x = __ldg(it.cols + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nv) u.v[j].x = __ldg(it.val[j] + k);
  }
}

__device__ __forceinline__ int lane(const int4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// bf16 value of point i from its bits, exactly as a float.
__device__ __forceinline__ float value(const uint2& v, int i) {
  const uint32_t w = i < 2 ? v.x : v.y;
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Adds up to N points: value planes by f32 atomicAdd (a compare-and-swap
// loop in shared memory on sm_90a), the count plane by a native integer
// atomic; counts_to_float turns it into floats before the store (the
// images kernel reads the integers).
template <int N>
__device__ __forceinline__ void add_points(float* hist, const Unit& u,
                                           bool shadow, int size, int R) {
  const int plane = R * R;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = lane(u.r, i), c = lane(u.c, i);
    if ((unsigned)r < (unsigned)size && (unsigned)c < (unsigned)size) {
      float* cell = hist + r * R + c;
      if (shadow) {
        atomicAdd(cell, value(u.v[0], i));
        atomicAdd(reinterpret_cast<unsigned*>(cell + plane), 1u);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          atomicAdd(cell + j * plane, value(u.v[j], i));
        atomicAdd(reinterpret_cast<unsigned*>(cell + 4 * plane), 1u);
      }
    }
  }
}

// The block turns a finished count plane from integers into floats, in
// place (exact: a cell holds at most K < 2^24 points).
__device__ __forceinline__ void counts_to_float(float* count, int plane) {
  __syncthreads();
  for (int i = threadIdx.x; i < plane; i += kThreads)
    count[i] = static_cast<float>(__float_as_uint(count[i]));
}

// This thread's next (item j, unit u) after the current one, in the order
// it works through its block's items.
__device__ __forceinline__ void advance(const Operands& op, int first, int n,
                                        int& j, int& u, Item& it) {
  u += kThreads;
  while (j < n && u >= it.units) {
    u = threadIdx.x;
    if (++j < n) it = item_at(op, first + j);
  }
}

// ---- The images kernel's finish of one item, in shared memory ----

// Each of v's N values becomes its max over the block, in every thread.
// red holds kWarps * N floats.
template <int N>
__device__ __forceinline__ void block_max(float (&v)[N], float* red) {
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
    if (ln == 0) red[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = red[i];
    for (int w = 1; w < kWarps; ++w) v[i] = fmaxf(v[i], red[w * N + i]);
  }
  __syncthreads();
}

// 3x3 max dilation of the size x size image at src (row stride R) into
// dst: the max over the in-bounds neighbours, as max_pool2d with -inf
// padding (a clamped index repeats an in-bounds neighbour). A warp takes
// runs of 4 rows, its lanes neighbouring columns. lo and hi take the min
// and max of the dilated values.
__device__ __forceinline__ void dilate3(const float* src, float* dst,
                                        int size, int R, float& lo,
                                        float& hi) {
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int r0 = 4 * warp; r0 < size; r0 += 4 * kWarps) {
    for (int c = ln; c < size; c += 32) {
      const int cl = c > 0 ? c - 1 : c, cr = c + 1 < size ? c + 1 : c;
      float h[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        int r = r0 - 1 + i;
        r = r < 0 ? 0 : (r < size ? r : size - 1);
        const float* row = src + r * R;
        h[i] = fmaxf(fmaxf(row[cl], row[c]), row[cr]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r0 + i < size) {
          const float d = fmaxf(fmaxf(h[i], h[i + 1]), h[i + 2]);
          dst[(r0 + i) * R + c] = d;
          lo = fminf(lo, d);
          hi = fmaxf(hi, d);
        }
      }
    }
  }
}

// The block calls f(o, p) for every cell of a size x size image: o its
// offset in a plane of row stride R, p in the packed image. A warp takes
// rows, its lanes columns.
template <typename F>
__device__ __forceinline__ void for_cells(int size, int R, F f) {
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int r = warp; r < size; r += kWarps)
    for (int c = ln; c < size; c += 32) f(r * R + c, r * size + c);
}

// A sum over its count as _raster_finish takes it, sum / max(count, 1):
// the division is exact (skipped) where count <= 1.
__device__ __forceinline__ float mean_of(float sum, uint32_t count) {
  return count > 1u ? __fdiv_rn(sum, static_cast<float>(count)) : sum;
}

// One pixel as _minmax_u8 makes it: (x - lo) / rng where rng > 0, else 0,
// times 255, rounded half to even (0 without arithmetic where x == lo).
__device__ __forceinline__ uint8_t to_u8(float x, float lo, float rng) {
  if (!(rng > 0.f) || x == lo) return 0;
  return static_cast<uint8_t>(
      rintf(__fmul_rn(__fdiv_rn(__fsub_rn(x, lo), rng), 255.f)));
}

// A main group's four channels from its summed planes [ax, ay, az, depth,
// count] (count as integers). The means and the depth image go in place;
// dilation k writes slot (k + 4) % 5, the slot that dilation k - 1 read,
// so the dilated channels end in slots 4, 0, 1, 2.
__device__ __forceinline__ void finish_main(const Operands& op, float* hist,
                                            float* red, uint8_t* dst) {
  const int size = op.size, R = op.R, plane = R * R, area = size * size;
  __syncthreads();  // every addition is in
  for_cells(size, R, [&](int o, int) {
    const uint32_t cnt = __float_as_uint(hist[4 * plane + o]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      hist[k * plane + o] = mean_of(hist[k * plane + o], cnt);
    const float depth = mean_of(hist[3 * plane + o], cnt);
    hist[3 * plane + o] = cnt > 0u ? __fsub_rn(1.f, depth) : 0.f;
  });
  // v: -min and max of the normal channels, then of the depth channel.
  float v[4] = {}, lo = INFINITY, hi = -INFINITY;
  for (int k = 0; k < 4; ++k) {
    __syncthreads();
    dilate3(hist + k * plane, hist + ((k + 4) % 5) * plane, size, R, lo, hi);
    if (k == 2) {
      v[0] = -lo;
      v[1] = hi;
      lo = INFINITY;
      hi = -INFINITY;
    }
  }
  v[2] = -lo;
  v[3] = hi;
  block_max<4>(v, red);  // its barriers also publish the dilations
  const float nlo = -v[0], nrng = __fsub_rn(v[1], nlo);
  const float dlo = -v[2], drng = __fsub_rn(v[3], dlo);
  for (int k = 0; k < 4; ++k) {
    const float* src = hist + ((k + 4) % 5) * plane;
    uint8_t* out = dst + k * area;
    const float klo = k < 3 ? nlo : dlo, krng = k < 3 ? nrng : drng;
    for_cells(size, R,
              [&](int o, int p) { out[p] = to_u8(src[o], klo, krng); });
  }
}

// A shadow group's channel from its planes [depth, count]: the image
// mx - smean goes in place, its dilation into the count plane.
__device__ __forceinline__ void finish_shadow(const Operands& op, float* hist,
                                              float* red, uint8_t* dst) {
  const int size = op.size, R = op.R, plane = R * R;
  __syncthreads();  // every addition is in
  float v[1] = {-INFINITY};
  for_cells(size, R, [&](int o, int) {
    const uint32_t cnt = __float_as_uint(hist[plane + o]);
    const float m = mean_of(hist[o], cnt);
    hist[o] = m;
    if (cnt > 0u) v[0] = fmaxf(v[0], m);
  });
  block_max<1>(v, red);
  const float mx = v[0] == -INFINITY ? 0.f : v[0];
  for_cells(size, R, [&](int o, int) {
    hist[o] = __float_as_uint(hist[plane + o]) > 0u ? __fsub_rn(mx, hist[o])
                                                    : 0.f;
  });
  __syncthreads();
  float lo = INFINITY, hi = -INFINITY;
  dilate3(hist, hist + plane, size, R, lo, hi);
  float w[2] = {-lo, hi};
  block_max<2>(w, red);
  const float slo = -w[0], srng = __fsub_rn(w[1], slo);
  for_cells(size, R, [&](int o, int p) {
    dst[p] = to_u8(hist[plane + o], slo, srng);
  });
}

// Where item's channels start in the (G, C, size, size) uint8 images.
__device__ __forceinline__ uint8_t* image_of(const Operands& op, int item) {
  const int64_t g = item / op.groups;
  const int grp = item - static_cast<int>(g) * op.groups;
  const int ch = grp >= 3 ? 5 * (grp - 3) + 4 : (op.C == 15 ? 5 : 4) * grp;
  return op.img + (g * op.C + ch) * static_cast<int64_t>(op.size * op.size);
}

// The persistent walk over the (hand, group) items, shared by both
// kernels. kImages: each item is finished into image channels in its one
// buffer; else its planes go out by bulk store, from two buffers where
// two fit.
template <bool kImages>
__device__ __forceinline__ void walk(const Operands& op, bool two_buffers) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int plane = op.R * op.R;
  const int slot = kMainPlanes * plane;
  const int first = static_cast<int>(
      static_cast<int64_t>(op.items) * blockIdx.x / gridDim.x);
  const int n = static_cast<int>(
      static_cast<int64_t>(op.items) * (blockIdx.x + 1) / gridDim.x) - first;
  if (n <= 0) return;

  auto planes_of = [&](int j) {
    return is_shadow(op, first + j) ? 2 : kMainPlanes;
  };
  // The walk: cur is loaded one step ahead of its additions.
  int cj = 0, cu = static_cast<int>(threadIdx.x) - kThreads;
  Item cit = item_at(op, first);
  advance(op, first, n, cj, cu, cit);
  Unit cur, nxt;
  if (cj < n) load(cur, cit, cu);

  bulk::clear(smem, planes_of(0) * plane / 4);
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    float* hist = smem + (two_buffers ? (j & 1) * slot : 0);
    while (cj == j) {
      int nj = cj, nu = cu;
      Item nit = cit;
      advance(op, first, n, nj, nu, nit);
      if (nj < n) load(nxt, nit, nu);
      if (cit.vec)
        add_points<4>(hist, cur, cit.shadow, op.size, op.R);
      else
        add_points<1>(hist, cur, cit.shadow, op.size, op.R);
      cur = nxt;
      cj = nj;
      cu = nu;
      cit = nit;
    }
    const bool more = j + 1 < n;
    if constexpr (kImages) {
      float* red = smem + slot;
      if (is_shadow(op, first + j))
        finish_shadow(op, hist, red, image_of(op, first + j));
      else
        finish_main(op, hist, red, image_of(op, first + j));
      __syncthreads();  // every read of the buffer is done
      if (more) bulk::clear(hist, planes_of(j + 1) * plane / 4);
      __syncthreads();
    } else {
      const int planes = planes_of(j);
      counts_to_float(hist + (planes - 1) * plane, plane);
      float* next = !more ? nullptr
                    : two_buffers ? smem + ((j + 1) & 1) * slot : hist;
      bulk::finish_item(hist, item_at(op, first + j).out, planes * plane,
                        true, two_buffers, next,
                        more ? planes_of(j + 1) * plane / 4 : 0);
    }
  }
  if (!kImages && threadIdx.x == 0) bulk::wait_read_all();
}

__global__ void __launch_bounds__(kThreads, 1)
raster_blocks_kernel(const Operands op, bool two_buffers) {
  walk<false>(op, two_buffers);
}

__global__ void __launch_bounds__(kThreads, kImagesBlocksPerSm)
raster_blocks_images_kernel(const Operands op) {
  walk<true>(op, false);
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

// The operands of both kernels, from the launchers' arguments.
Operands operands(const void* midx, const void* mvals, const void* sidx,
                  const void* svals, int G, int Km, int Ks, int size,
                  int with_shadow) {
  Operands op = {};
  op.midx = (const int*)midx;
  op.mvals = (const uint16_t*)mvals;
  op.sidx = (const int*)sidx;
  op.svals = (const uint16_t*)svals;
  op.Km = Km;
  op.Ks = Ks;
  op.size = size;
  op.R = ((size + 1 + 7) / 8) * 8;
  op.NB = with_shadow ? 21 : 15;
  op.C = with_shadow ? 15 : 12;
  op.groups = with_shadow ? 6 : 3;
  op.items = G * op.groups;
  op.vec_main = Km % 4 == 0 && aligned(midx, 16) && aligned(mvals, 8);
  op.vec_shadow = with_shadow && Ks % 4 == 0 && aligned(sidx, 16) &&
                  aligned(svals, 8);
  return op;
}

// The persistent grid: every item, or num_sms times the blocks of `smem`
// bytes that fit on one SM. Returns a cudaError_t.
template <typename Kernel>
int grid_of(Kernel kernel, int smem, int items, int num_sms, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = items < num_sms * per_sm ? items : num_sms * per_sm;
  return 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t (0 on success). Shadow
// pointers are ignored when with_shadow is 0. num_sms is the card's SM
// count: the persistent grid is num_sms times the blocks that fit on one.
int raster_blocks_launch(const void* midx, const void* mvals, const void* sidx,
                         const void* svals, void* out, int G, int Km, int Ks,
                         int size, int with_shadow, int num_sms,
                         void* stream) {
  Operands op = operands(midx, mvals, sidx, svals, G, Km, Ks, size,
                         with_shadow);
  op.out = (float*)out;
  const int slot_bytes = kMainPlanes * op.R * op.R * (int)sizeof(float);
  const bool two = 2 * slot_bytes <= kMaxSmem;
  const int smem = (two ? 2 : 1) * slot_bytes;
  int grid = 0;
  const int err = grid_of(raster_blocks_kernel, smem, op.items, num_sms,
                          &grid);
  if (err != 0 || G == 0) return err;
  raster_blocks_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(op, two);
  return (int)cudaGetLastError();
}

// As raster_blocks_launch, writing the finished (G, C, size, size) uint8
// images (C = 15 with shadows, else 12) to `img`.
int raster_images_launch(const void* midx, const void* mvals, const void* sidx,
                         const void* svals, void* img, int G, int Km, int Ks,
                         int size, int with_shadow, int num_sms,
                         void* stream) {
  Operands op = operands(midx, mvals, sidx, svals, G, Km, Ks, size,
                         with_shadow);
  op.img = (uint8_t*)img;
  const int smem = kMainPlanes * op.R * op.R * (int)sizeof(float) + kRedBytes;
  int grid = 0;
  const int err = grid_of(raster_blocks_images_kernel, smem, op.items,
                          num_sms, &grid);
  if (err != 0 || G == 0) return err;
  raster_blocks_images_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      op);
  return (int)cudaGetLastError();
}

const char* gpd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
