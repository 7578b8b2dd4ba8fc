"""Grasp-image descriptors (port of gpd_tpu/ops/images.py).

The reference's descriptor layer (src/gpd/descriptor/image_strategy.cpp,
image_{1,3,12,15}_channels_strategy.cpp, src/gpd/candidate/hand_set.cpp:118-233
shadows) for a whole batch of hands at once: the hands' points move into
the unit image volume, a CUDA kernel sums every per-cell value, and a 3x3
max-pool dilation and a per-image minmax give uint8 images.

Two routes, as in gpd_tpu:

  - 12 and 15 channels: gpd_tpu's channel-major route (images.py:774-814)
    on both devices. ``raster_images`` sums the three projections in one
    kernel and finishes each hand's channels there (on the CPU:
    ``raster_blocks_ref``, then ``_raster_finish``); value channels enter
    it in bfloat16 and are summed in float32.
  - 1 and 3 channels: projection P0 only (images.py:711-736).
    ``scatter_mean`` sums it with ``raster_sums``, all in float32 (gpd_tpu's
    CPU route and ``Precision.HIGHEST``; its TPU kernel takes one bf16 MXU
    pass, ROADMAP.md C).

Deliberate divergences from the reference, as in gpd_tpu: each cell takes
the mean of |n| (the reference blends incrementally in kd-tree order), and
shadow jitter comes from ``ops/draws.py`` rather than an unseeded LCG.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from gpd_tpu_torch.config import ImageGeometry
from gpd_tpu_torch.ops import _build
from gpd_tpu_torch.ops.neighbors import sum_sq3

SHADOW_VOXEL = 0.003
_POS = 1e9

# Invertible multiplicative mix on the 30-bit packed voxel keys: C is odd,
# so key -> key*C mod 2^30 is a bijection (dedup by sort stays exact) whose
# image is pseudo-uniform, and "the v_cap smallest hashed keys" is a
# spatially spread subset of the occupied voxels. Computed in int64 as
# (key * C) & mask, which equals gpd_tpu's wrapping uint32 product for keys
# below 2^30.
_KEY_HASH = 0x1E3779B1
_KEY_UNHASH = pow(_KEY_HASH, -1, 1 << 30)
_KEY_MASK = (1 << 30) - 1
_KEY_NONE = 1 << 30


def num_shadow_points(image: ImageGeometry) -> int:
    """floor(shadow_length / voxel); shadow_length = max image dim
    (image_15_channels_strategy.h:75, hand_set.cpp:121-123)."""
    return int(shadow_length_of(image) // SHADOW_VOXEL)


def shadow_length_of(image: ImageGeometry) -> float:
    return max(image.outer_diameter, image.depth, image.height / 2.0)


def compute_shadows(nn_pts, nn_valid, nn_cam, view_points,
                    shadow_length: float, n_sp: int, v_cap: int,
                    uniforms: torch.Tensor, jitter: torch.Tensor):
    """Per-sample occluded-region point sets (HandSet::calculateShadow,
    hand_set.cpp:118-233).

    Args:
      nn_pts: (S, K, 3) world-frame shadow source points.
      nn_valid: (S, K) bool.
      nn_cam: (S, K) int64 camera bitmask per source point.
      view_points: (V, 3) camera positions.
      n_sp: shadow points cast per source point.
      v_cap: cap on unique shadow voxels per sample.
      uniforms: (S, V, K, n_sp) ray positions in [0, 1), one row per sample.
      jitter: (S, >= min(v_cap, K * n_sp)) standard normal voxel jitter.

    Returns:
      (shadow_pts (S, v_cap', 3), shadow_valid (S, v_cap')) with
      v_cap' = min(v_cap, K * n_sp).
    """
    S, K, _ = nn_pts.shape
    V = view_points.shape[0]
    w = nn_valid.to(torch.float32)
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    center = torch.sum(nn_pts * w[..., None], dim=1) / cnt[:, None]

    # Which cameras see >= 1 point of each neighborhood (hand_set.cpp:130).
    cam_ids = torch.arange(V, device=nn_cam.device)
    seen_pt = (((nn_cam[..., None] >> cam_ids) & 1) > 0) & nn_valid[..., None]
    cam_seen = torch.any(seen_pt, dim=1)                             # (S, V)

    inv_vox = 1.0 / SHADOW_VOXEL
    # Keys pack voxel coordinates relative to a per-sample base voxel, so
    # the 10-bit fields never alias wherever the workspace sits; cell
    # boundaries stay world-anchored with the reference's cast<int>
    # truncation (hand_set.cpp:156-160).
    pmin = torch.amin(torch.where(nn_valid[..., None], nn_pts, _POS), dim=1)
    base = torch.clamp(torch.trunc((pmin - shadow_length) * inv_vox),
                       -2.0 ** 30, 2.0 ** 30).to(torch.int32) - 2    # (S, 3)

    def cam_voxels(c):
        vec = center - view_points[c][None, :]                       # (S, 3)
        vec = shadow_length * vec / torch.clamp(
            torch.sqrt(sum_sq3(vec))[:, None], min=1e-12)
        q = torch.addcmul(nn_pts[:, :, None, :], uniforms[:, c, :, :, None],
                          vec[:, None, None, :])                     # (S,K,n,3)
        vox = torch.trunc(q * inv_vox).to(torch.int32)               # cast<int>
        rel = (vox - base[:, None, None, :]).to(torch.int64)
        key = (rel[..., 0] << 20) | (rel[..., 1] << 10) | rel[..., 2]
        key = (key * _KEY_HASH) & _KEY_MASK
        key = torch.where(nn_valid[:, :, None], key, _KEY_NONE)
        return key.reshape(S, K * n_sp)

    cam0 = torch.sort(cam_voxels(0), dim=1).values                   # (S, K*n)
    uniq = torch.ones_like(cam0, dtype=torch.bool)
    uniq[:, 1:] = cam0[:, 1:] != cam0[:, :-1]
    valid = uniq & (cam0 < _KEY_NONE) & cam_seen[:, 0:1]

    # Intersect with every other camera that sees the neighborhood
    # (hand_set.cpp:168-176).
    for c in range(1, V):
        oc = torch.sort(cam_voxels(c), dim=1).values
        pos = torch.clamp(torch.searchsorted(oc, cam0), max=oc.shape[1] - 1)
        member = torch.gather(oc, 1, pos) == cam0
        valid = valid & torch.where(cam_seen[:, c:c + 1], member, True)

    # The hashed keys are unique among valid entries, so the v_cap smallest
    # ARE the compaction, and a hash-uniform spread of the occupied region.
    v_cap = min(v_cap, K * n_sp)
    skey = torch.where(valid, cam0, _KEY_NONE)
    hashed = torch.topk(skey, v_cap, dim=1, largest=False, sorted=True).values
    validc = hashed < _KEY_NONE
    packed = torch.where(validc, (hashed * _KEY_UNHASH) & _KEY_MASK, _KEY_NONE)

    vox = torch.stack([((packed >> 20) & 0x3FF) + base[:, None, 0],
                       ((packed >> 10) & 0x3FF) + base[:, None, 1],
                       (packed & 0x3FF) + base[:, None, 2]],
                      dim=-1).to(torch.float32)

    # Voxels -> points with a shared-scalar N(0,1)*0.3*voxel jitter
    # (hand_set.cpp:187-206: the same scalar for all 3 coords of a voxel).
    jit = jitter[:, :v_cap, None] * (0.3 * SHADOW_VOXEL)
    return vox * SHADOW_VOXEL + jit, validc


def _cell_coord(c, size: int):
    """One axis of findCellIndices (image_strategy.cpp:92-102): clamped
    floor to the grid."""
    return torch.clamp(torch.floor(c * size).to(torch.int32), max=size - 1)


def _dilate3(img):
    """3x3 max dilation (cv::dilate, MORPH_RECT 3x3) of (G, C, H, W); the
    border never injects values (max_pool2d pads with -inf)."""
    return F.max_pool2d(img, kernel_size=3, stride=1, padding=1)


def _minmax_u8(img):
    """cv::normalize NORM_MINMAX to [0,1] then convertTo(CV_8U, 255)
    (image_strategy.cpp:149-155), over all channels of each (G, C, H, W)
    image jointly (the 3 normal channels normalize together)."""
    mn = torch.amin(img, dim=(1, 2, 3), keepdim=True)
    mx = torch.amax(img, dim=(1, 2, 3), keepdim=True)
    rng = mx - mn
    out = torch.where(rng > 0, (img - mn) / torch.where(rng > 0, rng, 1.0), 0.0)
    return torch.round(out * 255.0).to(torch.uint8)    # round half to even


def _unit_transform_cm(x, y, z, bottom, center, image: ImageGeometry):
    """findPointsInUnitImage + transformPointsToUnitImage
    (image_strategy.cpp:53-90) on channel-major rows: x/y/z are (G, K)
    hand-frame coordinates. Returns (u, v, w, inside), each (G, K)."""
    half_od = image.outer_diameter / 2.0
    b = bottom[..., None]
    c = center[..., None]
    inside = ((x > b) & (x < b + image.depth) &
              (y > c - half_od) & (y < c + half_od) &
              (z > -image.height) & (z < image.height))
    u = (x - b) / image.depth
    v = (y - (c - half_od)) / image.outer_diameter
    w = (z + image.height) / (2.0 * image.height)
    return u, v, w, inside


def _cm_operands(u, v, w, inside, extra_rows: Sequence[torch.Tensor],
                 size: int):
    """Raster operands from channel-major rows: the index stack
    [rows_u, rows_w, cols_v, cols_u] (G, 4, K) int32 (sentinel = size) and
    the value stack [*extra_rows, u, v, w] (G, len+3, K) bfloat16, masked.
    Rows are flipped (row = size-1 - cell) as the reference writes them."""
    cu = _cell_coord(u, size)
    cv = _cell_coord(v, size)
    cw = _cell_coord(w, size)
    idx = torch.stack([(size - 1) - cu, (size - 1) - cw, cv, cu], dim=1)
    idx = torch.where(inside[:, None, :], idx, size).to(torch.int32)
    vals = torch.stack([*extra_rows, u, v, w], dim=1) * \
        inside[:, None, :].to(torch.float32)
    return idx.contiguous(), vals.to(torch.bfloat16).contiguous()


# Output planes of raster_blocks, per projection group: (first plane, index
# row of the image rows, index row of the image columns, value rows). Value
# row None is the count. Main groups read mvals [|n|x, |n|y, |n|z, u, v, w];
# shadow groups read svals [u, v, w]. csrc/raster_blocks.cu holds the same
# table.
_MAIN_GROUPS = ((0, 0, 2, (0, 1, 2, 5, None)),     # P0: rows u, cols v, depth w
                (5, 1, 2, (0, 1, 2, 3, None)),     # P1: rows w, cols v, depth u
                (10, 1, 3, (0, 1, 2, 4, None)))    # P2: rows w, cols u, depth v
_SHADOW_GROUPS = ((15, 0, 2, (2, None)),
                  (17, 1, 2, (0, None)),
                  (19, 1, 3, (1, None)))


def raster_rows(size: int) -> int:
    """Side R of the square output blocks: size + 1 rounded up to 8, so the
    sentinel row/column `size` lands in the zero tail."""
    return -(-(size + 1) // 8) * 8


def raster_blocks_ref(midx, mvals, sidx=None, svals=None, size: int = 60):
    """Plain PyTorch version of ``raster_blocks``: the bfloat16 values,
    upcast to float32, scatter-added (``index_add_``) into the same
    (G, NB, R, R) layout."""
    G = midx.shape[0]
    R = raster_rows(size)
    NB = 15 if sidx is None else 21
    out = torch.zeros(G * NB * R * R, dtype=torch.float32, device=midx.device)
    g = torch.arange(G, device=midx.device)[:, None]

    def add(idx, vals, groups):
        for plane0, rsel, csel, value_rows in groups:
            rows = idx[:, rsel].long()
            cols = idx[:, csel].long()
            ok = (rows >= 0) & (rows < size) & (cols >= 0) & (cols < size)
            okf = ok.to(torch.float32)
            cell = torch.where(ok, rows * R + cols, 0)
            for j, vrow in enumerate(value_rows):
                contrib = okf if vrow is None else vals[:, vrow].float() * okf
                flat = (g * NB + plane0 + j) * (R * R) + cell
                out.index_add_(0, flat.reshape(-1), contrib.reshape(-1))

    add(midx, mvals, _MAIN_GROUPS)
    if sidx is not None:
        add(sidx, svals, _SHADOW_GROUPS)
    return out.reshape(G, NB, R, R)


def _check_operands(midx, mvals, sidx, svals, size: int):
    G, nrow, Km = midx.shape
    if nrow != 4 or midx.dtype != torch.int32:
        raise ValueError(f"midx must be (G, 4, Km) int32, got "
                         f"{tuple(midx.shape)} {midx.dtype}")
    if mvals.shape != (G, 6, Km) or mvals.dtype != torch.bfloat16:
        raise ValueError(f"mvals must be ({G}, 6, {Km}) bfloat16, got "
                         f"{tuple(mvals.shape)} {mvals.dtype}")
    tensors = [midx, mvals]
    if (sidx is None) != (svals is None):
        raise ValueError("sidx and svals go together")
    if sidx is not None:
        Ks = sidx.shape[-1]
        if sidx.shape != (G, 4, Ks) or sidx.dtype != torch.int32:
            raise ValueError(f"sidx must be ({G}, 4, Ks) int32, got "
                             f"{tuple(sidx.shape)} {sidx.dtype}")
        if svals.shape != (G, 3, Ks) or svals.dtype != torch.bfloat16:
            raise ValueError(f"svals must be ({G}, 3, {Ks}) bfloat16, got "
                             f"{tuple(svals.shape)} {svals.dtype}")
        tensors += [sidx, svals]
    if any(t.device != midx.device for t in tensors):
        raise ValueError("raster operands must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("raster operands must be contiguous")
    # One item's 5 planes must fit in a block's shared memory; the kernel
    # keeps two items' (2 x 80 KB at size 60) where they fit, so one item's
    # bulk store drains while the next is summed.
    if 5 * raster_rows(size) ** 2 * 4 > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"image size {size} needs more shared memory than a "
                         "block has")


_RASTER_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    """The card's SM count, read once per device: the persistent kernels
    size their grid by it."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch_blocks(name: str, symbol: str, out, midx, mvals, sidx, svals,
                   size: int):
    """Runs ``symbol`` of csrc/raster_blocks.cu (``raster_blocks_launch``
    or ``raster_images_launch``) on checked CUDA operands into ``out``, a
    launch of the wrapper ``name``."""
    if midx.device.type != "cuda":
        raise ValueError(f"raster_blocks runs on cuda or cpu, not "
                         f"{midx.device}")
    G, _, Km = midx.shape
    with_shadow = sidx is not None
    Ks = sidx.shape[-1] if with_shadow else 0
    _build.launch(name, "raster_blocks", symbol, _RASTER_ARGTYPES,
                  midx.device, midx.data_ptr(), mvals.data_ptr(),
                  sidx.data_ptr() if with_shadow else None,
                  svals.data_ptr() if with_shadow else None,
                  out.data_ptr(), G, Km, Ks, size, int(with_shadow),
                  _num_sms(midx.device.index))
    return out


def raster_blocks(midx, mvals, sidx=None, svals=None, size: int = 60):
    """All per-cell sums of the 12/15-channel grasp images of G hands.

    The port of gpd_tpu's Pallas kernel ``_raster_blocks_pallas``
    (gpd_tpu/ops/images.py:204). For each hand and projection, the sum over
    the hand's points of row one-hot x value x column one-hot:

      midx: (G, 4, Km) int32 [rows_u, rows_w, cols_v, cols_u], sentinel=size;
      mvals: (G, 6, Km) bfloat16 [|n|x, |n|y, |n|z, u, v, w], pre-masked;
      sidx/svals: (G, 4, Ks) / (G, 3, Ks) [u, v, w] shadow points, or None.

    Returns (G, NB, R, R) float32, NB = 15 (+ 6 with shadows), R =
    raster_rows(size): per projection [ax, ay, az, depth, count], then the
    shadow [depth, count] pairs; depth_P0 = w, depth_P1 = u, depth_P2 = v.
    Rows and columns >= size are zero.

    CUDA tensors launch the kernel in csrc/raster_blocks.cu (built at first
    use; its header notes the bound on the H100 and the design); CPU
    tensors take ``raster_blocks_ref``. ``make_images`` takes
    ``raster_images`` instead.
    """
    _check_operands(midx, mvals, sidx, svals, size)
    if midx.device.type == "cpu":
        return raster_blocks_ref(midx, mvals, sidx, svals, size)
    out = torch.empty((midx.shape[0], 15 if sidx is None else 21,
                       raster_rows(size), raster_rows(size)),
                      dtype=torch.float32, device=midx.device)
    return _launch_blocks("raster_blocks", "raster_blocks_launch", out, midx,
                          mvals, sidx, svals, size)


def raster_images(midx, mvals, sidx=None, svals=None, size: int = 60):
    """The finished 12/15-channel grasp images of G hands, in one launch:
    ``_raster_finish(raster_blocks(...))`` with the operands of
    ``raster_blocks``.

    Returns (G, C, size, size) uint8, C = 15 with shadow operands, else 12:
    per projection the three dilated mean |n| channels (one minmax), the
    dilated depth image, and at 15 channels the dilated shadow image.

    CUDA tensors launch csrc/raster_blocks.cu's images kernel: the same
    sums, each hand's planes finished in shared memory, only the uint8
    images written; from the same f32 sums its bytes are
    ``_raster_finish``'s (the sums' atomics add in a run-dependent order).
    CPU tensors take ``_raster_finish(raster_blocks_ref(...))``.
    """
    _check_operands(midx, mvals, sidx, svals, size)
    num_channels = 12 if sidx is None else 15
    if midx.device.type == "cpu":
        return _raster_finish(raster_blocks_ref(midx, mvals, sidx, svals,
                                                size), size, num_channels)
    out = torch.empty((midx.shape[0], num_channels, size, size),
                      dtype=torch.uint8, device=midx.device)
    return _launch_blocks("raster_images", "raster_images_launch", out, midx,
                          mvals, sidx, svals, size)


def raster_sums_ref(rows, cols, aug, size: int):
    """Plain PyTorch version of ``raster_sums``: ``index_add_`` of the
    in-image entries on flat cells."""
    G, K, Cp = aug.shape
    ok = (rows >= 0) & (rows < size) & (cols >= 0) & (cols < size)
    g = torch.arange(G, device=rows.device)[:, None].expand(G, K)
    flat = (g * size + rows.long()) * size + cols.long()
    out = torch.zeros((G * size * size, Cp), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, flat[ok], aug[ok])
    return out.reshape(G, size, size, Cp)


def raster_sums2_ref(rows_a, rows_b, cols, aug, size: int):
    """Plain PyTorch version of ``raster_sums2``: ``raster_sums_ref`` once
    per row set."""
    return torch.stack([raster_sums_ref(rows_a, cols, aug, size),
                        raster_sums_ref(rows_b, cols, aug, size)], dim=1)


def _check_sums_operands(row_sets, cols, aug, size: int):
    G, K = cols.shape
    for t in (*row_sets, cols):
        if t.shape != (G, K) or t.dtype != torch.int32:
            raise ValueError(f"row and column indices must be ({G}, {K}) "
                             f"int32, got {tuple(t.shape)} {t.dtype}")
    if (aug.dim() != 3 or aug.shape[:2] != (G, K) or aug.shape[2] < 1
            or aug.dtype != torch.float32):
        raise ValueError(f"aug must be ({G}, {K}, Cp) float32, got "
                         f"{tuple(aug.shape)} {aug.dtype}")
    tensors = [*row_sets, cols, aug]
    if any(t.device != cols.device for t in tensors):
        raise ValueError("raster operands must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("raster operands must be contiguous")
    # One hand's histogram set must fit in a block's shared memory. For
    # Cp <= 8 the kernel keeps one hand's histogram against one row set per
    # work item, in two buffers where two fit (2 x 57.6 KB at size 60 and
    # Cp = 4; with two row sets always, 2 x 86.4 KB at Cp = 6), so one
    # item's bulk store drains while the next is summed; for Cp > 8 it keeps
    # the whole set, one histogram per row set.
    if len(row_sets) * size * size * aug.shape[2] * 4 > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"{len(row_sets)} histogram(s) of {size}x{size}x"
                         f"{aug.shape[2]} need more shared memory than a "
                         "block has")


_SUMS_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5


def _launch_sums(name: str, row_sets, cols, aug, size: int):
    """Runs csrc/raster_sums.cu on one or two row sets, a launch of the
    wrapper ``name``; returns its (G, size, size, Cp) or (G, 2, size, size,
    Cp) output."""
    if cols.device.type != "cuda":
        raise ValueError(f"raster_sums runs on cuda or cpu, not "
                         f"{cols.device}")
    G, K, Cp = aug.shape
    two = len(row_sets) == 2
    out = torch.empty((G, 2, size, size, Cp) if two else (G, size, size, Cp),
                      dtype=torch.float32, device=cols.device)
    _build.launch(name, "raster_sums", "raster_sums_launch", _SUMS_ARGTYPES,
                  cols.device, row_sets[0].data_ptr(),
                  row_sets[1].data_ptr() if two else None, cols.data_ptr(),
                  aug.data_ptr(), out.data_ptr(), G, K, Cp, size,
                  _num_sms(cols.device.index))
    return out


def raster_sums(rows, cols, aug, size: int):
    """Per-cell sums of one projection for G hands (a 2-D histogram each).

    The port of gpd_tpu's Pallas kernel ``_raster_sums_pallas``
    (gpd_tpu/ops/images.py:53):

      rows/cols: (G, K) int32 cell indices; an entry with a row or column
        outside [0, size) adds nothing (callers put ``size`` there);
      aug: (G, K, Cp) float32 values, pre-masked, the count last.

    Returns (G, size, size, Cp) float32 sums.

    CUDA tensors launch the kernel in csrc/raster_sums.cu (built at first
    use; its header notes the bound on the H100 and the design); CPU
    tensors take ``raster_sums_ref``.
    """
    _check_sums_operands((rows,), cols, aug, size)
    if cols.device.type == "cpu":
        return raster_sums_ref(rows, cols, aug, size)
    return _launch_sums("raster_sums", (rows,), cols, aug, size)


def raster_sums2(rows_a, rows_b, cols, aug, size: int):
    """Two histograms per hand that share the column indices and values:
    the port of ``_raster_sums_pallas2`` (gpd_tpu/ops/images.py:136), as the
    two-row-set mode of csrc/raster_sums.cu (each hand's two histograms are
    two work items of its persistent kernel). Returns (G, 2, size, size,
    Cp) float32: [:, 0] against ``rows_a``, [:, 1] against ``rows_b``. No
    detection path calls it (nor gpd_tpu's). CPU tensors take
    ``raster_sums2_ref``."""
    _check_sums_operands((rows_a, rows_b), cols, aug, size)
    if cols.device.type == "cpu":
        return raster_sums2_ref(rows_a, rows_b, cols, aug, size)
    return _launch_sums("raster_sums2", (rows_a, rows_b), cols, aug, size)


def _cells(c0, c1, size: int):
    """findCellIndices (image_strategy.cpp:92-102) with the row flip applied
    at write time (row = size-1 - cell(c0), col = cell(c1)). Returns the
    (row, col) int32 pair."""
    return (size - 1) - _cell_coord(c0, size), _cell_coord(c1, size)


def scatter_mean(rows, cols, mask, values, size: int):
    """Masked per-cell mean of ``values`` (G, K, C) over the cells
    (rows, cols) (G, K): gpd_tpu's ``_scatter_mean`` (images.py:501).
    Returns (mean (G, size, size, C), counts (G, size, size))."""
    m = mask.to(torch.float32)[..., None]
    rows = torch.where(mask, rows, size).to(torch.int32).contiguous()
    cols = torch.where(mask, cols, size).to(torch.int32).contiguous()
    aug = torch.cat([values * m, m], dim=-1).contiguous()
    out = raster_sums(rows, cols, aug, size)
    cnt = out[..., -1]
    return out[..., :-1] / torch.clamp(cnt, min=1.0)[..., None], cnt


def _raster_p0(u, v, w, inside, absn, size: int, num_channels: int):
    """The 1- and 3-channel images from projection P0 (rows u, columns v,
    depth w; images.py:711-736): 3 channels are the dilated mean |n| with a
    joint minmax, 1 channel the dilated depth image 1 - mean w. Inputs are
    channel-major (G, K) rows and absn (G, 3, K). Returns (G, C, size,
    size) uint8."""
    rows, cols = _cells(u, v, size)
    if num_channels == 3:
        mean, _ = scatter_mean(rows, cols, inside, absn.transpose(1, 2), size)
        return _minmax_u8(_dilate3(mean.permute(0, 3, 1, 2)))
    mean, cnt = scatter_mean(rows, cols, inside, w[..., None], size)
    dimg = torch.where(cnt > 0, 1.0 - mean[..., 0], 0.0)
    return _minmax_u8(_dilate3(dimg[:, None]))


def _raster_finish(blocks, size: int, num_channels: int):
    """Channel assembly from the per-cell sums (G, NB, R, R): per
    projection the dilated mean |n| (3 channels, joint minmax), the dilated
    depth image 1 - mean depth, and with 15 channels the dilated shadow
    image max - mean shadow depth. Returns (G, C, size, size) uint8."""
    nb = blocks[:, :, :size, :size]
    chans = []
    for pi in range(3):
        b = 5 * pi
        cnt = nb[:, b + 4:b + 5]
        mean = nb[:, b:b + 4] / torch.clamp(cnt, min=1.0)
        chans.append(_minmax_u8(_dilate3(mean[:, 0:3])))
        dimg = torch.where(cnt > 0, 1.0 - mean[:, 3:4], 0.0)
        chans.append(_minmax_u8(_dilate3(dimg)))
        if num_channels == 15:
            scnt = nb[:, 16 + 2 * pi]
            smean = nb[:, 15 + 2 * pi] / torch.clamp(scnt, min=1.0)
            nonzero = scnt > 0
            mx = torch.amax(torch.where(nonzero, smean, -torch.inf),
                            dim=(1, 2), keepdim=True)
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
            simg = torch.where(nonzero, mx - smean, 0.0)[:, None]
            chans.append(_minmax_u8(_dilate3(simg)))
    return torch.cat(chans, dim=1)


def make_images(nn_pts, nn_nrm, nn_valid, hand_R, hand_sample, hand_bottom,
                hand_center, hand_valid, image: ImageGeometry,
                shadow_pts: Optional[torch.Tensor] = None,
                shadow_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grasp images for a flat batch of G hands.

    Args:
      nn_pts/nn_nrm/nn_valid: (G, K, 3)/(G, K, 3)/(G, K) per-hand
        world-frame neighborhoods, or (N, 3)/(N, 3) with (G, N) valid for a
        neighborhood shared by every hand (the whole cloud, masked).
      hand_R: (G, 3, 3); hand_sample: (G, 3); hand_bottom/center: (G,).
      shadow_pts/shadow_valid: (G, Ks, 3)/(G, Ks) world-frame occluded
        points (15 channels only).

    12 and 15 channels take ``raster_images``, 1 and 3 ``raster_sums``.
    Returns (G, size, size, C) uint8, a channels-last view of channel-major
    storage.
    """
    if image.num_channels not in (1, 3, 12, 15):
        raise ValueError(f"{image.num_channels}-channel images do not exist "
                         "(1, 3, 12 or 15)")
    size = image.size
    if nn_pts.dim() == 2:
        # Shared neighborhood: R^T (p - s) = R^T p - R^T s rotates the cloud
        # once per hand without a per-hand copy of the (N, 3) arrays.
        pts_cm = torch.einsum("kj,gji->gik", nn_pts, hand_R)
        t = torch.einsum("gj,gji->gi", hand_sample, hand_R)
        pts_cm = pts_cm - t[:, :, None]
        nrm_cm = torch.einsum("kj,gji->gik", nn_nrm, hand_R)
    else:
        rel = nn_pts - hand_sample[:, None, :]
        pts_cm = torch.einsum("gkj,gji->gik", rel, hand_R)
        nrm_cm = torch.einsum("gkj,gji->gik", nn_nrm, hand_R)
    u, v, w, ins = _unit_transform_cm(pts_cm[:, 0], pts_cm[:, 1], pts_cm[:, 2],
                                      hand_bottom, hand_center, image)
    ins = ins & nn_valid & hand_valid[:, None]
    absn = torch.abs(nrm_cm)
    if image.num_channels in (1, 3):
        return _raster_p0(u, v, w, ins, absn, size,
                          image.num_channels).permute(0, 2, 3, 1)
    midx, mvals = _cm_operands(u, v, w, ins, [absn[:, 0], absn[:, 1],
                                              absn[:, 2]], size)
    sidx = svals = None
    if image.num_channels == 15:
        srel = shadow_pts - hand_sample[:, None, :]
        sh_cm = torch.einsum("gkj,gji->gik", srel, hand_R)
        su, sv, sw, sins = _unit_transform_cm(sh_cm[:, 0], sh_cm[:, 1],
                                              sh_cm[:, 2], hand_bottom,
                                              hand_center, image)
        sins = sins & shadow_valid & hand_valid[:, None]
        sidx, svals = _cm_operands(su, sv, sw, sins, [], size)
    return raster_images(midx, mvals, sidx, svals, size).permute(0, 2, 3, 1)
