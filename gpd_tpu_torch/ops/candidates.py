"""Grasp-candidate search: the geometric core (port of
gpd_tpu/ops/candidates.py:40-419).

The reference's hot loop (src/gpd/candidate/hand_search.cpp:144-188,
hand_set.cpp:31-116, finger_hand.cpp, antipodal.cpp:10-96) as masked tensor
work over the (orientation x sample x neighborhood) grid:

  - evaluateFingers's "back-of-hand collision => abort" is a min-x test,
  - deepenHand's break-on-first-failure scan collapses to a count of the
    depths below the first collision (the same depths as the C++ double
    accumulation loop, ``HandGeometry.deepen_depths``),
  - the antipodal force-closure test is elementwise math + reductions.

On the card the orientation pass is one hand-written CUDA kernel,
``hand_search`` (csrc/hand_search.cu), over every sample in one launch; its
plain version is ``_eval_orientations``, which the CPU runs with samples in
blocks whose (M, B, K) working tensors stay under ``_BLOCK_ELEMS``, skipping
blocks that hold no sample with a valid frame.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gpd_tpu_torch import constant
from gpd_tpu_torch.config import DetectorConfig, HandGeometry
from gpd_tpu_torch.core.types import Grasps
from gpd_tpu_torch.ops import _build
from gpd_tpu_torch.ops.frames import estimate_frames
from gpd_tpu_torch.ops.neighbors import radius_mask, radius_neighbors

_NEG = -1e9
_POS = 1e9

# Per-sample-block working-set budget for the hand search, in f32 elements
# of one (M, B, K) tensor (~270 MB).
_BLOCK_ELEMS = 1 << 26

# Members of one sample's neighbourhood that a block of the hand-search
# kernel holds in shared memory (16 B each: 96 KB, two blocks an SM); a
# larger neighbourhood is swept in tiles of this many.
HAND_TILE = 6144


def _ceil128(n: int) -> int:
    return -(-n // 128) * 128


def finger_spacing(hand: HandGeometry, num_placements: int) -> np.ndarray:
    """Finger placement offsets (finger_hand.cpp:12-18): 2P values, first P
    left-finger slab starts, last P right-finger slab starts."""
    fs_half = np.linspace(0.0, hand.outer_diameter - hand.finger_width,
                          num_placements)
    left = fs_half - hand.outer_diameter + hand.finger_width
    return np.concatenate([left, fs_half]).astype(np.float32)


def rotation_grid(angles: Sequence[float], hand_axes: Sequence[int]) -> np.ndarray:
    """Static per-(axis, orientation) rotations: RotY(pi) @ AngleAxis(angle,
    e_axis) (hand_set.cpp:49-73). Full hand frame = local_frame @ this."""
    rot_binormal = np.array([[-1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0]])
    mats = []
    for ax in hand_axes:
        for ang in angles:
            c, s = math.cos(ang), math.sin(ang)
            if ax == 0:
                R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
            elif ax == 1:
                R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            else:
                R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            mats.append(rot_binormal @ R)
    return np.stack(mats).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static parameters of the hand search."""

    finger_width: float
    outer_diameter: float
    hand_depth: float
    hand_height: float
    init_bite: float
    num_placements: int
    deepen_hand: bool
    friction_cos: float
    min_viable: int
    depths: Tuple[float, ...]
    spacing: Tuple[float, ...]

    @staticmethod
    def from_config(cfg: DetectorConfig) -> "SearchParams":
        hg = cfg.hand_geometry
        return SearchParams(
            finger_width=hg.finger_width,
            outer_diameter=hg.outer_diameter,
            hand_depth=hg.depth,
            hand_height=hg.height,
            init_bite=hg.init_bite,
            num_placements=cfg.num_finger_placements,
            deepen_hand=cfg.deepen_hand,
            friction_cos=math.cos(cfg.friction_coeff * math.pi / 180.0),
            min_viable=cfg.min_viable,
            depths=tuple(hg.deepen_depths()),
            spacing=tuple(finger_spacing(hg, cfg.num_finger_placements).tolist()),
        )


def _masked_min(x, m, dim=-1):
    return torch.amin(torch.where(m, x, _POS), dim=dim)


def _masked_max(x, m, dim=-1):
    return torch.amax(torch.where(m, x, _NEG), dim=dim)


def _placement_minima(x, y, hcrop, p: SearchParams):
    """Sufficient statistics for every bite test (finger_hand.cpp:26-73):
    the min hand-frame x over the height-cropped points (..., ), and over
    those inside each of the 2P finger slabs (..., 2P). One slab at a time,
    so no (..., 2P, K) tensor is ever held."""
    minx_all = _masked_min(x, hcrop)
    lo = np.asarray(p.spacing, np.float32)
    hi = lo + np.float32(p.finger_width)
    minx_slab = torch.stack(
        [_masked_min(x, hcrop & (y > float(a)) & (y < float(b)))
         for a, b in zip(lo, hi)], dim=-1)
    return minx_all, minx_slab


def _placements_at_bite(minx_all, minx_slab, bite: float, p: SearchParams):
    """fingers (..., 2P) at a given bite from the min-x statistics:
    any_crop = exists x < bite; abort = exists x < bite - depth;
    collision(p) = exists slab-p point with x < bite."""
    any_crop = minx_all < bite
    abort = minx_all < bite - p.hand_depth
    coll = minx_slab < bite
    return (any_crop & ~abort)[..., None] & ~coll


def _middle_placement(hand_ok):
    """chooseMiddleHand (finger_hand.cpp:89-105): index
    hand_idx[ceil(n/2)-1] of the valid placements."""
    cnt = torch.sum(hand_ok, dim=-1)
    target = (cnt + 1) // 2
    cs = torch.cumsum(hand_ok.to(torch.int64), dim=-1)
    sel = hand_ok & (cs == target[..., None])
    return torch.argmax(sel.to(torch.int32), dim=-1)


def _antipodal_label(x, y, z, ny, closing, p: SearchParams):
    """Antipodal::evaluateGrasp on the closing-region points
    (antipodal.cpp:10-96): lateral=y, forward=x, vertical=z; hand-frame
    normals; l=(0,-1,0), r=(0,1,0). Returns (full, half)."""
    any_close = torch.any(closing, dim=-1)
    min_y = _masked_min(y, closing) + 0.003
    max_y = _masked_max(y, closing) - 0.003
    left = closing & ((-ny) > p.friction_cos) & (y < min_y[..., None])
    right = closing & (ny > p.friction_cos) & (y > max_y[..., None])
    any_l = torch.any(left, dim=-1)
    any_r = torch.any(right, dim=-1)
    half = any_l | any_r

    top_x = torch.minimum(_masked_max(x, left), _masked_max(x, right))
    bot_x = torch.maximum(_masked_min(x, left), _masked_min(x, right))
    top_z = torch.minimum(_masked_max(z, left), _masked_max(z, right))
    bot_z = torch.maximum(_masked_min(z, left), _masked_min(z, right))
    in_box = (x >= bot_x[..., None]) & (x <= top_x[..., None]) & \
             (z >= bot_z[..., None]) & (z <= top_z[..., None])
    nl = torch.sum(left & in_box, dim=-1)
    nr = torch.sum(right & in_box, dim=-1)
    full = any_l & any_r & (nl >= p.min_viable) & (nr >= p.min_viable)
    return full, half & any_close


def _eval_orientations(rel, nrm, nvalid, frames, rfix, p: SearchParams):
    """Evaluate every (axis, orientation) slot for a block of samples
    (hand_set.cpp:49-116 + finger_hand.cpp + antipodal labeling).

    rel: (S, K, 3) neighbor offsets from the sample; nrm: (S, K, 3) normals;
    nvalid: (S, K); frames: (S, 3, 3); rfix: (M, 3, 3) static rotations.
    deepenHand's scan in closed form: the hand stays collision-free up to
    depth Dmax = min(minx_slab_l, minx_slab_r, minx_all + depth) and needs a
    cropped point at the first step (d0 > minx_all).
    """
    R = torch.einsum("sij,mjk->msik", frames, rfix)        # (M, S, 3, 3)
    pts = torch.einsum("skj,msji->mski", rel, R)           # hand-frame points
    ny = torch.einsum("skj,msj->msk", nrm, R[..., :, 1])   # hand-frame n_y
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]

    hcrop = nvalid[None] & (z > -p.hand_height) & (z < p.hand_height)
    P = p.num_placements
    fs = constant(p.spacing, rel.device)
    fw = float(np.float32(p.finger_width))

    minx_all, minx_slab = _placement_minima(x, y, hcrop, p)
    fingers = _placements_at_bite(minx_all, minx_slab, p.init_bite, p)
    hand_ok = fingers[..., :P] & fingers[..., P:]          # (M, S, P)
    valid0 = torch.any(hand_ok, dim=-1)
    mid = _middle_placement(hand_ok)                       # (M, S)

    minx_l = torch.gather(minx_slab, -1, mid[..., None])[..., 0]
    minx_r = torch.gather(minx_slab, -1, (mid + P)[..., None])[..., 0]
    fs_l = fs[mid]
    fs_r = fs[mid + P]

    if p.deepen_hand and len(p.depths) > 0:
        # deepenHand (finger_hand.cpp:107-139): the survivor count of the
        # cumulative-AND is #{depths <= Dmax}, gated on the first step.
        depths = constant(p.depths, rel.device)
        dmax = torch.minimum(torch.minimum(minx_l, minx_r),
                             minx_all + p.hand_depth)
        first_ok = depths[0] > minx_all
        n_alive = torch.where(
            first_ok, torch.sum(depths[:, None, None] <= dmax[None], dim=0), 0)
        top = torch.where(n_alive > 0, depths[torch.clamp(n_alive - 1, min=0)],
                          p.init_bite)
    else:
        top = torch.full(x.shape[:2], p.init_bite, dtype=torch.float32,
                         device=rel.device)

    bottom = top - p.hand_depth
    left = fs_l + fw
    right = fs_r
    center = 0.5 * (left + right)

    closing = hcrop & (x > bottom[..., None]) & (x < top[..., None]) & \
        (y > left[..., None]) & (y < right[..., None])
    valid = valid0 & torch.any(closing, dim=-1)

    width = _masked_max(y, closing) - _masked_min(y, closing)
    width = torch.where(valid, width, 0.0)

    full, half = _antipodal_label(x, y, z, ny, closing, p)

    # Hand pose (hand.cpp:41-45): position = frame * [bottom, center, 0] + s.
    pos_local = torch.stack([bottom, center, torch.zeros_like(bottom)], dim=-1)
    pos_world = torch.einsum("msij,msj->msi", R, pos_local)

    return dict(R=R, pos=pos_world, top=top, bottom=bottom, center=center,
                width=width, mid=mid, valid=valid,
                full=full & valid, half=half & valid)


@functools.lru_cache(maxsize=None)
def _kernel_geometry(p: SearchParams) -> np.ndarray:
    """The hand-search kernel's host array of parameters, each rounded to
    float32 as PyTorch rounds a Python scalar against a float32 tensor:
    hand height, init_bite, init_bite - depth, depth, finger width,
    friction cosine, the antipodal margin, the 2P slab starts (the finger
    spacing), the 2P slab ends (start + width in float32) and the deepening
    depths (none when deepen_hand is off)."""
    lo = np.asarray(p.spacing, np.float32)
    hi = lo + np.float32(p.finger_width)
    depths = p.depths if p.deepen_hand else ()
    head = [p.hand_height, p.init_bite, p.init_bite - p.hand_depth,
            p.hand_depth, p.finger_width, p.friction_cos, 0.003]
    return np.concatenate([np.asarray(head, np.float32), lo, hi,
                           np.asarray(depths, np.float32)])


_HAND_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p] + [ctypes.c_int] * 3)


def _check_search_operands(points, normals, sample_pos, frames, rfix, member,
                           idx, params: SearchParams):
    N, S, M = points.shape[0], sample_pos.shape[0], rfix.shape[0]
    want = {"points": (points, (N, 3)), "normals": (normals, (N, 3)),
            "sample_pos": (sample_pos, (S, 3)), "frames": (frames, (S, 3, 3)),
            "rfix": (rfix, (M, 3, 3))}
    for name, (t, shape) in want.items():
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if member.dtype != torch.bool or member.dim() != 2 or \
            member.shape[0] != S:
        raise ValueError(f"member must be bool ({S}, L), got {member.dtype} "
                         f"{tuple(member.shape)}")
    tensors = [points, normals, sample_pos, frames, rfix, member]
    if idx is None:
        if member.shape[1] != N:
            raise ValueError(f"identity rows cover the cloud: member must be "
                             f"({S}, {N}), got {tuple(member.shape)}")
    else:
        if idx.dtype != torch.int64 or idx.shape != member.shape:
            raise ValueError(f"idx must be int64 {tuple(member.shape)}, got "
                             f"{idx.dtype} {tuple(idx.shape)}")
        tensors.append(idx)
    if any(t.device != points.device for t in tensors):
        raise ValueError("hand search operands must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hand search operands must be contiguous")
    if not 1 <= params.num_placements <= 32:
        raise ValueError(f"the hand search kernel takes 1-32 finger "
                         f"placements, not {params.num_placements}")
    if params.deepen_hand and len(params.depths) > 64:
        raise ValueError(f"the hand search kernel takes at most 64 "
                         f"deepening depths, not {len(params.depths)}")


def hand_search(points, normals, sample_pos, frames, rfix, member, idx,
                params: SearchParams):
    """Every (axis, orientation) hand of S samples over their radius
    neighbourhoods: ``_eval_orientations``' outputs, (M, S, ...), and each
    sample's member count (S,) int32.

    points, normals: (N, 3) float32; sample_pos: (S, 3); frames: (S, 3, 3);
    rfix: (M, 3, 3); member: (S, L) bool, the in-radius mask of each
    sample's neighbour row (``radius_mask`` or ``radius_neighbors``'
    valid); idx: (S, L) int64 point indices of those rows, or None for
    identity rows (L = N, entry j is point j).

    CUDA tensors launch the kernel in csrc/hand_search.cu (built at first
    use; its header notes the bound on the H100 and the design), one launch
    for every sample; CPU tensors take ``_eval_orientations``, the plain
    version.
    """
    _check_search_operands(points, normals, sample_pos, frames, rfix, member,
                           idx, params)
    if points.device.type == "cpu":
        if idx is None:
            rel = points[None, :, :] - sample_pos[:, None, :]
            nrm = normals[None, :, :].expand(rel.shape)
        else:
            rel = points[idx] - sample_pos[:, None, :]
            nrm = normals[idx]
        return (_eval_orientations(rel, nrm, member, frames, rfix, params),
                member.sum(dim=-1, dtype=torch.int32))
    if points.device.type != "cuda":
        raise ValueError(f"hand_search runs on cuda or cpu, not "
                         f"{points.device}")
    S, M, L = sample_pos.shape[0], rfix.shape[0], member.shape[1]
    dev = points.device

    def new(*shape, dtype=torch.float32):
        return torch.empty((M, S) + shape, dtype=dtype, device=dev)
    out = dict(R=new(3, 3), pos=new(3), top=new(), bottom=new(),
               center=new(), width=new(), mid=new(dtype=torch.int64),
               valid=new(dtype=torch.bool), full=new(dtype=torch.bool),
               half=new(dtype=torch.bool))
    members = torch.empty(S, dtype=torch.int32, device=dev)
    geom = _kernel_geometry(params)
    depths = len(params.depths) if params.deepen_hand else 0
    _build.launch("hand_search", "hand_search", "hand_search_launch",
                  _HAND_ARGTYPES, dev, points.data_ptr(), normals.data_ptr(),
                  sample_pos.data_ptr(), frames.data_ptr(), rfix.data_ptr(),
                  member.data_ptr(), None if idx is None else idx.data_ptr(),
                  *(out[k].data_ptr() for k in ("R", "pos", "top", "bottom",
                                                 "center", "width", "mid",
                                                 "valid", "full", "half")),
                  members.data_ptr(), S, M, L, max(1, min(L, HAND_TILE)),
                  geom.ctypes.data, params.num_placements, depths,
                  params.min_viable)
    return out, members


def _search_neighbors(sample_pos, frame_valid, points, pmask, radius: float,
                      k: int):
    """(member, idx) rows of the hand search: with a cap covering the cloud
    the in-radius mask of the whole cloud (identity rows, idx None), else
    the exact nearest k with their in-radius flags."""
    if k >= points.shape[0]:
        member, _ = radius_mask(sample_pos, frame_valid, points, pmask, radius)
        return member, None
    idx, member = radius_neighbors(sample_pos, frame_valid, points, pmask,
                                   radius=radius, k=k, exact=True)
    return member.contiguous(), idx.contiguous()


def _search_kernel(points, normals, pmask, sample_pos, frames, frame_valid,
                   radius: float, rfix, params: SearchParams, k: int,
                   host_reads: bool = True):
    """The hand search's outputs, (M, S, ...) as ``_eval_orientations``',
    and ``members``, each sample's neighbourhood size (S,) int32. On the
    card one ``hand_search`` launch over every sample (no host read); on
    the CPU in sample blocks."""
    S = sample_pos.shape[0]
    M = rfix.shape[0]

    def eval_block(spos_b, fval_b, frames_b):
        member, idx = _search_neighbors(spos_b, fval_b, points, pmask,
                                        radius, k)
        out, members = hand_search(points, normals, spos_b, frames_b, rfix,
                                   member, idx, params)
        return dict(out, members=members)

    # Sample blocks keep each (M, B, K) working tensor under _BLOCK_ELEMS;
    # for very large K the block shrinks toward 8 rows, so the uncapped
    # identity search runs at any cloud size.
    budget = _BLOCK_ELEMS // max(M * k, 1)
    if budget >= 128:
        blk = max(128, min(_ceil128(S), budget & ~127))
    else:
        blk = max(8, budget & ~7)
    if S <= blk or points.device.type != "cpu":
        return eval_block(sample_pos, frame_valid, frames)

    # Valid-first sample order; blocks past the valid count hold no valid
    # frame and are skipped (their slots stay zero and invalid). One host
    # read of the count decides how many blocks run; without host reads
    # (under CUDA graph capture) every block runs, its invalid frames
    # masked.
    order = torch.argsort(~frame_valid, stable=True)
    n_valid = max(int(frame_valid.sum()), 1) if host_reads else S
    parts = [eval_block(sample_pos[sl], frame_valid[sl], frames[sl])
             for sl in (order[b:b + blk] for b in range(0, n_valid, blk))]
    out = {}
    for key in parts[0]:
        dim = 0 if key == "members" else 1
        live = torch.cat([pt[key] for pt in parts], dim=dim)
        full = live.new_zeros(live.shape[:dim] + (S,) + live.shape[dim + 1:])
        full.index_copy_(dim, order[:live.shape[dim]], live)
        out[key] = full
    return out


def search_hands(cloud, sample_pos: torch.Tensor, sample_mask: torch.Tensor,
                 cfg: DetectorConfig) -> Grasps:
    """Full candidate search: local frames at the samples, then
    ``search_hands_with_frames`` (gpd_tpu/ops/candidates.py:367-380).
    Returns a flat Grasps batch of S * num_axes * num_orientations,
    sample-major then (axis, orientation): the reference's HandSet order
    (hand_set.cpp:31-47)."""
    frames, fvalid = estimate_frames(
        sample_pos, sample_mask, cloud.points, cloud.mask, cloud.normals,
        radius=cfg.nn_radius_frames)
    return search_hands_with_frames(cloud, sample_pos, frames, fvalid, cfg)


def search_hands_with_frames(cloud, sample_pos, frames, fvalid,
                             cfg: DetectorConfig,
                             host_reads: bool = True,
                             stats: Optional[dict] = None) -> Grasps:
    """Hand search at given local frames. Returns a flat Grasps batch of
    S * num_axes * num_orientations, sample-major then (axis, orientation):
    the reference's HandSet order (hand_set.cpp:31-47). ``host_reads=False``
    runs every sample block, with no read of the valid-frame count. A
    ``stats`` dict gets ``hand_neighbors_max``, the largest neighbourhood
    searched, as a 0-dim int64 tensor on the device (no host read)."""
    params = SearchParams.from_config(cfg)
    rgrid = constant(rotation_grid(cfg.angles, cfg.hand_axes),
                     sample_pos.device)
    out = _search_kernel(cloud.points, cloud.normals, cloud.mask,
                         sample_pos, frames, fvalid, cfg.hand_search_radius,
                         rgrid, params, cfg.search_neighbors_cap,
                         host_reads)

    S = sample_pos.shape[0]
    M = rgrid.shape[0]
    if stats is not None:
        stats["hand_neighbors_max"] = torch.cat(
            [out["members"], out["members"].new_zeros(1)]).max().long()

    def flat(a):
        # (M, S, ...) -> (S, M, ...) -> (S*M, ...)
        return a.transpose(0, 1).reshape((S * M,) + a.shape[2:])

    sample_rep = torch.repeat_interleave(sample_pos, M, dim=0)
    return Grasps(
        position=flat(out["pos"]) + sample_rep,
        orientation=flat(out["R"]),
        sample=sample_rep,
        width=flat(out["width"]),
        score=torch.zeros(S * M, device=sample_pos.device),
        bottom=flat(out["bottom"]),
        top=flat(out["top"]),
        center=flat(out["center"]),
        finger_placement=flat(out["mid"]),
        full_antipodal=flat(out["full"]),
        half_antipodal=flat(out["half"]),
        valid=flat(out["valid"]),
        sample_id=torch.repeat_interleave(
            torch.arange(S, device=sample_pos.device), M),
    )


def _reevaluate_block(points, normals, pmask, g_sample, g_R, g_top, g_mid,
                      g_valid, radius: float, params: SearchParams, k: int):
    """HandSearch::reevaluateHypotheses (hand_search.cpp:66-134,190-228) on
    one block of grasps: each stored hand re-checked against a (ground-
    truth) cloud at its stored finger placement and top depth, over the
    exact radius neighbourhood (a dropped contact point would flip a
    label). Returns (full, half) antipodal flags."""
    idx, nvalid = radius_neighbors(g_sample, g_valid, points, pmask,
                                   radius=radius, k=k, exact=True)
    rel = points[idx] - g_sample[:, None, :]
    pts = torch.einsum("gkj,gji->gki", rel, g_R)
    ny = torch.einsum("gkj,gj->gk", normals[idx], g_R[..., :, 1])
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    hcrop = nvalid & (z > -params.hand_height) & (z < params.hand_height)

    fs = constant(params.spacing, x.device)
    fw = float(np.float32(params.finger_width))
    P = params.num_placements
    bite = g_top
    fs_l = fs[g_mid]
    fs_r = fs[g_mid + P]

    crop = hcrop & (x < bite[:, None])
    abort = torch.any(hcrop & (x < (bite - params.hand_depth)[:, None]),
                      dim=-1)
    any_crop = torch.any(crop, dim=-1)
    coll_l = torch.any(crop & (y > fs_l[:, None]) & (y < (fs_l + fw)[:, None]),
                       dim=-1)
    coll_r = torch.any(crop & (y > fs_r[:, None]) & (y < (fs_r + fw)[:, None]),
                       dim=-1)
    feasible = any_crop & ~abort & ~coll_l & ~coll_r & torch.any(nvalid,
                                                                 dim=-1)
    bottom = bite - params.hand_depth
    left = fs_l + fw
    right = fs_r
    closing = hcrop & (x > bottom[:, None]) & (x < bite[:, None]) & \
        (y > left[:, None]) & (y < right[:, None])
    has_close = torch.any(closing, dim=-1)

    full, half = _antipodal_label(x, y, z, ny, closing, params)
    ok = feasible & has_close & g_valid
    return ok & full, ok & half


def reevaluate_hypotheses(cloud, grasps: Grasps, cfg: DetectorConfig,
                          block: int = 512):
    """Ground-truth labels of stored grasps against ``cloud`` (the port of
    gpd_tpu/ops/candidates.py:422-502). Grasps run in blocks of ``block``,
    the last one padded with samples at 1e6 and valid=False, so the (B, K)
    neighbourhood tensors stay bounded at any mesh size and neighbour cap
    (``cfg.search_neighbors_cap``). Returns (labels (G,) int32,
    1 = full-antipodal; the Grasps with both antipodal flags replaced)."""
    params = SearchParams.from_config(cfg)
    G = grasps.capacity
    pad = -G % block if G > block else 0

    def padded(a, value=0):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], value)])

    cols = (padded(grasps.sample, 1e6), padded(grasps.orientation),
            padded(grasps.top), padded(grasps.finger_placement),
            padded(grasps.valid, False))
    parts = [_reevaluate_block(cloud.points, cloud.normals, cloud.mask,
                               *(c[b:b + block] for c in cols),
                               cfg.hand_search_radius, params,
                               cfg.search_neighbors_cap)
             for b in range(0, G + pad, block)]
    full = torch.cat([p[0] for p in parts])[:G]
    half = torch.cat([p[1] for p in parts])[:G]
    return full.to(torch.int32), dataclasses.replace(
        grasps, full_antipodal=full, half_antipodal=half)
