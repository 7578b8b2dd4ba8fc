"""A plain implementation of GPD's detection semantics, the benchmark's
reference. It is written from the reference's C++ (the hand search and
antipodal test follow a transcription of src/gpd/candidate/{hand_set,
finger_hand,antipodal,local_frame}.cpp) and from the configuration file,
and shares no code with the program: each step is the direct statement of
what it computes, batched over hands with masks, in a type chosen by the
caller (float64 to judge; the configuration's float32 for a control).

A cloud here is a ``Cloud``: the points that survive the preprocessing,
their normals, a camera bitmask per point and the camera positions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Statistical outlier removal as GPD calls PCL's (cloud.cpp:166-174).
OUTLIER_MEAN_K = 50
OUTLIER_STDDEV_MULT = 1.0
# The plane of sampleAbovePlane and of the images' plane removal
# (cloud.cpp:407-435, image_generator.cpp:101-129).
PLANE_DIST = 0.01
# Shadow points are binned into cubes of this edge (hand_set.cpp:156-160)
# and jittered by 0.3 of it (hand_set.cpp:187-206).
SHADOW_VOXEL = 0.003
# The antipodal test's extremal band (antipodal.cpp:10-96).
EXTREMAL = 0.003
# The relative change of the normals' radius that tells a point on it.
TIE_RADIUS = 1e-4
# The deepening step (finger_hand.cpp:107-139).
DEEPEN_STEP = 0.005
# Clustering's thresholds (clustering.cpp): axes within 12 degrees, within
# 5 cm, within 5 mm once the first hand's axis is projected out.
CLUSTER_COS = math.cos(12.0 * math.pi / 180.0)
CLUSTER_DIST = 0.05
CLUSTER_PROJ = 0.005
# 99% two-sided normal quantile of the cluster score's lower bound.
Z99 = 2.576


@dataclasses.dataclass
class Cloud:
    points: torch.Tensor       # (N, 3)
    normals: torch.Tensor      # (N, 3)
    cams: torch.Tensor         # (N,) int64 bitmask of the cameras
    view_points: torch.Tensor  # (V, 3)
    # How well each normal is defined: the gap between the covariance's
    # two smallest eigenvalues over its largest (the axis), and the
    # |cosine| between the normal and the direction to the camera it was
    # turned toward (the sign).
    normal_gap: Optional[torch.Tensor] = None
    facing: Optional[torch.Tensor] = None
    # The normals again over a radius a hair shorter and a hair longer
    # (``preprocess(ties=True)``): a voxel grid puts points exactly at the
    # radius, and each way of rounding them is GPD's.
    tie_normals: Tuple[torch.Tensor, ...] = ()

    def with_normals(self, normals: torch.Tensor) -> "Cloud":
        return dataclasses.replace(self, normals=normals)

    def __len__(self):
        return self.points.shape[0]


_MATMUL_DISTANCES = [False]


@contextlib.contextmanager
def matmul_distances():
    """Within the block, squared distances are |a|^2 + |b|^2 - 2 a.b, the
    cross term one matrix product, as a GPU program forms them: the form
    in which a lower matmul precision (TF32) reaches the neighbourhoods."""
    _MATMUL_DISTANCES[0] = True
    try:
        yield
    finally:
        _MATMUL_DISTANCES[0] = False


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A, B) squared distances, each as the sum of its three squared
    coordinate differences (or in ``matmul_distances``' form)."""
    if _MATMUL_DISTANCES[0]:
        return (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] \
            - 2.0 * (a @ b.T)
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def _blocks(n: int, size: int):
    for i in range(0, n, size):
        yield slice(i, min(n, i + size))


# ----------------------------------------------------------------------------
# Preprocessing (candidates_generator.cpp:14-37)


def workspace_and_voxels(points: np.ndarray, cams: np.ndarray,
                         workspace, cell: float) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """removeNans, the workspace crop (strict bounds, cloud.cpp:243-249)
    and voxelizeCloud (cloud.cpp:286-348): a point falls into the cube
    floor((p - min) / cell), computed in float32 as the reference's cloud
    holds its points; each occupied cube gives one point at its corner
    min + cube * cell, with the camera bitmask of the first point (in input
    order) that fell into it. Returns (points (M, 3) float64, cams (M,))."""
    p = np.asarray(points, np.float32).reshape(-1, 3)
    cams = np.asarray(cams, np.int64).reshape(-1)
    keep = np.isfinite(p).all(1)
    w = workspace
    with np.errstate(invalid="ignore"):
        keep &= ((p[:, 0] > w[0]) & (p[:, 0] < w[1]) & (p[:, 1] > w[2])
                 & (p[:, 1] < w[3]) & (p[:, 2] > w[4]) & (p[:, 2] < w[5]))
    p, cams = p[keep], cams[keep]
    lo = p.min(0)
    cube = np.floor((p - lo) / np.float32(cell)).astype(np.int64)
    _, first = np.unique(cube, axis=0, return_index=True)
    corner = lo.astype(np.float64) + cube[first].astype(np.float64) * \
        float(np.float32(cell))
    return corner, cams[first]


def outlier_mask(points: torch.Tensor, mean_k: int = OUTLIER_MEAN_K,
                 mult: float = OUTLIER_STDDEV_MULT) -> torch.Tensor:
    """StatisticalOutlierRemoval: a point stays when its mean distance to
    its mean_k nearest other points is at most the mean of those over the
    cloud plus mult population standard deviations."""
    mean_d = torch.empty(len(points), dtype=points.dtype,
                         device=points.device)
    for b in _blocks(len(points), 512):
        d2 = _sq_dist(points[b], points)
        d = d2.topk(mean_k + 1, dim=1, largest=False).values[:, 1:]
        mean_d[b] = d.clamp(min=0).sqrt().mean(1)
    mu = mean_d.mean()
    sd = ((mean_d - mu) ** 2).mean().sqrt()
    return mean_d <= mu + mult * sd


def _seen(cams: torch.Tensor, num: int) -> torch.Tensor:
    """(N, V) bool: camera v sees the point."""
    v = torch.arange(num, device=cams.device)
    return ((cams[:, None] >> v) & 1) > 0


def estimate_normals(points: torch.Tensor, cams: torch.Tensor,
                     view_points: torch.Tensor, radius: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NormalEstimationOMP over every point within ``radius`` (inclusive):
    the eigenvector of the smallest eigenvalue of the neighbourhood's
    covariance, turned toward the last camera that sees the point (the
    reference's per-camera loop overwrites), then reverseNormals
    (cloud.cpp:573-604): a normal that points toward no camera seeing its
    point is flipped. Returns (normals, eigenvalue gap, facing): see
    ``Cloud``."""
    out = torch.empty_like(points)
    gap = torch.empty(len(points), dtype=points.dtype, device=points.device)
    r2 = radius * radius
    for b in _blocks(len(points), 512):
        w = (_sq_dist(points[b], points) <= r2).to(points.dtype)   # (B, N)
        cnt = w.sum(1)
        mean = torch.einsum("bn,nj->bj", w, points) / cnt[:, None]
        second = torch.einsum("bn,ni,nj->bij", w, points, points) / \
            cnt[:, None, None]
        cov = second - mean[:, :, None] * mean[:, None, :]
        val, vec = torch.linalg.eigh(cov)
        out[b] = vec[:, :, 0]
        gap[b] = (val[:, 1] - val[:, 0]) / val[:, 2].clamp(min=1e-30)
    V = view_points.shape[0]
    seen = _seen(cams, V)
    last = torch.where(seen.any(1), V - 1 - seen.flip(1).int().argmax(1), 0)
    to_cam = view_points[last] - points
    out = torch.where(((out * to_cam).sum(1) < 0)[:, None], -out, out)
    toward = torch.einsum("nj,nvj->nv", out,
                          points[:, None, :] - view_points[None, :, :]) < 0
    ok = (seen & toward).any(1)
    facing = ((out * to_cam).sum(1) / to_cam.norm(dim=1).clamp(min=1e-12)
              ).abs()
    return torch.where(ok[:, None], out, -out), gap, facing


def preprocess(points: np.ndarray, cams: Optional[np.ndarray],
               view_points: np.ndarray, spec: dict, device,
               dtype=torch.float64, ties: bool = False) -> Cloud:
    """The preprocessing a configuration's ``detector`` keys ask for:
    workspace, voxels, [outliers], normals (with ``ties``, also over the
    radius times 1 -/+ TIE_RADIUS). Refinement and a flip about the origin
    are not implemented, and a configuration that asks for them is
    refused."""
    if spec["refine_normals_k"] or spec["centered_at_origin"]:
        raise NotImplementedError("normal refinement / centred clouds")
    if not spec["voxelize"]:
        raise NotImplementedError("clouds without voxels")
    n = len(points)
    cams = np.ones(n, np.int64) if cams is None else cams
    pts, cs = workspace_and_voxels(points, cams, spec["workspace"],
                                   spec["voxel_size"])
    p = torch.as_tensor(pts, dtype=dtype, device=device)
    c = torch.as_tensor(cs, device=device)
    if spec["remove_outliers"]:
        keep = outlier_mask(p)
        p, c = p[keep], c[keep]
    vp = torch.as_tensor(np.asarray(view_points, np.float64).reshape(-1, 3),
                         dtype=dtype, device=device)
    r = spec["normals_radius"]
    n, gap, facing = estimate_normals(p, c, vp, r)
    alt = tuple(estimate_normals(p, c, vp, r * f)[0]
                for f in (1 - TIE_RADIUS, 1 + TIE_RADIUS)) if ties else ()
    return Cloud(p, n, c, vp, gap, facing, alt)


def plane_distance(points: torch.Tensor, generator: torch.Generator,
                   iters: int = 1000) -> torch.Tensor:
    """|distance| of every point to the dominant plane: of ``iters`` planes
    through point triplets drawn uniformly, the one with the most points
    within PLANE_DIST (SACSegmentation's RANSAC with its threshold)."""
    n = len(points)
    tri = torch.randint(0, n, (iters, 3), generator=generator,
                        device=generator.device).to(points.device)
    a, b, c = (points[tri[:, i]] for i in range(3))
    nv = torch.linalg.cross(b - a, c - a)
    ln = nv.norm(dim=1, keepdim=True)
    nv = nv / ln.clamp(min=1e-12)
    d = -(nv * a).sum(1)
    dist = (points @ nv.T + d[None, :]).abs()                   # (N, iters)
    score = (dist <= PLANE_DIST).sum(0)
    score = torch.where(ln[:, 0] < 1e-9, -1, score)
    return dist[:, int(score.argmax())]


# ----------------------------------------------------------------------------
# Local frames and hand poses (frame_estimator.cpp, local_frame.cpp,
# hand_set.cpp:49-73)


def local_frames(samples: torch.Tensor, cloud: Cloud, radius: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """At each sample, M = sum of n n^T over the normals within ``radius``
    (inclusive); the normal axis is the eigenvector of the largest
    eigenvalue, turned toward the neighbourhood's mean normal, the
    curvature axis that of the smallest, binormal = curvature x normal.
    Returns (frames (S, 3, 3) with columns [normal, binormal, curvature],
    valid (S,), how well the normal axis is defined: the smaller of the gap
    between the two largest eigenvalues over the largest, and the mean
    neighbourhood normal's component along the axis, which sets its
    sign)."""
    w = (_sq_dist(samples, cloud.points) <= radius * radius
         ).to(cloud.points.dtype)
    nr = cloud.normals
    M = torch.einsum("sn,ni,nj->sij", w, nr, nr)
    val, vec = torch.linalg.eigh(M)
    normal, curv = vec[:, :, 2], vec[:, :, 0]
    along = (torch.einsum("sn,nj->sj", w, nr) * normal).sum(1)
    normal = torch.where((along < 0)[:, None], -normal, normal)
    binormal = torch.linalg.cross(curv, normal)
    gap = torch.minimum((val[:, 2] - val[:, 1]) / val[:, 2].clamp(min=1e-30),
                        along.abs() / w.sum(1).clamp(min=1))
    return torch.stack([normal, binormal, curv], -1), w.sum(1) > 0, gap


def orientation_grid(num: int, axes, dtype, device) -> torch.Tensor:
    """The rotations a frame is turned by, (A * num, 3, 3): a turn of pi
    about the binormal, then each angle of linspace(-pi/2, pi/2, num + 1)
    without its end about each hand axis."""
    flip = torch.diag(torch.tensor([-1.0, 1.0, -1.0], dtype=torch.float64))
    out = []
    for ax in axes:
        for i in range(num):
            t = -math.pi / 2 + math.pi * i / num
            c, s = math.cos(t), math.sin(t)
            r = torch.eye(3, dtype=torch.float64)
            j, k = [q for q in range(3) if q != ax]
            r[j, j], r[j, k], r[k, j], r[k, k] = c, -s, s, c
            if ax == 1:
                r[j, k], r[k, j] = s, -s
            out.append(flip @ r)
    return torch.stack(out).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------------
# The hand at a pose (finger_hand.cpp, antipodal.cpp, hand_set.cpp:75-116)


@dataclasses.dataclass
class Hands:
    """Hands at given poses, flat over H: their validity and geometry."""
    valid: torch.Tensor       # (H,) bool
    bottom: torch.Tensor      # (H,)
    top: torch.Tensor
    center: torch.Tensor
    width: torch.Tensor
    placement: torch.Tensor   # (H,) int64, -1 where invalid
    position: torch.Tensor    # (H, 3)
    full: torch.Tensor        # (H,) bool
    half: torch.Tensor


def _neighbours(centres: torch.Tensor, points: torch.Tensor, radius: float,
                cap: Optional[int] = None):
    """(idx (C, K), valid (C, K)) of the points within ``radius``
    (inclusive) of each centre, the ``cap`` nearest where more are, padded
    to the widest."""
    d2 = _sq_dist(centres, points)
    inside = d2 <= radius * radius
    k = int(inside.sum(1).max()) if len(centres) else 0
    if cap is not None:
        k = min(k, cap)
    k = max(k, 1)
    d = torch.where(inside, d2, torch.inf)
    vals, idx = d.topk(k, dim=1, largest=False)
    return idx, torch.isfinite(vals)


def _spacing(hg: dict, P: int, dtype, device) -> torch.Tensor:
    """The 2P finger positions along the closing axis: P left, P right."""
    od, fw = hg["outer_diameter"], hg["finger_width"]
    half = np.linspace(0.0, od - fw, P)
    return torch.tensor(np.concatenate([half - od + fw, half]), dtype=dtype,
                        device=device)


def _gap_free(y, crop, lo, fw, e):
    """(H, F) bool: no cropped point lies strictly inside the finger
    [lo, lo + fw] along y, for each finger position lo (H, F)."""
    inside = (y[:, :, None] > lo[:, None, :] - e) & \
        (y[:, :, None] < lo[:, None, :] + fw + e) & crop[:, :, None]
    return ~inside.any(1)


def _fingers(x, y, hmask, bite, depth, spacing, fw, e):
    """evaluateFingers at ``bite`` (H,): (H, 2P) free finger positions.
    None are free when a point in front of the bite lies below the hand's
    bottom (bite - depth), or when no point lies in front of it."""
    crop = hmask & (x < bite[:, None] + e)
    blocked = (crop & (x < (bite - depth)[:, None] + e)).any(1)
    empty = ~crop.any(1)
    free = _gap_free(y, crop, spacing[None, :].expand(len(x), -1), fw, e)
    return free & ~(blocked | empty)[:, None]


def _antipodal(x, y, z, nrm, closing, friction_deg, min_viable, e, ec):
    """antipodal.cpp:10-96 over each hand's closing-region points:
    0 none, 1 half, 2 full. ``nrm`` (H, K, 3) is in the hand frame; ``e``
    and ``ec`` lean the thresholds in metres and in cosine units."""
    cosf = math.cos(friction_deg * math.pi / 180.0)
    big = torch.tensor(torch.finfo(x.dtype).max, dtype=x.dtype,
                       device=x.device)
    ymin = torch.where(closing, y, big).amin(1) + EXTREMAL
    ymax = torch.where(closing, y, -big).amax(1) - EXTREMAL
    left = closing & (-nrm[..., 1] > cosf - ec) & (y < ymin[:, None] + e)
    right = closing & (nrm[..., 1] > cosf - ec) & (y > ymax[:, None] - e)
    la, ra = left.any(1), right.any(1)

    def ext(v, m, f):
        return f(torch.where(m, v, big if f is torch.amin else -big), 1)
    top_x = torch.minimum(ext(x, left, torch.amax), ext(x, right, torch.amax))
    bot_x = torch.maximum(ext(x, left, torch.amin), ext(x, right, torch.amin))
    top_z = torch.minimum(ext(z, left, torch.amax), ext(z, right, torch.amax))
    bot_z = torch.maximum(ext(z, left, torch.amin), ext(z, right, torch.amin))

    def count(m):
        box = (x >= bot_x[:, None] - e) & (x <= top_x[:, None] + e) & \
            (z >= bot_z[:, None] - e) & (z <= top_z[:, None] + e)
        return (m & box).sum(1)
    full = la & ra & (count(left) >= min_viable) & (count(right) >= min_viable)
    return (la | ra).long() + full.long()


def hands_at(cloud: Cloud, samples: torch.Tensor, rot: torch.Tensor,
             spec: dict, lean: float = 0.0, lean_cos: float = 0.0,
             block: int = 512) -> Hands:
    """The hand at each (sample (H, 3), rotation (H, 3, 3)) pose, over the
    cloud's points within the hand search radius: the fingers at the first
    bite, the middle free placement, the deepened bite, the closing
    region, the antipodal label, then the workspace and aperture filters.
    The cloud's points are moved into the hand frame as R^T (p - s) by a
    matrix product, so a control's lower matmul precision reaches them.

    ``lean`` (metres) shifts every comparison's threshold by that much
    toward true (or, negative, toward false), ``lean_cos`` the friction
    cone's (cosine units): a point that lies on a threshold, as the points
    of a voxel grid lie on the bites' 5 mm steps, falls one way or the
    other by its last bit, and both ways are GPD's; a normal on the cone's
    edge falls either way by the rounding of its eigenvector."""
    hg = spec["hand_geometry"]
    P = spec["num_finger_placements"]
    dt, dev = cloud.points.dtype, cloud.points.device
    sp = _spacing(hg, P, dt, dev)
    fw, depth, height = hg["finger_width"], hg["depth"], hg["height"]
    radius = max(hg["outer_diameter"] - fw, hg["depth"], hg["height"] / 2.0)
    deepen = []
    d = hg["init_bite"] + DEEPEN_STEP
    while d <= hg["depth"]:
        deepen.append(d)
        d += DEEPEN_STEP
    H = len(samples)
    out = Hands(torch.zeros(H, dtype=torch.bool, device=dev),
                *(torch.zeros(H, dtype=dt, device=dev) for _ in range(4)),
                torch.full((H,), -1, dtype=torch.long, device=dev),
                torch.zeros((H, 3), dtype=dt, device=dev),
                torch.zeros(H, dtype=torch.bool, device=dev),
                torch.zeros(H, dtype=torch.bool, device=dev))
    for b in _blocks(H, block):
        s, R = samples[b], rot[b]
        idx, nv = _neighbours(s, cloud.points, radius)
        rel = cloud.points[idx] - s[:, None, :]
        p = torch.matmul(rel, R)                          # R^T (p - s)
        n = torch.matmul(cloud.normals[idx], R)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        e = lean
        hmask = nv & (z > -height - e) & (z < height + e)
        h = len(s)
        bite = torch.full((h,), hg["init_bite"], dtype=dt, device=dev)
        free = _fingers(x, y, hmask, bite, depth, sp, fw, e)
        hand = free[:, :P] & free[:, P:]
        ok = hand.any(1)
        # The middle free placement: the ceil(m/2)-th of the m free ones.
        rank = hand.long().cumsum(1)
        want = (hand.sum(1) + 1) // 2
        mid = ((rank == want[:, None]) & hand).long().argmax(1)
        top = bite.clone()
        if spec["deepen_hand"]:
            going = ok.clone()
            for dd in deepen:
                bt = torch.full((h,), dd, dtype=dt, device=dev)
                f = _fingers(x, y, hmask, bt, depth, sp, fw, e)
                both = f.gather(1, mid[:, None])[:, 0] & \
                    f.gather(1, (mid + P)[:, None])[:, 0]
                going = going & both
                top = torch.where(going, bt, top)
        bottom = top - depth
        left = sp[mid] + fw
        right = sp[mid + P]
        center = 0.5 * (left + right)
        closing = hmask & (x > bottom[:, None] - e) & \
            (x < top[:, None] + e) & (y > left[:, None] - e) & \
            (y < right[:, None] + e)
        ok = ok & closing.any(1)
        big = torch.tensor(1e30, dtype=dt, device=dev)
        width = torch.where(closing, y, -big).amax(1) - \
            torch.where(closing, y, big).amin(1)
        local = torch.stack([bottom, center, torch.zeros_like(bottom)], 1)
        pos = torch.matmul(R, local[:, :, None])[:, :, 0] + s
        label = _antipodal(x, y, z, n, closing, spec["friction_coeff"],
                           spec["min_viable"], e, lean_cos)
        ok = ok & _workspace_ok(pos, R, width, spec)
        out.valid[b] = ok
        out.bottom[b], out.top[b], out.center[b] = bottom, top, center
        out.width[b] = torch.where(ok, width, 0.0)
        out.placement[b] = torch.where(ok, mid, -1)
        out.position[b] = pos
        out.full[b], out.half[b] = ok & (label == 2), ok & (label >= 1)
    return out


def _workspace_ok(pos, R, width, spec):
    """filterGraspsWorkspace (grasp_detector.cpp:334-398): the aperture
    within [min, max] and five points of the hand inside the grasp
    workspace, the reference's right_top = left_bottom + depth * approach
    (grasp_detector.cpp:362-363) included."""
    if spec["filter_approach_direction"]:
        raise NotImplementedError("the approach direction filter")
    hg = spec["hand_geometry"]
    approach, binormal = R[..., 0], R[..., 1]
    lb = pos + 0.5 * hg["outer_diameter"] * binormal
    rb = pos - 0.5 * hg["outer_diameter"] * binormal
    lt = lb + hg["depth"] * approach
    ap = pos - 0.05 * approach
    pts = torch.stack([lb, rb, lt, lt, ap], 1)
    w = spec["workspace_grasps"]
    lo = torch.tensor([w[0], w[2], w[4]], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor([w[1], w[3], w[5]], dtype=pos.dtype, device=pos.device)
    inside = ((pts.amin(1) >= lo) & (pts.amax(1) <= hi)).all(1)
    return inside & (width >= spec["min_aperture"]) & \
        (width <= spec["max_aperture"])


# ----------------------------------------------------------------------------
# Images (image_strategy.cpp, image_{3,15}_channels_strategy.cpp,
# hand_set.cpp:118-233)


def _image_box(p, bottom, center, ig):
    """The unit image volume: (u, v, w) and the inside mask of hand-frame
    points p (H, K, 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    b, c = bottom[:, None], center[:, None]
    half = ig["outer_diameter"] / 2.0
    inside = (x > b) & (x < b + ig["depth"]) & (y > c - half) & \
        (y < c + half) & (z > -ig["height"]) & (z < ig["height"])
    u = (x - b) / ig["depth"]
    v = (y - (c - half)) / ig["outer_diameter"]
    w = (z + ig["height"]) / (2.0 * ig["height"])
    return u, v, w, inside


def _cell(c, size):
    return torch.floor(c * size).clamp(max=size - 1).long()


def _cell_sums(rows, cols, inside, values, size):
    """(H, size, size, F) sums of ``values`` (H, K, F) and (H, size, size)
    counts over the cells (rows, cols) of the inside points."""
    H = rows.shape[0]
    flat = (torch.arange(H, device=rows.device)[:, None] * size + rows
            ) * size + cols
    flat = flat[inside]
    sums = torch.zeros((H * size * size, values.shape[-1]),
                       dtype=values.dtype, device=values.device)
    sums.index_put_((flat,), values[inside], accumulate=True)
    cnt = torch.zeros(H * size * size, dtype=values.dtype,
                      device=values.device)
    cnt.index_put_((flat,), torch.ones_like(flat, dtype=values.dtype),
                   accumulate=True)
    return sums.view(H, size, size, -1), cnt.view(H, size, size)


def _dilate(img):
    """3x3 maximum (cv::dilate) of (H, C, S, S); the border adds nothing."""
    return F.max_pool2d(img, 3, stride=1, padding=1)


def _to_u8(img):
    """NORM_MINMAX over all channels of each (H, C, S, S) image, then
    x 255 rounded to uint8."""
    lo = img.amin((1, 2, 3), keepdim=True)
    hi = img.amax((1, 2, 3), keepdim=True)
    span = hi - lo
    out = torch.where(span > 0, (img - lo) / torch.where(span > 0, span, 1),
                      0.0)
    return torch.round(out * 255.0).to(torch.uint8)


def _projection(u, v, w, inside, absn, size, which):
    """One projection's 3 normal channels and its depth channel, (H, 4,
    S, S) before the uint8 step. P0: rows u, columns v, depth w; P1: rows w,
    columns v, depth u; P2: rows w, columns u, depth v. Image rows run
    top-down: row = size - 1 - cell."""
    r, c, dep = {0: (u, v, w), 1: (w, v, u), 2: (w, u, v)}[which]
    rows = size - 1 - _cell(r, size)
    sums, cnt = _cell_sums(rows, _cell(c, size), inside,
                           torch.cat([absn, dep[..., None]], -1), size)
    mean = sums / cnt.clamp(min=1)[..., None]
    nimg = mean[..., :3].permute(0, 3, 1, 2)
    dimg = torch.where(cnt > 0, 1.0 - mean[..., 3], 0.0)[:, None]
    return nimg, dimg


def _shadow_channel(su, sv, sw, sins, size, which):
    """A projection's shadow channel: per cell the mean depth of the
    shadow points in it, subtracted from the largest such mean."""
    r, c, dep = {0: (su, sv, sw), 1: (sw, sv, su), 2: (sw, su, sv)}[which]
    rows = size - 1 - _cell(r, size)
    sums, cnt = _cell_sums(rows, _cell(c, size), sins, dep[..., None], size)
    mean = sums[..., 0] / cnt.clamp(min=1)
    occ = cnt > 0
    big = torch.tensor(1e30, dtype=mean.dtype, device=mean.device)
    mx = torch.where(occ, mean, -big).amax((1, 2), keepdim=True)
    mx = torch.where(mx > -big, mx, 0.0)
    return torch.where(occ, mx - mean, 0.0)[:, None]


def shadows(src: torch.Tensor, src_valid: torch.Tensor, src_cams,
            view_points: torch.Tensor, length: float, per_source: int,
            cap: int, generator: torch.Generator) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """calculateShadow4 for each hand's sources (H, K, 3): each source
    casts ``per_source`` points at uniform random positions along the
    shadow vector (length ``length`` from the camera through the sources'
    centre), binned into SHADOW_VOXEL cubes (truncated toward zero); the
    occluded cubes are those of camera 0 that every other camera seeing
    the sources also has (none when camera 0 sees none of them); at most
    ``cap`` cubes are kept, a uniform random subset where more are; each
    becomes its corner plus one normal jitter of 0.3 cube for all three
    coordinates. Returns (points (H, cap, 3), valid (H, cap))."""
    H, K, _ = src.shape
    V = view_points.shape[0]
    dt, dev = src.dtype, src.device
    gdev = generator.device
    cnt = src_valid.sum(1).clamp(min=1).to(dt)
    centre = (src * src_valid[..., None]).sum(1) / cnt[:, None]
    seen = (_seen(src_cams.reshape(-1), V).reshape(H, K, V)
            & src_valid[..., None]).any(1)                          # (H, V)
    # Cube coordinates relative to a corner below every hand's cubes, so
    # one int64 key holds (hand, x, y, z).
    base = torch.trunc(torch.where(src_valid[..., None], src, 1e9).amin(1)
                       / SHADOW_VOXEL).long() - int(length / SHADOW_VOXEL) - 4
    span = 1 << 14
    hand = torch.arange(H, device=dev)[:, None, None]
    keys, need = [], seen.long().sum(1)
    for c in range(V):
        vec = centre - view_points[c][None, :]
        vec = length * vec / vec.norm(dim=1, keepdim=True).clamp(min=1e-12)
        t = torch.rand((H, K, per_source), generator=generator,
                       device=gdev).to(dev, dt)
        q = src[:, :, None, :] + t[..., None] * vec[:, None, None, :]
        cube = torch.trunc(q / SHADOW_VOXEL).long() - base[:, None, None, :]
        key = ((hand * span + cube[..., 0]) * span + cube[..., 1]) * span \
            + cube[..., 2]
        ok = src_valid[:, :, None] & seen[:, c, None, None]
        keys.append(torch.unique(key[ok.expand_as(key)]))
    # A cube is occluded when every camera that sees its hand's sources
    # has it, camera 0 among them.
    allk, n = torch.unique(torch.cat(keys), return_counts=True)
    h_of = allk // span ** 3
    first = torch.isin(allk, keys[0])
    occ = allk[first & (n == need[h_of])]
    # At most cap per hand: a random priority, the cap smallest kept.
    pri = torch.rand(len(occ), generator=generator, device=gdev).to(dev)
    h_occ = occ // span ** 3
    order = torch.argsort(h_occ.to(torch.float64) * 2.0 + pri.double())
    occ, h_occ = occ[order], h_occ[order]
    start = torch.searchsorted(h_occ, torch.arange(H, device=dev))
    slot = torch.arange(len(occ), device=dev) - start[h_occ]
    keep = slot < cap
    occ, h_occ, slot = occ[keep], h_occ[keep], slot[keep]
    rem = occ - h_occ * span ** 3
    cube = torch.stack([rem // span ** 2, (rem // span) % span, rem % span],
                       1) + base[h_occ]
    jit = torch.randn(len(occ), generator=generator, device=gdev).to(dev, dt)
    pts_out = torch.zeros((H, cap, 3), dtype=dt, device=dev)
    ok_out = torch.zeros((H, cap), dtype=torch.bool, device=dev)
    pts_out[h_occ, slot] = cube.to(dt) * SHADOW_VOXEL + \
        (0.3 * SHADOW_VOXEL) * jit[:, None]
    ok_out[h_occ, slot] = True
    return pts_out, ok_out


def images(cloud: Cloud, image_mask: torch.Tensor, samples: torch.Tensor,
           rot: torch.Tensor, bottom: torch.Tensor, center: torch.Tensor,
           spec: dict, generator: Optional[torch.Generator],
           block: int = 128) -> torch.Tensor:
    """The (H, size, size, C) uint8 images of hands at their poses and
    closing regions, over the points of ``image_mask`` within the image
    radius of the sample, the image_neighbors_cap nearest where more are:
    3 channels are P0's mean |normal| (createImages3Channels), 15 are each
    projection's mean |normal|, depth and shadow channels
    (createImages15Channels), each group dilated and normalized alone."""
    ig = spec["image_geometry"]
    size, C = ig["size"], ig["num_channels"]
    if C not in (3, 15):
        raise NotImplementedError(f"{C}-channel images")
    radius = max(ig["depth"], ig["height"] / 2.0, ig["outer_diameter"])
    pts, nrm = cloud.points[image_mask], cloud.normals[image_mask]
    cams = cloud.cams[image_mask]
    out = []
    for b in _blocks(len(samples), block):
        s, R = samples[b], rot[b]
        idx, nv = _neighbours(s, pts, radius, spec["image_neighbors_cap"])
        p = torch.matmul(pts[idx] - s[:, None, :], R)
        n = torch.matmul(nrm[idx], R).abs()
        u, v, w, ins = _image_box(p, bottom[b], center[b], ig)
        ins = ins & nv
        if C == 3:
            nimg, _ = _projection(u, v, w, ins, n, size, 0)
            out.append(_to_u8(_dilate(nimg)).permute(0, 2, 3, 1))
            continue
        k = min(spec["shadow_source_cap"], idx.shape[1])
        length = max(ig["outer_diameter"], ig["depth"], ig["height"] / 2.0)
        per = int(length // SHADOW_VOXEL)
        src_i, src_v = idx[:, :k], nv[:, :k]
        sp, sv = shadows(pts[src_i], src_v, cams[src_i], cloud.view_points,
                         length, per, min(spec["shadow_voxel_cap"], k * per),
                         generator)
        sp = torch.matmul(sp - s[:, None, :], R)
        su, sv_, sw, sins = _image_box(sp, bottom[b], center[b], ig)
        sins = sins & sv
        chans = []
        for which in range(3):
            nimg, dimg = _projection(u, v, w, ins, n, size, which)
            simg = _shadow_channel(su, sv_, sw, sins, size, which)
            chans += [_to_u8(_dilate(nimg)), _to_u8(_dilate(dimg)),
                      _to_u8(_dilate(simg))]
        out.append(torch.cat(chans, 1).permute(0, 2, 3, 1))
    if not out:
        return torch.zeros((0, size, size, C), dtype=torch.uint8,
                           device=samples.device)
    return torch.cat(out)


# ----------------------------------------------------------------------------
# The classifier (GPD's LeNet, eigen_classifier.cpp) and the selection
# (grasp_detector.cpp:275-311, clustering.cpp)


def load_lenet(path: str, device) -> dict:
    """The checkpoint's arrays as float32 tensors: conv1_w (20, C, 5, 5),
    conv1_b, conv2_w (50, 20, 5, 5), conv2_b, fc1_w (500, 50*s*s) over a
    channel-major flatten, fc1_b, fc2_w (2, 500), fc2_b."""
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k].astype(np.float32), device=device)
                for k in z.files}


def lenet_scores(w: dict, images_u8: torch.Tensor,
                 operands: torch.dtype = torch.bfloat16,
                 block: int = 1024) -> torch.Tensor:
    """Score = positive minus negative logit of conv 5x5 -> ReLU -> max
    pool 2 -> conv 5x5 -> ReLU -> max pool 2 -> fc -> ReLU -> fc, on the
    image scaled by 1/256. Every product's two operands are rounded to
    ``operands`` and the arithmetic is float32; biases stay float32."""
    def r(t):
        return t.to(operands).float()
    out = []
    for b in _blocks(len(images_u8), block):
        x = images_u8[b].permute(0, 3, 1, 2).float() / 256.0
        x = F.max_pool2d(F.relu(F.conv2d(r(x), r(w["conv1_w"]),
                                         w["conv1_b"])), 2)
        x = F.max_pool2d(F.relu(F.conv2d(r(x), r(w["conv2_w"]),
                                         w["conv2_b"])), 2)
        x = F.relu(F.linear(r(x.flatten(1)), r(w["fc1_w"]), w["fc1_b"]))
        x = F.linear(r(x), r(w["fc2_w"]), w["fc2_b"])
        out.append(x[:, 1] - x[:, 0])
    if not out:
        return torch.zeros(0, device=images_u8.device)
    return torch.cat(out)


def select(position, axis, score, k: int, min_inliers: int):
    """The top ``k`` hands by score (the first of equal scores first), then
    with min_inliers > 0 the clusters: hand i of the top k with at least
    min_inliers inliers j != i among them (axes within 12 degrees, within
    5 cm, within 5 mm off i's axis) becomes a grasp at its inliers' mean
    position, scored by the lower 99% bound of their mean score; with 3 or
    fewer such grasps the top k hands follow them. Returns the chosen
    rows as (index into the input, position, score), best score first."""
    order = sorted(range(len(score)), key=lambda i: (-float(score[i]), i))
    top = order[:k]
    if min_inliers <= 0:
        return [(i, position[i], float(score[i])) for i in top]
    P = position[top]
    A = axis[top]
    S = score[top]
    out = []
    for a, i in enumerate(top):
        d = P - P[a]
        near = d.norm(dim=1) <= CLUSTER_DIST
        proj = d - A[a][None, :] * (d @ A[a])[:, None]
        inl = ((A @ A[a]).abs() > CLUSTER_COS) & near & \
            (proj.norm(dim=1) <= CLUSTER_PROJ)
        inl[a] = False
        n = int(inl.sum())
        if n < max(min_inliers, 1):
            continue
        s = S[inl]
        lb = float(s.mean() - Z99 * s.std(unbiased=False) / math.sqrt(n))
        out.append((i, P[inl].mean(0), lb))
    if len(out) <= 3:
        out += [(i, position[i], float(score[i])) for i in top]
    return sorted(out, key=lambda t: -t[2])
