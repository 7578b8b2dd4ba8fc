# Frozen copy of gpd_tpu_torch/datasets/synthetic.py at commit e4413f0238c1,
# unchanged: the benchmark's traffic comes from it, so later changes to
# the program do not change what the benchmark sends.

"""Synthetic graspable-object zoo for classifier training.

The reference trains its LeNet on BigBIRD scans (ground-truth mesh cloud +
20 partial views per object, reference: src/gpd/data_generator.cpp:73-277);
that data is not shipped. This module provides the same *shape* of training
signal from analytic primitives: each object yields a dense surface cloud
with exact outward normals (the "mesh" ground truth) and partial single-view
clouds rendered by backface culling + sensor noise (the "views").

Objects are sized for a parallel-jaw hand with outer diameter ~0.12 m /
aperture <= 0.085 m so both graspable and ungraspable geometry appear:
boxes, cylinders, spheres, capped composites (mug/tube-like), some too wide
to grasp (near-aperture boxes) for hard negatives.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


def _unit_rows(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def sample_box(rng: np.random.Generator, size: Sequence[float],
               n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform surface samples of an axis-aligned box centered at origin."""
    sx, sy, sz = [float(s) for s in size]
    areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, (n, 2))
    pts = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    half = np.array([sx, sy, sz]) / 2.0
    for f in range(6):
        m = face == f
        ax = f // 2                      # fixed axis
        sgn = 1.0 if f % 2 == 0 else -1.0
        oth = [a for a in range(3) if a != ax]
        pts[m, ax] = sgn * half[ax]
        pts[m, oth[0]] = u[m, 0] * 2 * half[oth[0]]
        pts[m, oth[1]] = u[m, 1] * 2 * half[oth[1]]
        nrm[m, ax] = sgn
    return pts, nrm


def sample_cylinder(rng: np.random.Generator, radius: float, height: float,
                    n: int, caps: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform surface samples of a z-axis cylinder centered at origin."""
    side_area = 2 * np.pi * radius * height
    cap_area = np.pi * radius ** 2 if caps else 0.0
    p = np.array([side_area, cap_area, cap_area])
    p = p / p.sum()
    part = rng.choice(3, size=n, p=p)
    pts = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    theta = rng.uniform(0, 2 * np.pi, n)
    m = part == 0
    pts[m, 0] = radius * np.cos(theta[m])
    pts[m, 1] = radius * np.sin(theta[m])
    pts[m, 2] = rng.uniform(-height / 2, height / 2, m.sum())
    nrm[m, 0] = np.cos(theta[m])
    nrm[m, 1] = np.sin(theta[m])
    for which, sgn in ((1, 1.0), (2, -1.0)):
        m = part == which
        r = radius * np.sqrt(rng.uniform(0, 1, m.sum()))
        pts[m, 0] = r * np.cos(theta[m])
        pts[m, 1] = r * np.sin(theta[m])
        pts[m, 2] = sgn * height / 2
        nrm[m, 2] = sgn
    return pts, nrm


def sample_sphere(rng: np.random.Generator, radius: float,
                  n: int) -> Tuple[np.ndarray, np.ndarray]:
    v = _unit_rows(rng.normal(size=(n, 3)))
    return (radius * v).astype(np.float32), v.astype(np.float32)


def make_object(rng: np.random.Generator, kind: str, n: int = 6000,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """One object: (points (n,3) f32, outward normals (n,3) f32)."""
    if kind == "box":
        size = rng.uniform([0.02, 0.02, 0.05], [0.07, 0.07, 0.18])
        pts, nrm = sample_box(rng, size, n)
    elif kind == "wide_box":                      # near/over-aperture negative
        size = rng.uniform([0.085, 0.085, 0.05], [0.14, 0.14, 0.15])
        pts, nrm = sample_box(rng, size, n)
    elif kind == "cylinder":                      # can / bottle-like
        r = rng.uniform(0.015, 0.04)
        h = rng.uniform(0.08, 0.22)
        pts, nrm = sample_cylinder(rng, r, h, n)
    elif kind == "wide_cylinder":
        r = rng.uniform(0.05, 0.08)
        h = rng.uniform(0.06, 0.14)
        pts, nrm = sample_cylinder(rng, r, h, n)
    elif kind == "sphere":
        r = rng.uniform(0.02, 0.05)
        pts, nrm = sample_sphere(rng, r, n)
    elif kind == "stack":                          # mug/jar-like composite
        r = rng.uniform(0.03, 0.05)
        h = rng.uniform(0.06, 0.12)
        n1 = n // 2
        p1, m1 = sample_cylinder(rng, r, h, n1)
        size = rng.uniform([0.02, 0.02, 0.02], [0.05, 0.05, 0.05])
        p2, m2 = sample_box(rng, size, n - n1)
        p2 = p2 + np.array([0, 0, h / 2 + size[2] / 2], np.float32)
        pts = np.concatenate([p1, p2])
        nrm = np.concatenate([m1, m2])
    else:
        raise ValueError(kind)
    # Random rotation so hand axes see varied poses.
    A = rng.normal(size=(3, 3))
    q, _ = np.linalg.qr(A)
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return (pts @ q.T).astype(np.float32), (nrm @ q.T).astype(np.float32)


OBJECT_KINDS = ("box", "cylinder", "sphere", "stack", "wide_box",
                "wide_cylinder")


def render_view(rng: np.random.Generator, pts: np.ndarray, nrm: np.ndarray,
                cam: np.ndarray, noise: float = 5e-4,
                dropout: float = 0.05) -> np.ndarray:
    """Partial view of an object from camera position `cam`: keep
    front-facing points (normal toward camera), add depth noise along the
    ray and random dropout — the synthetic analog of one BigBIRD view PCD."""
    to_cam = _unit_rows(cam[None, :] - pts)
    front = np.sum(to_cam * nrm, axis=1) > 0.1
    keep = front & (rng.uniform(size=len(pts)) > dropout)
    p = pts[keep]
    ray = _unit_rows(p - cam[None, :])
    p = p + ray * rng.normal(scale=noise, size=(len(p), 1))
    return p.astype(np.float32)


def view_cameras(rng: np.random.Generator, num_views: int,
                 dist: float = 0.5) -> np.ndarray:
    """Camera positions on the upper hemisphere (BigBIRD turntable-like)."""
    az = rng.uniform(0, 2 * np.pi, num_views)
    el = rng.uniform(0.1, 1.2, num_views)
    return np.stack([dist * np.cos(el) * np.cos(az),
                     dist * np.cos(el) * np.sin(az),
                     dist * np.sin(el)], axis=1).astype(np.float32)


def object_zoo(num_objects: int, seed: int = 0,
               points_per_object: int = 6000) -> Iterator[
                   Tuple[str, np.ndarray, np.ndarray]]:
    """Yields (name, mesh points, mesh normals)."""
    rng = np.random.default_rng(seed)
    for i in range(num_objects):
        kind = OBJECT_KINDS[i % len(OBJECT_KINDS)]
        pts, nrm = make_object(rng, kind, points_per_object)
        yield f"{kind}_{i:03d}", pts, nrm


def make_scene(rng: np.random.Generator, n_objects: int = 0,
               points_per_object: int = 6000, table_halfsize: float = 0.22,
               table_points: int = 9000) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-object table scene: 2-4 zoo objects resting on a z=0 plane plus
    a dense table patch — the synthetic analog of the dense-clutter scenes
    the reference's serving claims are about (reference README.md:237-244;
    its BigBIRD views likewise include the turntable surface).

    The table IS part of the returned ground-truth cloud: grasps colliding
    with the plane or a neighboring object must label negative in
    reevaluateHypotheses (hand_search.cpp:66-134), which is exactly the
    signal single-object training data lacks.

    Returns (points, outward normals) of the full scene surface.
    """
    k = int(n_objects) if n_objects else int(rng.integers(2, 5))
    pts_all: List[np.ndarray] = []
    nrm_all: List[np.ndarray] = []
    placed: List[Tuple[np.ndarray, float]] = []
    for i in range(k):
        kind = OBJECT_KINDS[int(rng.integers(len(OBJECT_KINDS)))]
        pts, nrm = make_object(rng, kind, points_per_object)
        pts[:, 2] -= pts[:, 2].min()                    # rest on the plane
        r = float(np.max(np.linalg.norm(pts[:, :2], axis=1)))
        lim = max(table_halfsize - r, 0.01)
        xy = rng.uniform(-lim, lim, 2)
        for _ in range(40):                             # overlap rejection
            xy = rng.uniform(-lim, lim, 2)
            if all(np.linalg.norm(xy - c) > r + cr + 0.005
                   for c, cr in placed):
                break
        placed.append((xy, r))
        pts[:, :2] += xy
        pts_all.append(pts.astype(np.float32))
        nrm_all.append(nrm)
    txy = rng.uniform(-table_halfsize, table_halfsize,
                      (table_points, 2)).astype(np.float32)
    tpts = np.concatenate([txy, np.zeros((table_points, 1), np.float32)], 1)
    tnrm = np.tile(np.array([0, 0, 1], np.float32), (table_points, 1))
    return (np.concatenate(pts_all + [tpts]),
            np.concatenate(nrm_all + [tnrm]))


def render_view_occluded(rng: np.random.Generator, pts: np.ndarray,
                         nrm: np.ndarray, cam: np.ndarray,
                         noise: float = 5e-4, dropout: float = 0.05,
                         cell_rad: float = 0.01) -> np.ndarray:
    """render_view plus inter-object occlusion: a spherical z-buffer keeps
    only the nearest surface per angular cell (~cell_rad radians), so
    objects hide what is behind them — the property that makes clutter
    views clutter. Backface culling still applies (a surface facing away
    is never seen). Cells must stay coarser than the surface sampling
    spacing or hidden points leak through empty cells; at the zoo's
    ~4-8 mm point spacing and 0.5-0.7 m camera distances, 0.01 rad
    (~5-7 mm) cells cull the large majority of hidden surface."""
    to_cam = _unit_rows(cam[None, :] - pts)
    front = np.sum(to_cam * nrm, axis=1) > 0.1
    idx = np.nonzero(front)[0]
    if len(idx) == 0:
        return np.zeros((0, 3), np.float32)
    p = pts[idx]
    d = p - cam[None, :]
    dist = np.linalg.norm(d, axis=1)
    dirs = d / dist[:, None]
    # Angular binning on the tangent (pinhole image) plane of the mean view
    # direction — az/el cells degenerate at the view pole (near-axis rays
    # scatter across every azimuth bin, so nothing behind them ever
    # occludes).
    w = pts.mean(axis=0) - cam
    w = w / max(np.linalg.norm(w), 1e-9)
    a = np.array([1.0, 0, 0]) if abs(w[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(w, a)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    t = np.maximum(dirs @ w, 1e-6)
    ia = np.floor((dirs @ u) / t / cell_rad).astype(np.int64)
    ie = np.floor((dirs @ v) / t / cell_rad).astype(np.int64)
    # Rays nearly perpendicular to the mean view direction (t at the 1e-6
    # clamp) produce tangent coordinates far beyond the 2^20 packing offset;
    # unclipped they alias unrelated cells and can cull visible points.
    # Clip into the bit budget: extreme rays only ever compete with other
    # equally-extreme rays in the border cell.
    lim = (1 << 20) - 1
    ia = np.clip(ia, -lim, lim)
    ie = np.clip(ie, -lim, lim)
    cell = (ia + (1 << 20)) * (1 << 21) + (ie + (1 << 20))
    order = np.lexsort((dist, cell))
    cell_sorted = cell[order]
    first = np.ones(len(order), bool)
    first[1:] = cell_sorted[1:] != cell_sorted[:-1]
    # Nearest point per cell, plus anything within 1 cm of it (a cell can
    # legitimately contain several points of the SAME nearby surface).
    near = np.minimum.reduceat(dist[order], np.nonzero(first)[0])
    near_per = np.repeat(near, np.diff(np.nonzero(
        np.append(first, True))[0]))
    keep_sorted = dist[order] <= near_per + 0.01
    keep = np.zeros(len(order), bool)
    keep[order] = keep_sorted
    keep &= rng.uniform(size=len(keep)) > dropout
    p = p[keep]
    ray = _unit_rows(p - cam[None, :])
    p = p + ray * rng.normal(scale=noise, size=(len(p), 1))
    return p.astype(np.float32)


def render_fused_views(rng: np.random.Generator, pts: np.ndarray,
                       nrm: np.ndarray, cams: np.ndarray,
                       occluded: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-camera capture of one scene: render each camera's partial view
    (already in the common world frame, so fusion is concatenation — the
    synthetic analog of datagen.fuse_views' table-frame transforms,
    data_generator.cpp:617-665). Returns (points, camera-source bitmask
    with bit i = camera i, view_points)."""
    render = render_view_occluded if occluded else render_view
    pts_out, cam_out = [], []
    for i, cam in enumerate(cams):
        p = render(rng, pts, nrm, np.asarray(cam, np.float32))
        pts_out.append(p)
        cam_out.append(np.full(len(p), np.uint32(1) << np.uint32(i),
                               np.uint32))
    return (np.concatenate(pts_out), np.concatenate(cam_out),
            np.asarray(cams, np.float32).reshape(-1, 3))
