"""Surface-normal estimation (port of gpd_tpu/ops/normals.py).

Per-point covariances over ALL cloud points within ``radius`` (the
reference's PCL ``NormalEstimationOMP`` semantics, cloud.cpp:497-535) as one
masked moment matmul, the closed-form 3x3 eigensolver, and viewpoint
orientation toward the highest-index camera seeing the point (the
reference's per-camera loop overwrites, so the last camera wins).
"""

from __future__ import annotations

import dataclasses

import torch

from gpd_tpu_torch.core.types import CloudArrays
from gpd_tpu_torch.ops.eigh3 import eigh3_sym
from gpd_tpu_torch.ops.neighbors import radius_moments, radius_neighbors


def _seen_by(cam_source: torch.Tensor, num_cameras: int) -> torch.Tensor:
    """(N, V) bool: bit v of each point's camera bitmask."""
    cam_ids = torch.arange(num_cameras, device=cam_source.device)
    return ((cam_source[:, None] >> cam_ids[None, :]) & 1) > 0


def _normals_kernel(points, mask, cam_source, view_points, radius: float):
    # Centered on the cloud centroid first: the raw-moment identity
    # cov = E[pp^T] - mu mu^T cancels catastrophically in f32 when |p| is
    # much larger than the neighborhood radius.
    w_all = mask.to(points.dtype)
    centroid = torch.sum(points * w_all[:, None], dim=0) / \
        torch.clamp(torch.sum(w_all), min=1.0)
    p = torch.where(mask[:, None], points - centroid[None, :], 1.0e6)
    feats = torch.stack([
        p[:, 0] * p[:, 0], p[:, 1] * p[:, 1], p[:, 2] * p[:, 2],
        p[:, 0] * p[:, 1], p[:, 0] * p[:, 2], p[:, 1] * p[:, 2],
        p[:, 0], p[:, 1], p[:, 2],
    ], dim=1)                                           # (N, 9)
    sums, counts = radius_moments(p, mask, p, mask, feats, radius)
    cnt = torch.clamp(counts, min=1.0)
    mean = sums[:, 6:9] / cnt[:, None]
    xx, yy, zz, xy, xz, yz = (sums[:, i] / cnt for i in range(6))
    m2 = torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([xy, yy, yz], dim=-1),
        torch.stack([xz, yz, zz], dim=-1),
    ], dim=-2)                                          # (N, 3, 3)
    cov = m2 - mean[:, :, None] * mean[:, None, :]
    _, V = eigh3_sym(cov)
    normal = V[..., :, 0]                               # smallest eigenvalue

    # Orient toward the highest-index camera seeing the point
    # (flipNormalTowardsViewpoint; overwrite order cloud.cpp:511-534).
    ncams = view_points.shape[0]
    seen = _seen_by(cam_source, ncams).to(torch.int32)
    last_cam = torch.where(
        torch.any(seen > 0, dim=1),
        (ncams - 1) - torch.argmax(torch.flip(seen, dims=(1,)), dim=1), 0)
    to_vp = view_points[last_cam] - points
    flip = torch.sum(normal * to_vp, dim=1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    return torch.where((mask & (counts > 0))[:, None], normal, 0.0)


def estimate_normals(cloud: CloudArrays, radius: float, k: int = 128
                     ) -> CloudArrays:
    """Estimate + orient normals for every masked point. ``k`` is accepted
    and unused, as in gpd_tpu: the moments cover every in-radius point."""
    del k
    normals = _normals_kernel(cloud.points, cloud.mask, cloud.cam_source,
                              cloud.view_points, radius)
    return dataclasses.replace(cloud, normals=normals)


def reverse_normals(points, normals, mask, cam_source, view_points):
    """Flip normals that point away from every camera that sees them
    (reference: cloud.cpp:573-604)."""
    seen = _seen_by(cam_source, view_points.shape[0])           # (N, V)
    cam_to_pt = points[:, None, :] - view_points[None, :, :]    # (N, V, 3)
    toward = torch.sum(normals[:, None, :] * cam_to_pt, dim=-1) < 0.0
    ok = torch.any(seen & toward, dim=1)
    return torch.where((mask & ~ok)[:, None], -normals, normals)


def reverse_normals_cloud(cloud: CloudArrays) -> CloudArrays:
    return dataclasses.replace(cloud, normals=reverse_normals(
        cloud.points, cloud.normals, cloud.mask, cloud.cam_source,
        cloud.view_points))


def refine_normals(points, normals, mask, k: int = 10,
                   max_iterations: int = 15,
                   convergence_rms: float = 1e-4):
    """pcl::NormalRefinement semantics (reference: cloud.cpp:176-204):
    per iteration every normal becomes the normalized uniform average of its
    k nearest neighbors' previous normals, for up to ``max_iterations`` or
    until the RMS change drops below ``convergence_rms``. Neighbor sets are
    fixed across iterations and include the point itself.

    gpd_tpu's ``lax.while_loop`` (gpd_tpu/ops/normals.py:114-151) with its
    trip count on the device: all ``max_iterations`` run, and a flag on the
    device freezes ``cur`` from the iteration after the one whose RMS change
    fell below ``convergence_rms``. That equals stopping there, and nothing
    is read back to the host, so a CUDA graph can hold the loop."""
    idx, valid = radius_neighbors(points, mask, points, mask, radius=1e5, k=k,
                                  exact=True)
    vmaskf = valid[..., None].to(normals.dtype)
    n_pts = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    cur = normals
    done = torch.zeros((), dtype=torch.bool, device=normals.device)
    for _ in range(max_iterations):
        avg = torch.sum(cur[idx] * vmaskf, dim=1)
        nrm = torch.sqrt(torch.sum(avg * avg, dim=1, keepdim=True))
        new = torch.where(nrm > 0.0, avg / torch.clamp(nrm, min=1e-20), cur)
        new = torch.where(mask[:, None], new, cur)
        diff = new - cur
        rms = torch.sqrt(torch.sum(diff * diff) / n_pts)
        cur = torch.where(done, cur, new)
        done = done | (rms < convergence_rms)
    return cur
