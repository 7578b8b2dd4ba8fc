"""Point-cloud preprocessing (port of gpd_tpu/ops/preprocess.py).

Fixed-shape and mask-based like the JAX package: nothing changes a tensor's
size on the device; compaction is a host step (``CloudArrays.compact_host``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from gpd_tpu_torch import constant
from gpd_tpu_torch.core.types import PAD_COORD, CloudArrays
from gpd_tpu_torch.ops import draws
from gpd_tpu_torch.ops.neighbors import outlier_knn


def remove_nans(cloud: CloudArrays) -> CloudArrays:
    """Mask out non-finite points, padded with PAD_COORD (reference:
    cloud.cpp:154-164; gpd_tpu/ops/preprocess.py:21-24). The port's
    ``preprocess_cloud`` drops such rows on the host instead, as gpd_tpu's
    does."""
    ok = torch.all(torch.isfinite(cloud.points), dim=1) & cloud.mask
    return _apply_mask(cloud, ok)


def _apply_mask(cloud: CloudArrays, mask: torch.Tensor) -> CloudArrays:
    pts = torch.where(mask[:, None], cloud.points, PAD_COORD)
    return CloudArrays(points=pts, normals=cloud.normals,
                       cam_source=cloud.cam_source, mask=mask,
                       view_points=cloud.view_points)


def in_workspace(points: torch.Tensor, workspace: Sequence[float]) -> torch.Tensor:
    """Strict-inequality axis-aligned box test (cloud.cpp:243-249)."""
    w = workspace
    return ((points[:, 0] > w[0]) & (points[:, 0] < w[1]) &
            (points[:, 1] > w[2]) & (points[:, 1] < w[3]) &
            (points[:, 2] > w[4]) & (points[:, 2] < w[5]))


def filter_workspace(cloud: CloudArrays, workspace: Sequence[float]) -> CloudArrays:
    """Axis-aligned workspace crop (reference: cloud.cpp:206-267)."""
    return _apply_mask(cloud, cloud.mask & in_workspace(cloud.points, workspace))


def _voxel_kernel(points, normals, cam_source, mask, cell_size: float):
    n = points.shape[0]
    # Min over valid points (the reference's pcl::getMinMax3D,
    # cloud.cpp:288-291).
    min_pt = torch.amin(torch.where(mask[:, None], points, torch.inf), dim=0)
    # A device constant, not torch.tensor(cell_size, device=...): a copy
    # from the host waits for the card, which a CUDA graph capture forbids.
    # A Python float would divide by its reciprocal on the card instead.
    cell = constant(cell_size, points.device)
    bins = torch.floor((points - min_pt[None, :]) / cell).to(torch.int32)
    # Invalid points go to a sentinel cell that sorts last.
    bins = torch.where(mask[:, None], bins, 1 << 24)

    # Lexicographic (x, y, z, original index) order, the reference's
    # std::set<Vector4i> iteration order (cloud.cpp:292-333) with the first
    # inserted point as the cell's representative: stable sorts from the
    # least significant key (gpd_tpu uses jnp.lexsort).
    order = torch.arange(n, device=points.device)
    for axis in (2, 1, 0):
        order = order[torch.argsort(bins[order, axis], stable=True)]
    sb = bins[order]
    svalid = mask[order]
    # Row 0 starts a cell; a mask, not an assignment of a host scalar,
    # which would be a copy from the host.
    new_cell = torch.any(sb != torch.roll(sb, 1, dims=0), dim=1) | (
        torch.arange(n, device=points.device) == 0)
    is_rep = new_cell & svalid

    seg = torch.cumsum(new_cell, dim=0) - 1        # segment id in sorted order
    ones = svalid.to(torch.float32)
    counts = torch.zeros(n, device=points.device).index_add_(0, seg, ones)
    nrm_sum = torch.zeros((n, 3), device=points.device).index_add_(
        0, seg, normals[order] * ones[:, None])

    rep_pts = torch.addcmul(min_pt[None, :], sb.to(torch.float32), cell)
    avg_nrm = nrm_sum[seg] / torch.clamp(counts[seg], min=1.0)[:, None]

    out_pts = torch.where(is_rep[:, None], rep_pts, PAD_COORD)
    out_nrm = torch.where(is_rep[:, None], avg_nrm, 0.0)
    out_cam = torch.where(is_rep, cam_source[order], 0)
    return out_pts, out_nrm, out_cam, is_rep


def voxelize(cloud: CloudArrays, cell_size: float) -> CloudArrays:
    """Voxel downsample with the reference's semantics (cloud.cpp:286-348):
    one representative per cell (first point in original order), snapped to
    the voxel corner, normals averaged over the cell, camera source from the
    representative, output in lexicographic cell order."""
    pts, nrm, cam, mask = _voxel_kernel(cloud.points, cloud.normals,
                                        cloud.cam_source, cloud.mask,
                                        cell_size)
    return CloudArrays(points=pts, normals=nrm, cam_source=cam, mask=mask,
                       view_points=cloud.view_points)


def _outlier_mask(points, mask, mean_k: int, stddev_mult: float,
                  block: int = 1024):
    # Mean distance to the mean_k nearest neighbors (self excluded): on a
    # card one kernel, csrc/outlier_knn.cu; on the CPU the values of a
    # blocked distance matmul's exact k smallest, no index gather.
    mean_d = outlier_knn(points, mask, mean_k, block)
    n = torch.clamp(mask.sum(), min=1)
    mu = torch.sum(torch.where(mask, mean_d, 0.0)) / n
    var = torch.sum(torch.where(mask, (mean_d - mu) ** 2, 0.0)) / n
    return mask & (mean_d <= mu + stddev_mult * torch.sqrt(var))


def remove_statistical_outliers(cloud: CloudArrays, mean_k: int = 50,
                                stddev_mult: float = 1.0) -> CloudArrays:
    """PCL StatisticalOutlierRemoval (cloud.cpp:166-174): drop points whose
    mean distance to their mean_k nearest neighbors exceeds the global mean
    + stddev_mult * stddev; a point with fewer than mean_k live neighbors
    averages over those it has."""
    return _apply_mask(cloud, _outlier_mask(cloud.points, cloud.mask, mean_k,
                                            stddev_mult))


def fit_plane_ransac(points: torch.Tensor, mask: torch.Tensor,
                     generator: torch.Generator, dist_thresh: float = 0.01,
                     num_iters: int = 128):
    """RANSAC plane fit (pcl::SACSegmentation, cloud.cpp:407-435 and
    image_generator.cpp:101-129): ``num_iters`` planes through point
    triplets from ``draws.ransac_triplets``, all scored in one batched pass.
    Returns (inlier mask (N,), plane (4,) = [n, d] with n.x + d = 0) of the
    plane with the most inliers; degenerate triplets score -1."""
    trip = draws.ransac_triplets(generator, mask, num_iters)
    p0, p1, p2 = (points[trip[:, i]] for i in range(3))
    nvec = torch.linalg.cross(p1 - p0, p2 - p0)
    nlen = torch.linalg.norm(nvec, dim=1, keepdim=True)
    nvec = nvec / torch.clamp(nlen, min=1e-12)
    d = -torch.sum(nvec * p0, dim=1)
    dist = torch.abs(points @ nvec.T + d[None, :]).T        # (iters, N)
    inl = (dist <= dist_thresh) & mask[None, :]
    scores = torch.where(nlen[:, 0] < 1e-9, -1, inl.sum(dim=1))
    # A (1,) index, not a 0-dim one: indexing with a 0-dim tensor reads it
    # back to the host.
    best = torch.argmax(scores, dim=0, keepdim=True)
    return inl[best][0], torch.cat([nvec[best][0], d[best]])


def sample_above_plane(cloud: CloudArrays, generator: torch.Generator,
                       dist_thresh: float = 0.01) -> torch.Tensor:
    """Mask of the points off the dominant plane (cloud.cpp:407-435); the
    whole cloud when the fit leaves nothing, as the reference does."""
    inliers, _ = fit_plane_ransac(cloud.points, cloud.mask, generator,
                                  dist_thresh)
    above = cloud.mask & ~inliers
    return torch.where(above.any(), above, cloud.mask)


def subsample_uniform(generator: torch.Generator, candidate_mask: torch.Tensor,
                      num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``num_samples`` indices uniformly WITHOUT replacement from the
    masked set; returns (indices, valid_mask). Past the pool's size the
    slots come back with ``valid_mask=False`` (a deliberate divergence from
    the reference's with-replacement rand()%n, cloud.cpp:350-405)."""
    idx = draws.subsample(generator, candidate_mask, num_samples)
    total = candidate_mask.sum()
    valid = candidate_mask[idx] & (
        torch.arange(num_samples, device=idx.device) < total)
    return idx, valid
