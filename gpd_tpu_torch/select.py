"""Grasp filtering, selection and clustering (port of gpd_tpu/select.py).

Mask-based equivalents of the reference's filterGraspsWorkspace /
filterGraspsDirection / selectGrasps (src/gpd/grasp_detector.cpp:334-456)
and grasp clustering (src/gpd/clustering.cpp:5-105).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from gpd_tpu_torch import constant
from gpd_tpu_torch.core.types import Grasps


def filter_grasps_workspace(grasps: Grasps, workspace: Sequence[float],
                            min_aperture: float, max_aperture: float,
                            hand_outer_diameter: float,
                            hand_depth: float) -> Grasps:
    """Aperture + 5-keypoint workspace filter (grasp_detector.cpp:334-398),
    including the reference's right_top = left_bottom + depth*approach quirk
    (grasp_detector.cpp:362-363), so filter outcomes match."""
    pos = grasps.position
    binormal = grasps.binormal
    approach = grasps.approach
    half_w = 0.5 * hand_outer_diameter
    left_bottom = pos + half_w * binormal
    right_bottom = pos - half_w * binormal
    left_top = left_bottom + hand_depth * approach
    right_top = left_bottom + hand_depth * approach   # reference quirk
    appr = pos - 0.05 * approach
    pts = torch.stack([left_bottom, right_bottom, left_top, right_top, appr],
                      dim=1)                                       # (G, 5, 3)
    w = workspace
    lo = constant((w[0], w[2], w[4]), pos.device)
    hi = constant((w[1], w[3], w[5]), pos.device)
    inside = torch.all((torch.amin(pts, dim=1) >= lo) &
                       (torch.amax(pts, dim=1) <= hi), dim=-1)
    aperture_ok = (grasps.width >= min_aperture) & (grasps.width <= max_aperture)
    return dataclasses.replace(grasps, valid=grasps.valid & inside & aperture_ok)


def filter_grasps_direction(grasps: Grasps, direction: Sequence[float],
                            thresh_rad: float) -> Grasps:
    """Approach-direction filter (grasp_detector.cpp:422-456)."""
    d = constant(direction, grasps.position.device)
    d = d / torch.clamp(torch.linalg.vector_norm(d), min=1e-12)
    angle = torch.arccos(torch.clamp(grasps.approach @ d, -1.0, 1.0))
    return dataclasses.replace(grasps, valid=grasps.valid & (angle <= thresh_rad))


def select_top_k(grasps: Grasps, k: int, out_cap: int = 0
                 ) -> Tuple[Grasps, torch.Tensor]:
    """Top-k by score among valid grasps (grasp_detector.cpp:405-420).
    Returns (grasps reordered score-descending with only the top-k valid,
    the full permutation). ``out_cap`` > 0 truncates the returned batch to
    its leading out_cap rows (>= k)."""
    scores = torch.where(grasps.valid, grasps.score, -torch.inf)
    order = torch.argsort(-scores, stable=True)
    cap = grasps.capacity if out_cap <= 0 else min(out_cap, grasps.capacity)
    g = grasps.take(order[:cap])
    keep = torch.arange(cap, device=order.device) < k
    return dataclasses.replace(g, valid=g.valid & keep), order


def _pairs(pos, axis, valid):
    """(G, G) bool: hand j is an inlier of hand i's cluster: aligned axes,
    near, and close after projecting out i's axis; never i itself."""
    G = pos.shape[0]
    cos_thresh = math.cos(12.0 * math.pi / 180.0)
    MAX_DIST = 0.05
    PROJ_DIST = 0.005

    aligned = torch.abs(axis @ axis.T) > cos_thresh
    delta = pos[:, None, :] - pos[None, :, :]                 # (G, G, 3)
    dist_ok = torch.linalg.vector_norm(delta, dim=-1) <= MAX_DIST
    proj = delta - axis[:, None, :] * \
        torch.einsum("id,ijd->ij", axis, delta)[..., None]
    proj_ok = torch.linalg.vector_norm(proj, dim=-1) <= PROJ_DIST
    pair = aligned & dist_ok & proj_ok & valid[:, None] & valid[None, :]
    return pair & ~torch.eye(G, dtype=torch.bool, device=pos.device)


def _cluster_stats(inl, pos, score):
    """Inlier count, mean position and 99%-confidence lower bound of the
    mean score of each row's inliers ``inl`` (R, G). Sums run over the
    inliers only: invalid rows carry score -inf, and a product inl @ score
    would make 0 * -inf = NaN in every row (gpd_tpu's select.py:102 does,
    when fewer hands than the selection cap are valid). The variance is
    centred (two-pass): E[s^2] - E[s]^2 cancels in f32 for tight clusters
    (a 1-inlier cluster's std must be exactly 0)."""
    n = torch.sum(inl, dim=1)
    nf = torch.clamp(n, min=1).to(torch.float32)
    mean_pos = (inl.to(torch.float32) @ pos) / nf[:, None]
    mean_s = torch.sum(torch.where(inl, score[None, :], 0.0), dim=1) / nf
    d = score[None, :] - mean_s[:, None]
    var = torch.sum(torch.where(inl, d * d, 0.0), dim=1) / nf
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return n, mean_pos, mean_s - 2.576 * std / torch.sqrt(nf)


def _cluster_kernel(pos, axis, score, valid, min_inliers: int,
                    remove_inliers: bool = False):
    """Clustering (clustering.cpp): without ``remove_inliers`` every hand
    gathers its partners (the non-greedy form); with it, a greedy pass in
    hand order in which the inliers of an accepted cluster are unavailable
    to later ones (gpd_tpu/select.py:113-141). Returns (ok, mean position,
    confidence bound, inlier count); a rejected greedy hand keeps its own
    position and score."""
    pair = _pairs(pos, axis, valid)
    if not remove_inliers:
        n, mean_pos, conf_lb = _cluster_stats(pair, pos, score)
        return valid & (n >= min_inliers), mean_pos, conf_lb, n
    # One hand at a time on the device, no host read: it runs on the
    # selected hands only (num_selected rows).
    G = pos.shape[0]
    used = torch.zeros(G, dtype=torch.bool, device=pos.device)
    ok = torch.zeros_like(used)
    mp, cl = pos.clone(), score.clone()
    cnt = torch.zeros(G, dtype=torch.int64, device=pos.device)
    for i in range(G):
        inl = pair[i] & ~used
        n, mean_pos, conf = _cluster_stats(inl[None], pos, score)
        accept = valid[i] & (n[0] >= min_inliers)
        used = torch.where(accept, used | inl, used)
        ok[i] = accept
        mp[i] = torch.where(accept, mean_pos[0], pos[i])
        cl[i] = torch.where(accept, conf[0], score[i])
        cnt[i] = n[0]
    return ok, mp, cl, cnt


def cluster_grasps(grasps: Grasps, min_inliers: int,
                   remove_inliers: bool = False) -> Grasps:
    """Grasp NMS/aggregation (clustering.cpp:5-105): a cluster center keeps
    hand i's orientation, takes the mean inlier position, and scores by the
    99%-confidence lower bound mean - 2.576 sigma / sqrt(n);
    ``remove_inliers`` takes the greedy form."""
    ok, mean_pos, conf_lb, _ = _cluster_kernel(
        grasps.position, grasps.axis, grasps.score, grasps.valid, min_inliers,
        remove_inliers)
    return dataclasses.replace(
        grasps,
        position=torch.where(ok[:, None], mean_pos, grasps.position),
        score=torch.where(ok, conf_lb, grasps.score),
        valid=ok)


def sort_by_score(grasps: Grasps) -> Grasps:
    """Final score-descending ordering (grasp_detector.cpp:305)."""
    scores = torch.where(grasps.valid, grasps.score, -torch.inf)
    return grasps.take(torch.argsort(-scores, stable=True))
