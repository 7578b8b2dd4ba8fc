"""Local (Darboux) reference frames (port of gpd_tpu/ops/frames.py:33).

``FrameEstimator::calculateLocalFrames`` + ``LocalFrame::findAverageNormalAxis``
(reference: src/gpd/candidate/frame_estimator.cpp:6-98,
local_frame.cpp:14-40): M = N N^T over every in-radius normal as one masked
moment matmul, the closed-form 3x3 eigensolver, and the sign fix against
the mean neighborhood normal.

Frame columns: [normal, binormal, curvature_axis] with
binormal = curvature_axis x normal (right-handed, det +1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gpd_tpu_torch.ops.eigh3 import eigh3_sym
from gpd_tpu_torch.ops.neighbors import radius_moments


def estimate_frames(sample_pos: torch.Tensor, sample_mask: torch.Tensor,
                    points: torch.Tensor, points_mask: torch.Tensor,
                    normals: torch.Tensor, radius: float, k: int = 64,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local frames at sample positions.

    ``k`` is accepted and unused, as in gpd_tpu: the moment matmul covers
    every in-radius neighbor (frame_estimator.cpp:74).

    Returns:
      frames: (S, 3, 3) with columns [normal, binormal, curvature_axis].
      valid: (S,) bool, sample had >= 1 neighbor within radius
        (frame_estimator.cpp:74-86).
    """
    del k
    n = normals
    feats = torch.stack([
        n[:, 0] * n[:, 0], n[:, 1] * n[:, 1], n[:, 2] * n[:, 2],
        n[:, 0] * n[:, 1], n[:, 0] * n[:, 2], n[:, 1] * n[:, 2],
        n[:, 0], n[:, 1], n[:, 2],
    ], dim=1)                                           # (N, 9)
    sums, counts = radius_moments(sample_pos, sample_mask, points,
                                  points_mask, feats, radius)
    xx, yy, zz, xy, xz, yz = (sums[:, i] for i in range(6))
    M = torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([xy, yy, yz], dim=-1),
        torch.stack([xz, yz, zz], dim=-1),
    ], dim=-2)                                          # (S, 3, 3)
    _, V = eigh3_sym(M)
    curvature = V[..., :, 0]                            # min eigenvalue
    normal = V[..., :, 2]                               # max eigenvalue

    flip = torch.sum(sums[:, 6:9] * normal, dim=-1) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    binormal = torch.linalg.cross(curvature, normal, dim=-1)

    frames = torch.stack([normal, binormal, curvature], dim=-1)
    return frames, sample_mask & (counts > 0)
