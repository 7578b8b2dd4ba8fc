"""Batched closed-form 3x3 symmetric eigendecomposition (port of
gpd_tpu/ops/eigh3.py:21-95).

The same closed form as the JAX package, not ``torch.linalg.eigh``, whose
eigenvector order and signs differ: eigenvalues from the trigonometric
solution of the characteristic polynomial, eigenvectors from cross products
of the best-conditioned rows of (A - lambda I), with a fallback for
(near-)degenerate spectra.
"""

from __future__ import annotations

import math

import torch

from gpd_tpu_torch import constant

_EPS = 1e-12


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def eigvals3_sym(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending."""
    A = 0.5 * (A + A.transpose(-1, -2))
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))
    r = detB / (2.0 * torch.clamp(p, min=_EPS) ** 3)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    big = q + 2.0 * p * torch.cos(phi)
    small = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    mid = 3.0 * q - big - small
    return torch.stack([small, mid, big], dim=-1)


def _eigvec(A: torch.Tensor, lam: torch.Tensor,
            fallback: torch.Tensor) -> torch.Tensor:
    """One eigenvector of symmetric A for eigenvalue lam via row cross
    products; ``fallback`` where the eigenspace is (near-)degenerate."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)],
                        dim=-2)                              # (..., 3, 3)
    norms = torch.sum(cands * cands, dim=-1)                 # (..., 3)
    nbest, best = torch.max(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    v = torch.where((nbest > _EPS)[..., None], v, fallback)
    return v / torch.clamp(_norm(v), min=_EPS)


def eigh3_sym(A: torch.Tensor):
    """Full decomposition of symmetric (..., 3, 3) matrices.

    Returns (eigenvalues ascending (..., 3), eigenvectors (..., 3, 3) with
    column i for eigenvalue i). Robust to rank-deficient and isotropic
    inputs (both common for normal outer-product sums).
    """
    A = 0.5 * (A + A.transpose(-1, -2))
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)), min=_EPS)
    An = A / scale[..., None, None]
    w = eigvals3_sym(An)

    ex = constant((1.0, 0.0, 0.0), An.device, An.dtype).expand(
        An[..., 0, :].shape)
    v2 = _eigvec(An, w[..., 2], ex)              # largest: best conditioned
    # Second vector: orthogonalize against v2 for stability.
    v0_raw = _eigvec(An, w[..., 0], _perp(v2))
    v0 = v0_raw - torch.sum(v0_raw * v2, dim=-1, keepdim=True) * v2
    v0 = torch.where(_norm(v0) < 1e-6, _perp(v2), v0)
    v0 = v0 / torch.clamp(_norm(v0), min=_EPS)
    v1 = _cross(v2, v0)

    V = torch.stack([v0, v1, v2], dim=-1)
    return w * scale[..., None], V


def _perp(v: torch.Tensor) -> torch.Tensor:
    """A unit vector perpendicular to v: v crossed with the basis axis least
    aligned with it."""
    ax = torch.argmin(torch.abs(v), dim=-1)
    e = torch.eye(3, dtype=v.dtype, device=v.device)[ax]
    p = _cross(v, e)
    return p / torch.clamp(_norm(p), min=_EPS)
