"""Fixed-radius neighbor search (port of gpd_tpu/ops/neighbors.py).

Replaces the reference's PCL kd-tree ``radiusSearch`` calls with dense
tensor work:

    dist^2(q, p) = |q|^2 + |p|^2 - 2 q . p

The cross term is a (Q, 3) x (3, N) matmul in full float32. Ties break
toward the lower index, as ``lax.top_k`` does: a stable sort gives that,
``torch.topk`` does not promise it, and on voxel grids equal distances are
common.

gpd_tpu's nearest-K selection has two routes: ``exact=True`` (or
``FORCE_EXACT``) takes ``lax.top_k``; ``exact=False`` takes
``lax.approx_min_k`` / ``approx_max_k`` on every backend but the CPU
(``_use_approx``). Only the TPU lowers those to an approximate selection:
off a TPU they fall back to sort and slice (jax/_src/lax/ann.py:16-17, the
TPU lowering registered for ``platform='tpu'`` only, :398-401), an exact
selection. So on the card both of gpd_tpu's routes select the true nearest
k, and the port runs the same stable sort for either. (The fallback's sort
is not marked stable, so where equal values straddle the k-th place XLA
leaves the order of their indices open; the stable order is
``lax.top_k``'s.)
"""

from __future__ import annotations

import os
from typing import Tuple

import torch


_BIG = 1e12

# gpd_tpu's switch that sends every nearest-K selection to the exact route
# (gpd_tpu/ops/neighbors.py:34), read from the same variable. In the port
# both routes compute the same selection, so it changes only what
# ``_use_approx`` reports.
FORCE_EXACT = os.environ.get("GPD_TPU_EXACT_NEIGHBORS", "") == "1"


def _use_approx(device) -> bool:
    """gpd_tpu's backend rule (gpd_tpu/ops/neighbors.py:37-48): whether a
    call with ``exact=False`` on ``device`` takes gpd_tpu's approximate
    route, i.e. on every device but the CPU unless ``FORCE_EXACT``. On a
    GPU that route is the exact sort and slice (module docstring)."""
    return (not FORCE_EXACT) and torch.device(device).type != "cpu"


def select_min_k(d2: torch.Tensor, k: int, exact: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k of each row of ``d2``: (vals, idx), ascending, ties toward
    the lower index. ``exact`` is gpd_tpu's route choice; both routes give
    the true nearest k (module docstring)."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def select_max_k(x: torch.Tensor, k: int, exact: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k of each row of ``x``: (vals, idx), descending, ties toward
    the lower index; ``exact`` as in select_min_k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sum_sq3(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over a last axis of 3, as a chain of fused multiply-adds: the
    rounding of the fused reduction inside gpd_tpu's jitted programs, so
    distance ties order the same way in both packages."""
    acc = x[..., 0] * x[..., 0]
    acc = torch.addcmul(acc, x[..., 1], x[..., 1])
    return torch.addcmul(acc, x[..., 2], x[..., 2])


def _dist2(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    p2 = sum_sq3(points)
    q2 = sum_sq3(query)
    cross = query @ points.T
    return q2[:, None] + p2[None, :] - 2.0 * cross


def radius_mask(query: torch.Tensor, query_mask: torch.Tensor,
                points: torch.Tensor, points_mask: torch.Tensor,
                radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) in-radius membership mask + squared distances: the sort-free
    case of radius_neighbors for callers that keep the whole cloud as every
    query's neighborhood (identity indexing)."""
    d2 = _dist2(query, points)
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    valid = (d2 <= r2) & points_mask[None, :] & query_mask[:, None]
    return valid, d2


def _block_topk(qpos, qmask, points, pmask, k: int):
    """One block: (B, 3) queries vs (N, 3) points -> (B, k) idx + dist2."""
    d2 = _dist2(qpos, points)
    d2 = torch.where(pmask[None, :], d2, _BIG)
    d2 = torch.where(qmask[:, None], d2, _BIG)
    d2k, idx = select_min_k(d2, k)
    return idx, d2k


def radius_neighbors(query: torch.Tensor, query_mask: torch.Tensor,
                     points: torch.Tensor, points_mask: torch.Tensor,
                     radius: float, k: int, block: int = 1024,
                     exact: bool = False,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded exact radius search (``exact``: gpd_tpu's route choice, the
    same selection either way; see select_min_k).

    Returns (idx, valid): (Q, k) int64 neighbor indices sorted by distance
    ascending, and (Q, k) bool marking entries within ``radius`` (inclusive,
    PCL semantics). A cap covering the whole cloud returns identity indices
    with an in-radius mask and sorts nothing. Queries run in blocks of
    ``block`` rows to bound the (B, N) distance matrix; a query set that
    fits one block is not padded.
    """
    q = query.shape[0]
    n = points.shape[0]
    k_eff = min(k, n)
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2

    if k_eff == n:
        valid, _ = radius_mask(query, query_mask, points, points_mask, radius)
        idx = torch.arange(n, device=query.device).expand(q, n)
        if k > n:
            idx = torch.nn.functional.pad(idx, (0, k - n))
            valid = torch.nn.functional.pad(valid, (0, k - n))
        return idx, valid

    if q <= block:
        idx, d2 = _block_topk(query, query_mask, points, points_mask, k_eff)
    else:
        parts = [_block_topk(query[i:i + block], query_mask[i:i + block],
                             points, points_mask, k_eff)
                 for i in range(0, q, block)]
        idx = torch.cat([p[0] for p in parts])
        d2 = torch.cat([p[1] for p in parts])
    if k_eff < k:
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
        d2 = torch.nn.functional.pad(d2, (0, k - k_eff), value=_BIG)
    valid = (d2 <= r2) & query_mask[:, None]
    return idx, valid


def radius_moments(query: torch.Tensor, query_mask: torch.Tensor,
                   points: torch.Tensor, points_mask: torch.Tensor,
                   feats: torch.Tensor, radius: float, block: int = 1024,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query sums of per-point features over ALL in-radius neighbors:

        out[q] = sum_p [d2(q, p) <= r^2] * feats[p]  =  W @ feats

    exact and uncapped (the reference's kd-tree semantics,
    frame_estimator.cpp:74 / cloud.cpp:497-535), with no gather and no
    sort. Queries run in blocks to bound the (B, N) mask.

    Returns (sums (Q, F), counts (Q,)); both 0 where the query is masked.
    """
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2

    def one_block(qpos, qmask):
        d2 = _dist2(qpos, points)
        w = ((d2 <= r2) & points_mask[None, :]
             & qmask[:, None]).to(feats.dtype)
        return w @ feats, torch.sum(w, dim=1)

    q = query.shape[0]
    if q <= block:
        return one_block(query, query_mask)
    parts = [one_block(query[i:i + block], query_mask[i:i + block])
             for i in range(0, q, block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def gather_neighborhoods(idx: torch.Tensor, valid: torch.Tensor, *arrays):
    """Per-neighbor attributes: each (N, ...) array gathered at ``idx``
    (Q, K) into (Q, K, ...); one array comes back alone, several as a tuple
    (gpd_tpu/ops/neighbors.py:237-243). ``valid`` is not read, as in
    gpd_tpu: callers mask with it."""
    out = tuple(a[idx] for a in arrays)
    return out if len(out) > 1 else out[0]
