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

``radius_moments`` (the normals' and frames' in-radius sums) runs on a card
as one hand-written kernel, csrc/radius_moments.cu, which writes no (Q, N)
tensor and takes d2 as the direct difference |q - p|^2;
``radius_moments_ref`` keeps the dense route above for CPU tensors.
``outlier_knn`` (the outlier filter's mean distance to the k nearest) does
the same with csrc/outlier_knn.cu and ``outlier_knn_ref``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import numpy as np
import torch

from gpd_tpu_torch.ops import _build


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


def radius_moments_ref(query: torch.Tensor, query_mask: torch.Tensor,
                       points: torch.Tensor, points_mask: torch.Tensor,
                       feats: torch.Tensor, radius: float, block: int = 1024,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """radius_moments' plain version, the route of CPU tensors: queries in
    blocks of ``block`` rows, each a (B, N) in-radius mask from ``_dist2``
    and one product with the features (gpd_tpu's body,
    gpd_tpu/ops/neighbors.py:176)."""
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


# Features a point the kernel takes (csrc/radius_moments.cu, kMaxF).
MOMENT_MAX_FEATURES = 12
# The kernel's point partitions: enough (query warps x partitions) to give
# every SM this many warps, at most this many partitions.
_MOMENT_WARPS_PER_SM = 32
_MOMENT_MAX_SPLITS = 64
_MOMENT_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                    + [ctypes.c_float])


def _check_moment_operands(query, query_mask, points, points_mask, feats):
    Q, N = query.shape[0], points.shape[0]
    F = feats.shape[-1] if feats.dim() == 2 else -1
    want = {"query": (query, (Q, 3)), "points": (points, (N, 3)),
            "feats": (feats, (N, F))}
    for name, (t, shape) in want.items():
        if t.dim() != 2 or t.shape != shape or not t.is_floating_point():
            raise ValueError(f"{name} must be floating {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if len({query.dtype, points.dtype, feats.dtype}) != 1:
        raise ValueError(f"query, points and feats must share one dtype, "
                         f"got {query.dtype}, {points.dtype}, {feats.dtype}")
    for name, t, n in (("query_mask", query_mask, Q),
                       ("points_mask", points_mask, N)):
        if t.dtype != torch.bool or t.shape != (n,):
            raise ValueError(f"{name} must be bool ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    tensors = (query, query_mask, points, points_mask, feats)
    if any(t.device != query.device for t in tensors):
        raise ValueError("radius_moments operands must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("radius_moments operands must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def moment_splits(Q: int, N: int, sms: int) -> int:
    """The kernel's point partitions P for Q queries over N points on a
    card of ``sms`` SMs: query warps x P near ``_MOMENT_WARPS_PER_SM``
    warps an SM, at most one partition a 32-point group."""
    warps = max(1, -(-Q // 32))
    groups = max(1, -(-N // 32))
    want = -(-_MOMENT_WARPS_PER_SM * sms // warps)
    return max(1, min(groups, _MOMENT_MAX_SPLITS, want))


def _radius_moments_cuda(query, query_mask, points, points_mask, feats,
                         radius: float, probe=None):
    """One launch of csrc/radius_moments.cu (its boxes, sweep and sum
    kernels); ``probe``, a ``(cull, groups)`` pair, launches its probe
    (``radius_moments_probe``) instead."""
    Q, N, F = query.shape[0], points.shape[0], feats.shape[1]
    dev = query.device
    P = moment_splits(Q, N, _sm_count(dev.index if dev.index is not None
                                      else torch.cuda.current_device()))
    boxes = torch.empty((max(1, -(-N // 32)), 2, 4), dtype=torch.float32,
                        device=dev)
    part = torch.empty((P, F + 1, Q), dtype=torch.float32, device=dev)
    sums = torch.empty((Q, F), dtype=torch.float32, device=dev)
    counts = torch.empty((Q,), dtype=torch.float32, device=dev)
    r2 = float(np.float32(radius) * np.float32(radius))
    args = (query.data_ptr(), query_mask.data_ptr(), points.data_ptr(),
            points_mask.data_ptr(), feats.data_ptr(), boxes.data_ptr(),
            part.data_ptr(), sums.data_ptr(), counts.data_ptr(), Q, N, F, P,
            r2)
    if probe is None:
        _build.launch("radius_moments", "radius_moments",
                      "radius_moments_launch", _MOMENT_ARGTYPES, dev, *args)
    else:
        cull, groups = probe
        _build.launch("radius_moments_probe", "radius_moments",
                      "radius_moments_probe_launch",
                      _MOMENT_ARGTYPES + [ctypes.c_int, ctypes.c_void_p],
                      dev, *args, int(cull), groups.data_ptr())
    return sums, counts


def radius_moments_probe(query: torch.Tensor, query_mask: torch.Tensor,
                         points: torch.Tensor, points_mask: torch.Tensor,
                         feats: torch.Tensor, radius: float,
                         cull: bool = True):
    """The kernel's sweep compiled with counts, for tests and measurements
    on a card: ``(sums, counts, judged, swept)``, where the sums and counts
    are ``radius_moments``' bit for bit and ``judged`` and ``swept`` count
    the (32-query warp, 32-point group) pairs that warps with a live query
    judge and sweep. ``cull`` False sweeps every group. Counted in
    ``_build.LAUNCHES`` as ``radius_moments_probe``."""
    _check_moment_operands(query, query_mask, points, points_mask, feats)
    if query.device.type != "cuda" or query.dtype != torch.float32:
        raise ValueError("radius_moments_probe takes float32 CUDA tensors")
    groups = torch.zeros(2, dtype=torch.int64, device=query.device)
    sums, counts = _radius_moments_cuda(query, query_mask, points,
                                        points_mask, feats, radius,
                                        probe=(cull, groups))
    judged, swept = groups.tolist()
    return sums, counts, judged, swept


def radius_moments(query: torch.Tensor, query_mask: torch.Tensor,
                   points: torch.Tensor, points_mask: torch.Tensor,
                   feats: torch.Tensor, radius: float, block: int = 1024,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query sums of per-point features over ALL in-radius neighbors:

        out[q] = sum_p [d2(q, p) <= r^2] * feats[p]  =  W @ feats

    exact and uncapped (the reference's kd-tree semantics,
    frame_estimator.cpp:74 / cloud.cpp:497-535), with no gather and no
    sort. r^2 is the float32 radius squared in float32.

    Returns (sums (Q, F), counts (Q,)); both 0 where the query is masked.

    CUDA tensors (float32, 1 <= F <= ``MOMENT_MAX_FEATURES``) launch the
    kernel in csrc/radius_moments.cu (built at first use; its header notes
    the bound on the H100 and the design): no (Q, N) tensor, d2 as the
    direct difference |q - p|^2. CPU tensors take ``radius_moments_ref``,
    in blocks of ``block`` queries.
    """
    _check_moment_operands(query, query_mask, points, points_mask, feats)
    if query.device.type == "cpu":
        return radius_moments_ref(query, query_mask, points, points_mask,
                                  feats, radius, block)
    if query.device.type != "cuda":
        raise ValueError(f"radius_moments runs on cuda or cpu, not "
                         f"{query.device}")
    if query.dtype != torch.float32:
        raise ValueError(f"the radius_moments kernel takes float32, not "
                         f"{query.dtype}")
    if not 1 <= feats.shape[1] <= MOMENT_MAX_FEATURES:
        raise ValueError(f"the radius_moments kernel takes 1-"
                         f"{MOMENT_MAX_FEATURES} features, not "
                         f"{feats.shape[1]}")
    return _radius_moments_cuda(query, query_mask, points, points_mask,
                                feats, radius)


def outlier_knn_ref(points: torch.Tensor, mask: torch.Tensor, mean_k: int,
                    block: int = 1024) -> torch.Tensor:
    """outlier_knn's plain version, the route of CPU tensors (gpd_tpu's
    ``_outlier_kernel`` body, gpd_tpu/ops/preprocess.py:102-130): queries
    in blocks of ``block`` rows, each a (B, N) ``_dist2`` matrix with
    masked pairs at 1e12, its ``mean_k + 1`` smallest values (at most N),
    the smallest (self) dropped, the rest below 1e11 averaged."""
    k1 = min(mean_k + 1, points.shape[0])

    def mean_dist(bq, bm):
        d2 = _dist2(bq, points)
        d2 = torch.where(mask[None, :] & bm[:, None], d2, _BIG)
        d2k = torch.topk(d2, k1, dim=1, largest=False,
                         sorted=True).values[:, 1:]     # [0] is self
        v_k = d2k < 1e11
        d_k = torch.sqrt(torch.clamp(d2k, min=0.0))
        return torch.sum(torch.where(v_k, d_k, 0.0), dim=1) / \
            torch.clamp(torch.sum(v_k, dim=1), min=1)

    return torch.cat([mean_dist(points[i:i + block], mask[i:i + block])
                      for i in range(0, points.shape[0], block)])


# The most neighbours (mean_k + 1, self included) the outlier kernel keeps
# a point (csrc/outlier_knn.cu, kMaxKept: two list slots a lane).
KNN_MAX_KEPT = 64
_KNN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2


def _check_knn_operands(points, mask, mean_k):
    N = points.shape[0]
    if points.dim() != 2 or points.shape != (N, 3) or \
            not points.is_floating_point():
        raise ValueError(f"points must be floating (N, 3), got "
                         f"{points.dtype} {tuple(points.shape)}")
    if mask.dtype != torch.bool or mask.shape != (N,):
        raise ValueError(f"mask must be bool ({N},), got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device != points.device:
        raise ValueError("outlier_knn operands must lie on one device")
    if isinstance(mean_k, bool) or not isinstance(mean_k, int) or mean_k < 0:
        raise ValueError(f"mean_k must be an int >= 0, not {mean_k!r}")


def _outlier_knn_cuda(points, mask, mean_k: int, probe=None):
    """One launch of csrc/outlier_knn.cu (its packing and boxes, then the
    sweep); ``probe``, a ``(cull, counts, bound_sum)`` triple, launches its
    probe (``outlier_knn_probe``) instead."""
    N, dev = points.shape[0], points.device
    G = max(1, -(-N // 32))
    packed = torch.empty((G * 32, 4), dtype=torch.float32, device=dev)
    boxes = torch.empty((G, 2, 4), dtype=torch.float32, device=dev)
    spans = torch.empty((-(-G // 32), 2, 4), dtype=torch.float32, device=dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    args = (points.data_ptr(), mask.data_ptr(), packed.data_ptr(),
            boxes.data_ptr(), spans.data_ptr(), out.data_ptr(), N,
            mean_k + 1)
    if probe is None:
        _build.launch("outlier_knn", "outlier_knn", "outlier_knn_launch",
                      _KNN_ARGTYPES, dev, *args)
    else:
        cull, counts, bound_sum = probe
        _build.launch("outlier_knn_probe", "outlier_knn",
                      "outlier_knn_probe_launch",
                      _KNN_ARGTYPES + [ctypes.c_int] + [ctypes.c_void_p] * 2,
                      dev, *args, int(cull), counts.data_ptr(),
                      bound_sum.data_ptr())
    return out


def _check_knn_cuda(points, mask, mean_k):
    if not (points.is_contiguous() and mask.is_contiguous()):
        raise ValueError("the outlier_knn kernel takes contiguous operands")
    if points.dtype != torch.float32:
        raise ValueError(f"the outlier_knn kernel takes float32, not "
                         f"{points.dtype}")
    if mean_k + 1 > KNN_MAX_KEPT:
        raise ValueError(f"the outlier_knn kernel keeps at most "
                         f"{KNN_MAX_KEPT} neighbours (mean_k + 1), not "
                         f"{mean_k + 1}")


def outlier_knn_probe(points: torch.Tensor, mask: torch.Tensor, mean_k: int,
                      cull: bool = True):
    """The kernel's sweep compiled with counts, for tests and measurements
    on a card: ``(mean_d, judged, swept, mean_bound)``, where ``mean_d`` is
    ``outlier_knn``'s bit for bit, ``judged`` and ``swept`` count the
    (query, 32-point group) pairs whose group box was tested and that were
    swept, and ``mean_bound`` is the mean over the live queries with
    ``mean_k + 1`` live points of their final bound, the (mean_k + 1)-th
    smallest squared distance (None where there is none). ``cull`` False
    sweeps every group. Counted in ``_build.LAUNCHES`` as
    ``outlier_knn_probe``."""
    _check_knn_operands(points, mask, mean_k)
    if points.device.type != "cuda":
        raise ValueError("outlier_knn_probe takes CUDA tensors")
    _check_knn_cuda(points, mask, mean_k)
    counts = torch.zeros(3, dtype=torch.int64, device=points.device)
    bound_sum = torch.zeros(1, dtype=torch.float64, device=points.device)
    mean_d = _outlier_knn_cuda(points, mask, mean_k,
                               probe=(cull, counts, bound_sum))
    judged, swept, filled = counts.tolist()
    mean_bound = bound_sum.item() / filled if filled else None
    return mean_d, judged, swept, mean_bound


def outlier_knn(points: torch.Tensor, mask: torch.Tensor, mean_k: int,
                block: int = 1024) -> torch.Tensor:
    """Each unmasked point's mean Euclidean distance to its ``mean_k``
    nearest other unmasked points (PCL's StatisticalOutlierRemoval
    statistic, cloud.cpp:166-174): the ``mean_k + 1`` smallest squared
    distances, the smallest (self) dropped; a point with fewer live
    neighbours averages over those it has; 0 where masked. Returns (N,).

    CUDA tensors (float32, ``mean_k + 1 <= KNN_MAX_KEPT``) launch the
    kernel in csrc/outlier_knn.cu (built at first use; its header notes
    the bound on the H100 and the design): no (N, N) tensor, d2 as the
    direct difference |q - p|^2, the kept distances added in ascending
    order. CPU tensors take ``outlier_knn_ref``, in blocks of ``block``
    queries.
    """
    _check_knn_operands(points, mask, mean_k)
    if points.device.type == "cpu":
        return outlier_knn_ref(points, mask, mean_k, block)
    if points.device.type != "cuda":
        raise ValueError(f"outlier_knn runs on cuda or cpu, not "
                         f"{points.device}")
    _check_knn_cuda(points, mask, mean_k)
    return _outlier_knn_cuda(points, mask, mean_k)


def gather_neighborhoods(idx: torch.Tensor, valid: torch.Tensor, *arrays):
    """Per-neighbor attributes: each (N, ...) array gathered at ``idx``
    (Q, K) into (Q, K, ...); one array comes back alone, several as a tuple
    (gpd_tpu/ops/neighbors.py:237-243). ``valid`` is not read, as in
    gpd_tpu: callers mask with it."""
    out = tuple(a[idx] for a in arrays)
    return out if len(out) > 1 else out[0]
