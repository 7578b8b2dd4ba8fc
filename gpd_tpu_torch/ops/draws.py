"""Every random draw of the detection path, fed by a ``torch.Generator``.

gpd_tpu draws with ``jax.random`` (threefry), which a torch generator cannot
reproduce. Keeping the draws behind this one module lets a test substitute
JAX's numbers, and a later bit-exact threefry replace these functions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

SUM_OF_GAUSSIANS = 0
MAX_OF_GAUSSIANS = 1


def subsample(generator: torch.Generator, pool: torch.Tensor,
              num_samples: int) -> torch.Tensor:
    """``num_samples`` indices drawn uniformly WITHOUT replacement from the
    True entries of ``pool`` (N,), pool members first; past the pool's size
    the remaining slots hold non-members (callers mask them). The port of
    ``jax.random.choice(..., replace=False, p=pool/sum)`` in
    gpd_tpu/ops/preprocess.py:199."""
    n = pool.shape[0]
    if num_samples > n:
        raise ValueError(f"cannot draw {num_samples} samples without "
                         f"replacement from {n} slots")
    keys = torch.rand(n, generator=generator, device=generator.device)
    keys = torch.where(pool, keys.to(pool.device), 2.0)
    return torch.argsort(keys)[:num_samples]


def ransac_triplets(generator: torch.Generator, mask: torch.Tensor,
                    num_iters: int) -> torch.Tensor:
    """(num_iters, 3) point indices drawn WITH replacement, uniformly from
    the True entries of ``mask`` (N,) (from all N when none is True): the
    port of ``jax.random.choice(..., shape=(num_iters, 3), p=mask/sum)`` in
    gpd_tpu/ops/preprocess.py:171."""
    w = mask.to(torch.float32)
    w = w + (~mask.any()).to(torch.float32)
    idx = torch.multinomial(w.to(generator.device), 3 * num_iters,
                            replacement=True, generator=generator)
    return idx.to(mask.device).reshape(num_iters, 3)


def shadow_noise(generator: torch.Generator, num_samples: int,
                 num_cameras: int, k: int, n_sp: int, v_cap: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample shadow numbers for ``compute_shadows``, for ALL samples in
    original sample order (callers index rows by sample id, so results do
    not depend on how the sample axis is reordered or blocked):

      u:      (S, V, k, n_sp) uniform [0, 1) ray positions per camera;
      jitter: (S, v_cap) standard normal voxel jitter.
    """
    u = torch.rand((num_samples, num_cameras, k, n_sp), generator=generator,
                   device=generator.device)
    jitter = torch.randn((num_samples, v_cap), generator=generator,
                         device=generator.device)
    return u.to(device), jitter.to(device)


def _pick(generator: torch.Generator, mask: torch.Tensor,
          n: int) -> torch.Tensor:
    """(n,) indices drawn WITH replacement, uniformly from the True entries
    of ``mask``; every draw is slot 0 when none is True, as
    ``jax.random.choice(..., p=mask/sum)`` gives on an all-zero ``p``."""
    w = mask.to(torch.float32)
    w[0] += (~mask.any()).to(torch.float32)
    # torch.multinomial checks a single draw's weights on the host; two or
    # more draws with replacement read nothing back.
    idx = torch.multinomial(w.to(generator.device), max(n, 2),
                            replacement=True, generator=generator)
    return idx[:n].to(mask.device)


def _normal3(generator: torch.Generator, n: int, device) -> torch.Tensor:
    return torch.randn((n, 3), generator=generator,
                       device=generator.device).to(device)


def sum_of_gaussians(generator: torch.Generator, centers: torch.Tensor,
                     center_mask: torch.Tensor, sigma: float,
                     n: int) -> torch.Tensor:
    """drawSamplesFromSumOfGaussians (sequential_importance_sampling.cpp:
    189-201): a valid mixture center chosen uniformly with replacement, plus
    N(0, sigma^2 I) noise. The port of gpd_tpu/cem.py:69-77."""
    idx = _pick(generator, center_mask, n)
    return centers[idx] + _normal3(generator, n, centers.device) * sigma


def max_of_gaussians(generator: torch.Generator, centers: torch.Tensor,
                     center_mask: torch.Tensor, sigma: float, n: int,
                     oversample: int = 4) -> torch.Tensor:
    """drawSamplesFromMaxOfGaussians (.cpp:203-237) as one batched pass, the
    port of gpd_tpu/cem.py:80-114: ``oversample * n`` proposals drawn as in
    ``sum_of_gaussians``; a proposal is accepted iff no other valid center
    is closer than its own (the densities share their normalizer), with
    gpd_tpu's 1e-12 slack. Accepted draws come first (stable order); a
    shortfall is filled by resampling the accepted prefix uniformly with
    replacement over max(n_acc, 1) slots, so each fill is itself a draw
    from the accepted distribution."""
    m = n * oversample
    idx = _pick(generator, center_mask, m)
    x = centers[idx] + _normal3(generator, m, centers.device) * sigma
    d2 = torch.sum((x[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(center_mask[None, :], d2, torch.inf)
    d2_own = torch.sum((x - centers[idx]) ** 2, dim=-1)
    accept = d2_own <= torch.amin(d2, dim=1) + 1e-12
    order = torch.argsort(~accept, stable=True)
    n_acc = accept.sum()
    # Uniform integers on [0, max(n_acc, 1)) without a host read of n_acc.
    u = torch.rand(n, generator=generator, device=generator.device)
    span = torch.clamp(n_acc, min=1)
    fill = torch.minimum((u.to(x.device) * span).long(), span - 1)
    take = torch.where(torch.arange(n, device=x.device) < n_acc, order[:n],
                       order[fill])
    return x[take]


def uniform_cloud_samples(generator: torch.Generator, points: torch.Tensor,
                          pool_mask: torch.Tensor,
                          workspace: Sequence[float], n: int) -> torch.Tensor:
    """drawUniformSamples (.cpp:239-270): cloud points drawn uniformly with
    replacement from the pool inside the workspace, whose bounds are
    INCLUSIVE here (unlike the preprocessing filter). The port of
    gpd_tpu/cem.py:117-129."""
    w = workspace
    inside = pool_mask & \
        (points[:, 0] >= w[0]) & (points[:, 0] <= w[1]) & \
        (points[:, 1] >= w[2]) & (points[:, 1] <= w[3]) & \
        (points[:, 2] >= w[4]) & (points[:, 2] <= w[5])
    return points[_pick(generator, inside, n)]


def cem_round(generator: torch.Generator, centers: torch.Tensor,
              center_mask: torch.Tensor, points: torch.Tensor,
              pool_mask: torch.Tensor, sigma: float,
              workspace: Sequence[float], method: int, n_gauss: int,
              n_rand: int) -> torch.Tensor:
    """One importance-sampling round's sample positions (.cpp:112-157):
    ``n_gauss`` draws from the mixture (``method``: SUM_OF_GAUSSIANS or
    MAX_OF_GAUSSIANS) followed by ``n_rand`` uniform cloud draws, as
    gpd_tpu's ``_draw_round`` (gpd_tpu/cem.py:42-55) returns them."""
    draw = max_of_gaussians if method == MAX_OF_GAUSSIANS else sum_of_gaussians
    gs = draw(generator, centers, center_mask, sigma, n_gauss)
    us = uniform_cloud_samples(generator, points, pool_mask, workspace,
                               n_rand)
    return torch.cat([gs, us])
