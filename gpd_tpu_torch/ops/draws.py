"""Every random draw of the detection path, fed by a ``torch.Generator``.

gpd_tpu draws with ``jax.random`` (threefry), which a torch generator cannot
reproduce. Keeping the draws behind this one module lets a test substitute
JAX's numbers, and a later bit-exact threefry replace these functions.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
