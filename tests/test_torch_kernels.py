"""The port's kernel wrappers, without JAX: argument checks and the CPU
dispatch here, and each CUDA kernel against its plain version on the card
(marked ``cuda``; skips without a card). On a machine with a card:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from gpd_tpu_torch.ops import images as img

SIZE = 60


def raster_operands(rng, G, K, nval):
    idx = rng.integers(0, SIZE, (G, 4, K)).astype(np.int32)
    inside = rng.random((G, 1, K)) < 0.6
    idx = np.where(inside, idx, SIZE).astype(np.int32)
    vals = (rng.random((G, nval, K)) * inside).astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(vals).to(torch.bfloat16)


def test_raster_wrapper_checks_and_cpu_dispatch():
    mi, mv = raster_operands(np.random.default_rng(3), 2, 128, 6)
    before = img.raster_blocks.launches
    out = img.raster_blocks(mi, mv, size=SIZE)
    assert torch.equal(out, img.raster_blocks_ref(mi, mv, size=SIZE))
    assert img.raster_blocks.launches == before     # no kernel on the CPU
    with pytest.raises(ValueError):
        img.raster_blocks(mi, mv.float(), size=SIZE)
    with pytest.raises(ValueError):
        img.raster_blocks(mi[:, :3], mv, size=SIZE)
    with pytest.raises(ValueError):
        img.raster_blocks(mi, mv, mi, None, size=SIZE)
    with pytest.raises(ValueError):
        img.raster_blocks(mi.transpose(0, 2).contiguous().transpose(0, 2), mv,
                          size=SIZE)
    with pytest.raises(ValueError):
        img.raster_blocks(mi, mv, size=200)          # planes exceed smem


@pytest.mark.cuda
@pytest.mark.parametrize("with_shadow", [True, False])
def test_raster_kernel_matches_plain_version_on_card(with_shadow):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    rng = np.random.default_rng(4)
    mi, mv = raster_operands(rng, 64, 2048, 6)
    si, sv = raster_operands(rng, 64, 2048, 3)
    args = [t.cuda() for t in (mi, mv, si, sv)]
    if not with_shadow:
        args[2:] = [None, None]
    before = img.raster_blocks.launches
    out = img.raster_blocks(*args, size=SIZE)
    ref = img.raster_blocks_ref(*args, size=SIZE)
    assert img.raster_blocks.launches == before + 1
    counts = [4, 9, 14] + ([16, 18, 20] if with_shadow else [])
    assert torch.equal(out[:, counts], ref[:, counts])
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
