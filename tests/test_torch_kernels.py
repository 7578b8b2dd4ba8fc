"""The port's kernel wrappers, without JAX: argument checks and the CPU
dispatch here, and each CUDA kernel against its plain version on the card
(marked ``cuda``; skips without a card). On a machine with a card:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from gpd_tpu_torch.ops import images as img
from test_torch_threads import set_cpu_share

set_cpu_share()

SIZE = 60


def raster_operands(rng, G, K, nval, size=SIZE):
    idx = rng.integers(0, size, (G, 4, K)).astype(np.int32)
    inside = rng.random((G, 1, K)) < 0.6
    idx = np.where(inside, idx, size).astype(np.int32)
    vals = (rng.random((G, nval, K)) * inside).astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(vals).to(torch.bfloat16)


def sums_operands(rng, G, K, Cp, size=SIZE):
    """Two row sets, columns and pre-masked values with the count last;
    ~60% of entries in the image, the rest on the sentinel."""
    inside = rng.random((G, K)) < 0.6
    ra, rb, cols = (np.where(inside, rng.integers(0, size, (G, K)), size)
                    .astype(np.int32) for _ in range(3))
    m = inside.astype(np.float32)[..., None]
    aug = np.concatenate([rng.random((G, K, Cp - 1)) * m, m], -1)
    return [torch.from_numpy(a) for a in (ra, rb, cols,
                                          aug.astype(np.float32))]


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


@pytest.mark.parametrize("two", [False, True])
def test_sums_wrapper_checks_and_cpu_dispatch(two):
    ra, rb, cols, aug = sums_operands(np.random.default_rng(5), 3, 200, 4)
    rows = (ra, rb) if two else (ra,)
    fn = img.raster_sums2 if two else img.raster_sums
    ref = img.raster_sums2_ref if two else img.raster_sums_ref

    def call(cols=cols, aug=aug, size=SIZE):
        return fn(*rows, cols, aug, size)
    before = fn.launches
    out = call()
    assert torch.equal(out, ref(*rows, cols, aug, SIZE))
    assert out.shape == ((3, 2, SIZE, SIZE, 4) if two else (3, SIZE, SIZE, 4))
    assert fn.launches == before                    # no kernel on the CPU
    with pytest.raises(ValueError):                 # dtype
        call(aug=aug.double())
    with pytest.raises(ValueError):
        call(cols=cols.long())
    with pytest.raises(ValueError):                 # shape
        call(cols=cols[:, :100])
    with pytest.raises(ValueError):
        call(aug=aug[..., :0].contiguous())
    with pytest.raises(ValueError):                 # contiguity
        call(aug=aug.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):                 # one device
        call(aug=aug.to("meta"))
    with pytest.raises(ValueError):                 # shared memory
        call(size=130 if two else 200)
    assert fn.launches == before


# The persistent kernels' ragged cases: a single hand, a hand count that
# leaves blocks with unequal runs of items, and K that is short, not a
# multiple of 4 (one point at a time), or above 2048; plus the main path's
# K = 2048.
RAGGED_G = [1, 133, 256]
RAGGED_K = [200, 2047, 2048, 3072]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("G", RAGGED_G)
@pytest.mark.parametrize("K", RAGGED_K)
@pytest.mark.parametrize("two,Cp", [(False, 2), (False, 4), (False, 6),
                                    (True, 2), (True, 3), (True, 4),
                                    (True, 6), (True, 8)])
def test_sums_kernel_matches_plain_version_on_card(two, Cp, K, G):
    """Counts exactly equal, values within the f32 reordering tolerance;
    twice, so a store that overtook the additions would show."""
    needs_card()
    ra, rb, cols, aug = (t.cuda() for t in sums_operands(
        np.random.default_rng(Cp), G, K, Cp))
    rows = (ra, rb) if two else (ra,)
    fn = img.raster_sums2 if two else img.raster_sums
    ref = img.raster_sums2_ref if two else img.raster_sums_ref
    expect = ref(*rows, cols, aug, SIZE)
    before = fn.launches
    for _ in range(2):
        out = fn(*rows, cols, aug, SIZE)
        torch.cuda.synchronize()
        assert torch.equal(out[..., -1], expect[..., -1])
        torch.testing.assert_close(out, expect, atol=1e-3, rtol=1e-5)
    assert fn.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("G", RAGGED_G)
@pytest.mark.parametrize("K", RAGGED_K)
@pytest.mark.parametrize("with_shadow", [True, False])
def test_raster_kernel_matches_plain_version_on_card(with_shadow, K, G):
    """As above, for raster_blocks; Ks = K."""
    needs_card()
    rng = np.random.default_rng(4)
    mi, mv = raster_operands(rng, G, K, 6)
    si, sv = raster_operands(rng, G, K, 3)
    args = [t.cuda() for t in (mi, mv, si, sv)]
    if not with_shadow:
        args[2:] = [None, None]
    ref = img.raster_blocks_ref(*args, size=SIZE)
    counts = [4, 9, 14] + ([16, 18, 20] if with_shadow else [])
    before = img.raster_blocks.launches
    for _ in range(2):
        out = img.raster_blocks(*args, size=SIZE)
        torch.cuda.synchronize()
        assert torch.equal(out[:, counts], ref[:, counts])
        torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
    assert img.raster_blocks.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,size,Cp", [
    ("raster_blocks", 80, None),   # planes too large for two buffers
    ("raster_sums", 100, 4),       # one histogram buffer
    ("raster_sums", 61, 3),        # 183-float rows: plain stores, no bulk
    ("raster_sums", 60, 9),        # Cp > 8: one block per hand
    ("raster_sums2", 61, 3),       # two row sets, plain stores
    ("raster_sums2", 56, 9),       # two row sets, Cp > 8: one block per hand
])
def test_kernels_off_the_main_shapes_on_card(kernel, size, Cp):
    """The launch paths that size 60 with Cp <= 8 does not take, against
    the plain versions, twice."""
    needs_card()
    rng = np.random.default_rng(size)
    if kernel == "raster_blocks":
        mi, mv = raster_operands(rng, 133, 2048, 6, size)
        si, sv = raster_operands(rng, 133, 2048, 3, size)
        args = [t.cuda() for t in (mi, mv, si, sv)]
        fn, ref = img.raster_blocks, img.raster_blocks_ref(*args, size=size)
        counts = lambda t: t[:, [4, 9, 14, 16, 18, 20]]
        call = lambda: fn(*args, size=size)
    else:
        ra, rb, cols, aug = (t.cuda() for t in sums_operands(rng, 133, 2048,
                                                             Cp, size))
        rows = (ra,) if kernel == "raster_sums" else (ra, rb)
        fn = getattr(img, kernel)
        ref = getattr(img, kernel + "_ref")(*rows, cols, aug, size)
        counts = lambda t: t[..., -1]
        call = lambda: fn(*rows, cols, aug, size)
    before = fn.launches
    for _ in range(2):
        out = call()
        torch.cuda.synchronize()
        assert torch.equal(counts(out), counts(ref))
        torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
    assert fn.launches == before + 2


@pytest.mark.cuda
def test_raster_kernel_at_the_staged_chunk_on_card():
    """raster_blocks at the staged route's largest chunk, 4096 hands with
    2048 points and 2048 shadow points each (1.4 GB of output planes)
    against its plain version."""
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    G, K = 4096, 2048

    def operands(nval):
        cells = torch.randint(0, SIZE, (G, 4, K), generator=gen,
                              device="cuda", dtype=torch.int32)
        inside = torch.rand((G, 1, K), generator=gen, device="cuda") < 0.6
        idx = torch.where(inside, cells, SIZE).to(torch.int32).contiguous()
        vals = torch.rand((G, nval, K), generator=gen, device="cuda") * inside
        return idx, vals.to(torch.bfloat16).contiguous()
    args = [*operands(6), *operands(3)]
    ref = img.raster_blocks_ref(*args, size=SIZE)
    before = img.raster_blocks.launches
    out = img.raster_blocks(*args, size=SIZE)
    torch.cuda.synchronize()
    counts = [4, 9, 14, 16, 18, 20]
    assert torch.equal(out[:, counts], ref[:, counts])
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
    assert img.raster_blocks.launches == before + 1
