"""The port's kernel wrappers, without JAX: argument checks and the CPU
dispatch here, and each CUDA kernel against its plain version on the card
(marked ``cuda``; skips without a card). The hand search's premise, that
its plain version ignores everything but the members of each row and
their order, holds here on the CPU. On a machine with a card:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.net import lenet
from gpd_tpu_torch.ops import _build
from gpd_tpu_torch.ops import candidates as cand
from gpd_tpu_torch.ops import images as img
from gpd_tpu_torch.ops.frames import estimate_frames
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
    before = _build.LAUNCHES["raster_blocks"]
    out = img.raster_blocks(mi, mv, size=SIZE)
    assert torch.equal(out, img.raster_blocks_ref(mi, mv, size=SIZE))
    assert _build.LAUNCHES["raster_blocks"] == before     # no kernel on the CPU
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
    before = _build.LAUNCHES[fn.__name__]
    out = call()
    assert torch.equal(out, ref(*rows, cols, aug, SIZE))
    assert out.shape == ((3, 2, SIZE, SIZE, 4) if two else (3, SIZE, SIZE, 4))
    assert _build.LAUNCHES[fn.__name__] == before                    # no kernel on the CPU
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
    assert _build.LAUNCHES[fn.__name__] == before


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
    before = _build.LAUNCHES[fn.__name__]
    for _ in range(2):
        out = fn(*rows, cols, aug, SIZE)
        torch.cuda.synchronize()
        assert torch.equal(out[..., -1], expect[..., -1])
        torch.testing.assert_close(out, expect, atol=1e-3, rtol=1e-5)
    assert _build.LAUNCHES[fn.__name__] == before + 2


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
    before = _build.LAUNCHES["raster_blocks"]
    for _ in range(2):
        out = img.raster_blocks(*args, size=SIZE)
        torch.cuda.synchronize()
        assert torch.equal(out[:, counts], ref[:, counts])
        torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
    assert _build.LAUNCHES["raster_blocks"] == before + 2


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
    before = _build.LAUNCHES[fn.__name__]
    for _ in range(2):
        out = call()
        torch.cuda.synchronize()
        assert torch.equal(counts(out), counts(ref))
        torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
    assert _build.LAUNCHES[fn.__name__] == before + 2


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
    before = _build.LAUNCHES["raster_blocks"]
    out = img.raster_blocks(*args, size=SIZE)
    torch.cuda.synchronize()
    counts = [4, 9, 14, 16, 18, 20]
    assert torch.equal(out[:, counts], ref[:, counts])
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-5)
    assert _build.LAUNCHES["raster_blocks"] == before + 1


# The images kernel (raster_images: raster_blocks' sums finished into
# uint8 channels in the kernel) against _raster_finish(raster_blocks_ref).

def images_ref(args, size=SIZE):
    """The plain route's images of raster operands (None for no shadows):
    (G, C, size, size) uint8."""
    return img._raster_finish(img.raster_blocks_ref(*args, size=size), size,
                              12 if args[2] is None else 15)


@pytest.mark.parametrize("with_shadow", [True, False])
def test_images_wrapper_checks_and_cpu_dispatch(with_shadow):
    """On the CPU raster_images is the plain route bit for bit (15
    channels with shadow operands, 12 without), launches nothing, and
    refuses operands raster_blocks refuses."""
    rng = np.random.default_rng(6)
    mi, mv = raster_operands(rng, 3, 128, 6)
    si, sv = raster_operands(rng, 3, 96, 3)
    args = (mi, mv, si, sv) if with_shadow else (mi, mv, None, None)
    C = 15 if with_shadow else 12
    before = _build.LAUNCHES["raster_images"]
    out = img.raster_images(*args, size=SIZE)
    assert out.shape == (3, C, SIZE, SIZE) and out.dtype == torch.uint8
    assert torch.equal(out, images_ref(args))
    assert out.any()
    assert _build.LAUNCHES["raster_images"] == before     # no kernel on the CPU
    with pytest.raises(ValueError):
        img.raster_images(mi, mv.float(), *args[2:], size=SIZE)
    with pytest.raises(ValueError):
        img.raster_images(mi, mv, si, None, size=SIZE)
    with pytest.raises(ValueError):
        img.raster_images(*args, size=200)
    assert _build.LAUNCHES["raster_images"] == before


def image_hands(channels, G=5, K=64, seed=9):
    """make_images' arguments for G hands around the origin with K points
    each (and K shadow points at 15 channels), about half of them inside
    the image volume."""
    rng = np.random.default_rng(seed)
    geo = ImageGeometry(num_channels=channels)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    pts = rng.uniform(-0.06, 0.06, (G, K, 3))
    nrm = rng.normal(size=(G, K, 3))
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                  for _ in range(G)])
    hands = (T(pts), T(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)),
             torch.ones((G, K), dtype=torch.bool), T(R),
             T(rng.uniform(-0.01, 0.01, (G, 3))), T(np.full(G, -0.03)),
             T(np.zeros(G)), torch.ones(G, dtype=torch.bool), geo)
    shadow = {}
    if channels == 15:
        shadow = dict(shadow_pts=T(rng.uniform(-0.06, 0.06, (G, K, 3))),
                      shadow_valid=torch.ones((G, K), dtype=torch.bool))
    return hands, shadow


@pytest.mark.parametrize("channels", [15, 12])
def test_make_images_cpu_route_finishes_on_the_host(channels, monkeypatch):
    """On the CPU make_images still sums with raster_blocks_ref and
    finishes with _raster_finish, once per call, and launches nothing."""
    calls = []
    finish = img._raster_finish

    def counted(*args):
        calls.append(args[1:])
        return finish(*args)
    monkeypatch.setattr(img, "_raster_finish", counted)
    hands, shadow = image_hands(channels)
    before = _build.LAUNCHES["raster_images"]
    out = img.make_images(*hands, **shadow)
    assert calls == [(SIZE, channels)]
    assert out.shape == (5, SIZE, SIZE, channels) and out.any()
    assert _build.LAUNCHES["raster_images"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [15, 12])
def test_make_images_card_route_never_finishes_on_the_host(channels,
                                                           monkeypatch):
    """On the card make_images launches the images kernel once and runs no
    op of _raster_finish; its images are the CPU route's within one
    level."""
    needs_card()
    hands, shadow = image_hands(channels, G=64, K=512)
    ref = img.make_images(*hands, **shadow)

    def refuse(*args):
        raise AssertionError("the card route called _raster_finish")
    monkeypatch.setattr(img, "_raster_finish", refuse)
    moved = [h.cuda() if isinstance(h, torch.Tensor) else h for h in hands]
    before = _build.LAUNCHES["raster_images"]
    out = img.make_images(*moved, **{k: v.cuda() for k, v in shadow.items()})
    torch.cuda.synchronize()
    assert _build.LAUNCHES["raster_images"] == before + 1
    assert out.shape == ref.shape and out.dtype == torch.uint8
    assert int((out.cpu().int() - ref.int()).abs().max()) <= 1


def hold_images(args, size=SIZE, ref=None, exact=False, label=""):
    """raster_images on the card against the plain route's images (``ref``,
    else images_ref on the CPU), twice: every pixel within one level, and
    with ``exact`` (value sums exact in any order) equal bit for bit; one
    launch a call. Prints the share of unequal pixels."""
    if ref is None:
        ref = images_ref([None if a is None else a.cpu() for a in args],
                         size).cuda()
    before = _build.LAUNCHES["raster_images"]
    for _ in range(2):
        out = img.raster_images(*args, size=size)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == torch.uint8
        gap = (out.int() - ref.int()).abs()
        print(f"raster_images {label} G={args[0].shape[0]} C={ref.shape[1]}: "
              f"unequal pixels {float((gap > 0).float().mean()):.3e}, "
              f"max gap {int(gap.max())}")
        assert int(gap.max()) <= 1
        if exact:
            assert torch.equal(out, ref)
    assert _build.LAUNCHES["raster_images"] == before + 2


def exact_values(vals):
    """Values on a grid of 1/16 in [0, 1): every partial sum of up to 2^14
    of them is exact in f32, so the sums do not depend on the atomics'
    order."""
    return (torch.floor(vals.float() * 16) / 16).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("G,K", [(512, 2048), (133, 2047), (1, 200),
                                 (256, 3072)])
@pytest.mark.parametrize("with_shadow", [True, False])
def test_images_kernel_matches_plain_route_on_card(with_shadow, K, G):
    """The main path's chunk (512 hands, 2048 points and shadow points),
    ragged hand counts and K not a multiple of 4: within one level on
    random values, equal on values whose sums are exact."""
    needs_card()
    rng = np.random.default_rng(G + K)
    mi, mv = raster_operands(rng, G, K, 6)
    si, sv = raster_operands(rng, G, K, 3)
    if not with_shadow:
        si = sv = None
    args = [None if t is None else t.cuda() for t in (mi, mv, si, sv)]
    hold_images(args, label="random")
    args[1] = exact_values(args[1])
    if with_shadow:
        args[3] = exact_values(args[3])
    hold_images(args, exact=True, label="exact sums")


@pytest.mark.cuda
@pytest.mark.parametrize("with_shadow", [True, False])
def test_images_kernel_edge_hands_on_card(with_shadow):
    """Hand 0 has no point inside (every channel 0: its ranges are 0);
    hand 1 no shadow point inside (mx = 0); hand 2 one point of value 0.5
    in every cell of every projection (each dilated plane constant: range
    0, all 0); hand 3 random. Values exact, so equal bit for bit."""
    needs_card()
    K = SIZE * SIZE
    rng = np.random.default_rng(12)
    mi, mv = raster_operands(rng, 4, K, 6)
    si, sv = raster_operands(rng, 4, K, 3)
    cells = torch.arange(K, dtype=torch.int32)
    full = torch.stack([cells // SIZE, cells // SIZE, cells % SIZE,
                        cells % SIZE])
    for idx, vals in ((mi, mv), (si, sv)):
        idx[0] = SIZE
        vals[0] = 0
        idx[2] = full
        vals[2] = 0.5
    si[1] = SIZE
    sv[1] = 0
    args = [mi, mv, si, sv] if with_shadow else [mi, mv, None, None]
    args = [None if t is None else t.cuda() for t in args]
    args[1] = exact_values(args[1])
    if with_shadow:
        args[3] = exact_values(args[3])
    hold_images(args, exact=True, label="edge hands")
    out = img.raster_images(*args, size=SIZE)
    assert not out[0].any() and not out[2].any() and out[3].any()
    if with_shadow:
        assert not out[1, 4::5].any() and out[1, 0].any()


@pytest.mark.cuda
def test_images_kernel_at_the_staged_chunk_on_card():
    """raster_images at the staged route's largest chunk, 4096 hands with
    2048 points and 2048 shadow points each, against the plain route run
    on the card."""
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    G, K = 4096, 2048

    def operands(nval):
        cells = torch.randint(0, SIZE, (G, 4, K), generator=gen,
                              device="cuda", dtype=torch.int32)
        inside = torch.rand((G, 1, K), generator=gen, device="cuda") < 0.6
        idx = torch.where(inside, cells, SIZE).to(torch.int32).contiguous()
        vals = torch.rand((G, nval, K), generator=gen, device="cuda") * inside
        return idx, vals.to(torch.bfloat16).contiguous()
    args = [*operands(6), *operands(3)]
    hold_images(args, ref=images_ref(args), label="staged chunk")


@pytest.mark.cuda
def test_program_b_keeps_the_kernel_images_on_card(monkeypatch):
    """score_candidates at 15 channels with images kept in ``images_out``
    (data generation's B): each live chunk's kept images are the images
    kernel's output for that chunk, which is within one level of the
    plain route on the same operands, and its scores are LeNet's on the
    kept images; the chunks past the live ones stay zero."""
    needs_card()
    det = tdet.GraspDetector(DetectorConfig(num_samples=200), device="cuda")
    rng = np.random.default_rng(8)
    pts, nrm = syn.make_scene(rng, n_objects=2)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm,
                                       syn.view_cameras(rng, 2))
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    cfg = det.effective_config(cloud)
    gen = torch.Generator(device="cuda").manual_seed(0)
    spos, smask = det.sample_cloud(cloud, gen)
    grasps = tdet.candidates_stage(cloud, spos, smask, cfg)
    calls, kernel = [], img.raster_images

    def recording(*args, **kw):
        out = kernel(*args, **kw)
        calls.append(([a.cpu() if isinstance(a, torch.Tensor) else None
                       for a in args[:4]], out.clone()))
        return out
    monkeypatch.setattr(img, "raster_images", recording)
    cap = det.image_cap(spos.shape[0])
    n_chunks = -(-grasps.capacity // cap)
    kept = torch.full((n_chunks * cap, SIZE, SIZE, 15), 7, dtype=torch.uint8,
                      device="cuda")
    scored, images = tdet.score_candidates(
        cloud, grasps, spos, smask, det.net, gen, cfg, cap,
        scores_only=False, images_out=kept)
    torch.cuda.synchronize()
    n_valid = int(scored.valid.sum())
    assert images is kept and n_valid > 0
    assert len(calls) == -(-n_valid // cap)
    for i, (args, out) in enumerate(calls):
        chunk = slice(i * cap, (i + 1) * cap)
        assert torch.equal(kept[chunk], out.permute(0, 2, 3, 1))
        ref = images_ref(args).cuda()
        gap = (out.int() - ref.int()).abs()
        print(f"program B chunk {i}: unequal pixels "
              f"{float((gap > 0).float().mean()):.3e}")
        assert int(gap.max()) <= 1
        valid = scored.valid[chunk]
        torch.testing.assert_close(
            scored.score[chunk][valid],
            lenet.score(det.net, kept[chunk])[valid])
    assert not kept[len(calls) * cap:].any()


# The hand search (csrc/hand_search.cu against _eval_orientations).

SEARCH_OUTPUTS = ("R", "pos", "top", "bottom", "center", "width", "mid",
                  "valid", "full", "half")


def cylinder_cloud(num_samples=48, seed=21):
    """Two capped 30 mm cylinders 0.4 m apart seen by two cameras,
    preprocessed on the CPU, with samples drawn from them: narrow enough
    to grasp and dense enough that the search finds full antipodal hands;
    a sample's radius holds one cylinder, about half the cloud. Returns
    (cloud, cfg, sample_pos, mask)."""
    rng = np.random.default_rng(seed)
    pts, nrm = syn.sample_cylinder(rng, 0.03, 0.1, 6000)
    pts = np.concatenate([pts, pts + np.float32([0.4, 0.0, 0.0])])
    nrm = np.concatenate([nrm, nrm])
    cams = np.array([[0.5, 0.1, 0.2], [-0.3, 0.45, 0.1]], np.float32)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, cams)
    det = tdet.GraspDetector(DetectorConfig(num_samples=num_samples),
                             device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    cfg = det.effective_config(cloud)
    spos, smask = tdet.sample_points(cloud, torch.Generator().manual_seed(0),
                                     cfg)
    return cloud, cfg, spos, smask


def search_inputs(cloud, cfg, spos, smask, k=None):
    """(points, normals, sample_pos, frames, rfix, member, idx, params) of
    the hand search at the samples: identity rows when ``k`` is None, else
    the capped route's nearest-k rows."""
    frames, fvalid = estimate_frames(spos, smask, cloud.points, cloud.mask,
                                     cloud.normals,
                                     radius=cfg.nn_radius_frames)
    member, idx = cand._search_neighbors(
        spos, fvalid, cloud.points, cloud.mask, cfg.hand_search_radius,
        cloud.capacity if k is None else k)
    rfix = torch.from_numpy(cand.rotation_grid(cfg.angles, cfg.hand_axes)
                            ).to(spos.device)
    return (cloud.points, cloud.normals, spos, frames, rfix, member, idx,
            cand.SearchParams.from_config(cfg))


@pytest.mark.parametrize("route", ["identity", "capped"])
@pytest.mark.parametrize("how", ["dropped", "permuted"])
def test_plain_search_ignores_non_members_and_order(how, route):
    """The kernel's premise on the plain version: _eval_orientations gives
    bit-identical outputs when each row keeps only its in-radius members
    (the rest moved far away and masked), and when those are permuted."""
    cloud, cfg, spos, smask = cylinder_cloud()
    points, normals, spos, frames, rfix, member, idx, params = search_inputs(
        cloud, cfg, spos, smask, None if route == "identity" else 2048)
    if idx is None:
        idx = torch.arange(points.shape[0]).expand(member.shape)
    ref = cand._eval_orientations(points[idx] - spos[:, None],
                                  normals[idx], member, frames, rfix, params)
    assert ref["full"].any() and ref["valid"].any()
    S = spos.shape[0]
    width = int(member.sum(1).max())
    order = torch.argsort(~member, dim=1, stable=True)[:, :width]
    if how == "permuted":
        gen = torch.Generator().manual_seed(1)
        order = torch.stack([row[torch.randperm(width, generator=gen)]
                             for row in order])
    keep = torch.gather(member, 1, order)
    sub = torch.gather(idx, 1, order)
    rel = torch.where(keep[..., None], points[sub] - spos[:, None],
                      torch.tensor(1e3))
    nrm = torch.where(keep[..., None], normals[sub], torch.tensor(0.0))
    out = cand._eval_orientations(rel, nrm, keep, frames, rfix, params)
    assert width < member.shape[1] and S == 48
    for k in SEARCH_OUTPUTS:
        assert torch.equal(out[k], ref[k]), k


def test_hand_search_wrapper_checks_and_cpu_dispatch():
    """On the CPU the wrapper is the plain version, with each sample's
    member count, and launches nothing; it refuses operands the kernel does
    not take."""
    cloud, cfg, spos, smask = cylinder_cloud(num_samples=16)
    args = list(search_inputs(cloud, cfg, spos, smask))
    points, normals, spos, frames, rfix, member, idx, params = args
    before = _build.LAUNCHES["hand_search"]
    out, members = cand.hand_search(*args)
    ref = cand._eval_orientations(points[None] - spos[:, None],
                                  normals[None].expand(16, -1, 3), member,
                                  frames, rfix, params)
    for k in SEARCH_OUTPUTS:
        assert torch.equal(out[k], ref[k]), k
    assert members.dtype == torch.int32
    assert torch.equal(members, member.sum(1).int())
    capped = list(search_inputs(cloud, cfg, spos, smask, k=256))
    out_c, members_c = cand.hand_search(*capped)
    assert torch.equal(members_c, capped[5].sum(1).int())
    assert _build.LAUNCHES["hand_search"] == before     # no kernel on the CPU

    def call(i, value):
        a = list(args)
        a[i] = value
        cand.hand_search(*a)
    bad = [(0, points.double()),                   # dtype
           (3, frames[:, :2]),                     # shape
           (5, member[:, :-1]),                    # identity rows cover N
           (5, member.int()),
           (5, member[:-1]),
           (6, torch.zeros(member.shape, dtype=torch.int32)),
           (6, torch.zeros((16, 4), dtype=torch.int64)),
           (2, spos.t().contiguous().t()),         # contiguity
           (4, rfix.to("meta"))]                   # one device
    for i, value in bad:
        with pytest.raises(ValueError):
            call(i, value)
    with pytest.raises(ValueError):                # 2P slabs past 64
        call(7, dataclasses.replace(params, num_placements=33))
    assert _build.LAUNCHES["hand_search"] == before


def benchmark_cloud(kind):
    """The first cloud of the benchmark's table (15-channel) or PCD
    (3-channel) traffic, preprocessed on the card as its cell does, and
    that cell's DetectorConfig."""
    from h100_bench.entries.serve import program_config
    from h100_bench.inputs import generate
    cell, name = {"table": ("table_stream", "gpd15"),
                  "pcd": ("pcd_stream", "gpd3")}[kind]
    root = os.path.join(os.path.dirname(__file__), os.pardir, "h100_bench")
    with open(os.path.join(root, "traffic", cell + ".json")) as f:
        mix = json.load(f)
    with open(os.path.join(root, "configs", name + ".json")) as f:
        spec = json.load(f)
    mix["scene_seeds"] = mix["scene_seeds"][:1]
    det = tdet.GraspDetector(program_config(spec["detector"],
                                            spec["weights"]), device="cuda")
    if kind == "table":
        (it,) = generate.table_scenes(mix)
        cloud = det.preprocess_cloud(it["points"],
                                     view_points=it["view_points"],
                                     cam_source=it["cam_source"])
    else:
        (pts,) = generate.single_camera_scenes(mix)
        cam = np.asarray(det.cfg.camera_position, np.float32).reshape(1, 3)
        cloud = det.preprocess_cloud(pts, view_points=cam, capacity="serve")
    return cloud, det.effective_config(cloud)


def hold_search(out, members, ref, member, label):
    """The kernel's outputs against the plain version's: member counts
    exactly; each flag and ``mid`` equal on at least 99.9% of slots; the
    values within 1e-5 where ``valid`` agrees (R everywhere). Prints the
    mismatch counts."""
    torch.cuda.synchronize()
    assert torch.equal(members, member.sum(1).int())
    n = ref["valid"].numel()
    off = {k: int((out[k] != ref[k]).sum())
           for k in ("valid", "full", "half", "mid")}
    print(f"hand_search {label}: {n} slots, {int(ref['valid'].sum())} valid, "
          f"{int(ref['full'].sum())} full; mismatches {off}; members max "
          f"{int(members.max())}")
    for k, bad in off.items():
        assert bad <= n // 1000, (k, bad)
    agree = out["valid"] == ref["valid"]
    torch.testing.assert_close(out["R"], ref["R"], atol=1e-5, rtol=0)
    for k in ("top", "bottom", "center", "width", "pos"):
        torch.testing.assert_close(out[k][agree], ref[k][agree], atol=1e-5,
                                   rtol=0, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,K,axes,S", [
    ("table", None, (2,), 1000),     # identity rows, capacity 14336
    ("pcd", None, (2,), 1000),       # identity rows, capacity 8192
    ("table", 4096, (2,), 1000),     # the capped route's nearest 4096
    ("table", None, (0, 1, 2), 37),  # M = 24
    ("pcd", 4096, (0, 1, 2), 37),
])
def test_hand_search_matches_plain_version_on_card(kind, K, axes, S):
    """The kernel against _eval_orientations on the card, on the
    benchmark's own clouds and samples, twice (one launch each)."""
    needs_card()
    cloud, cfg = benchmark_cloud(kind)
    assert cloud.capacity == {"table": 14336, "pcd": 8192}[kind]
    cfg = dataclasses.replace(cfg, hand_axes=axes)
    gen = torch.Generator(device="cuda").manual_seed(3)
    spos, smask = tdet.sample_points(cloud, gen, cfg)
    args = search_inputs(cloud, cfg, spos[:S].contiguous(), smask[:S], K)
    points, normals, spos, frames, rfix, member, idx, params = args
    rows = (torch.arange(points.shape[0], device="cuda").expand(member.shape)
            if idx is None else idx)
    ref = cand._eval_orientations(points[rows] - spos[:, None],
                                  normals[rows], member, frames, rfix, params)
    before = _build.LAUNCHES["hand_search"]
    for _ in range(2):
        out, members = cand.hand_search(*args)
        hold_search(out, members, ref, member,
                    f"{kind} K={member.shape[1]} M={rfix.shape[0]} S={S}")
    assert _build.LAUNCHES["hand_search"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["identity", "capped"])
def test_hand_search_edge_cases_on_card(route):
    """A neighbourhood of 4x the shared-memory tile (swept in tiles), a
    sample with no member, one with an invalid frame; then every frame
    invalid. Against the plain version on the card."""
    needs_card()
    rng = np.random.default_rng(9)
    n = 4 * cand.HAND_TILE + 100
    pts, nrm = syn.sample_cylinder(rng, 0.015, 0.1, n)
    pts = np.concatenate([pts, [[5.0, 5.0, 5.0]]]).astype(np.float32)
    nrm = np.concatenate([nrm, [[0.0, 0.0, 1.0]]]).astype(np.float32)
    points = torch.from_numpy(pts).cuda()
    normals = torch.from_numpy(nrm).cuda()
    mask = torch.ones(len(pts), dtype=torch.bool, device="cuda")
    spos = points[[0, 1, 2, 3, n]].contiguous()
    spos[4] += 1.0                                   # no member
    cfg = DetectorConfig()
    frames, fvalid = estimate_frames(spos, torch.ones(5, dtype=torch.bool,
                                                      device="cuda"),
                                     points, mask, normals,
                                     radius=cfg.nn_radius_frames)
    fvalid[3] = False                                # an invalid frame
    rfix = torch.from_numpy(cand.rotation_grid(cfg.angles, (0, 1, 2))).cuda()
    params = cand.SearchParams.from_config(cfg)
    k = len(pts) if route == "identity" else len(pts) - 1
    for fv in (fvalid, torch.zeros_like(fvalid)):
        member, idx = cand._search_neighbors(spos, fv, points, mask,
                                             cfg.hand_search_radius, k)
        rows = (torch.arange(len(pts), device="cuda").expand(member.shape)
                if idx is None else idx)
        ref = cand._eval_orientations(points[rows] - spos[:, None],
                                      normals[rows], member, frames, rfix,
                                      params)
        out, members = cand.hand_search(points, normals, spos, frames, rfix,
                                        member, idx, params)
        hold_search(out, members, ref, member, f"edge cases, {route}")
        assert int(members.max()) <= (4 * cand.HAND_TILE + 100
                                      if fv.any() else 0)
        if fv.any():
            assert int(members[0]) > 3 * cand.HAND_TILE
            assert int(members[3]) == int(members[4]) == 0
        for key in SEARCH_OUTPUTS:
            if key != "R":
                assert torch.equal(out[key][:, 3:], ref[key][:, 3:]), key


# The radius moments (csrc/radius_moments.cu against radius_moments_ref).

def normal_feats(points, mask):
    """_normals_kernel's moments: the cloud centred on its centroid (masked
    points at 1e6) and its nine features."""
    w = mask.to(points.dtype)
    centroid = (points * w[:, None]).sum(0) / w.sum().clamp(min=1.0)
    p = torch.where(mask[:, None], points - centroid, 1.0e6)
    return p.contiguous(), outer_feats(p)


def outer_feats(v):
    """(N, 9): the six products of v's coordinates, then v (the features of
    both the normals and the frames)."""
    x, y, z = v.unbind(1)
    return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z, x, y, z],
                       dim=1).contiguous()


def test_moments_wrapper_checks_and_cpu_dispatch():
    """On the CPU the wrapper is radius_moments_ref bit for bit, float64
    too, and launches nothing; it refuses operands the kernel does not
    take."""
    from gpd_tpu_torch.ops import neighbors as nbr
    cloud, cfg, spos, smask = cylinder_cloud(num_samples=16)
    points, mask = cloud.points, cloud.mask
    feats = outer_feats(cloud.normals)
    args = (spos, smask, points, mask, feats, cfg.nn_radius_frames)
    before = _build.LAUNCHES["radius_moments"]
    for a in (args, tuple(t.double() if torch.is_floating_point(t) else t
                          for t in args[:5]) + args[5:]):
        got = nbr.radius_moments(*a)
        want = nbr.radius_moments_ref(*a)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert got[1].sum() > 0
    assert _build.LAUNCHES["radius_moments"] == before   # no kernel on the CPU

    def call(i, value):
        a = list(args)
        a[i] = value
        nbr.radius_moments(*a)
    bad = [(0, spos.double()),                      # dtypes differ
           (0, spos[:, :2].contiguous()),           # shape
           (1, smask.int()),                        # mask dtype
           (1, smask[:-1]),
           (3, mask[:-1]),
           (4, feats[:-1]),
           (4, feats[:, 0]),
           (2, points.t().contiguous().t()),        # contiguity
           (4, feats.t().contiguous().t()),
           (0, spos.to("meta"))]                    # one device
    for i, value in bad:
        with pytest.raises(ValueError):
            call(i, value)
    with pytest.raises(ValueError):
        nbr.radius_moments_probe(*args)            # the card's alone
    assert _build.LAUNCHES["radius_moments"] == before


def test_moment_splits_fill_the_card():
    """The kernel's point partitions at the main path's shapes on 132 SMs:
    query warps x partitions reach 32 warps an SM, at most 64 partitions
    and one a 32-point group."""
    from gpd_tpu_torch.ops.neighbors import moment_splits
    for (q, n), want in {(14336, 14336): 10, (10240, 10240): 14,
                         (8192, 8192): 17, (1000, 14336): 64,
                         (50, 14336): 64, (1, 300): 10, (133, 2047): 64,
                         (0, 0): 1}.items():
        assert moment_splits(q, n, 132) == want, (q, n)


def hold_moments(got, query, qmask, points, pmask, feats, radius, label):
    """The kernel's (sums, counts) against float64 on the card: counts
    equal except where a query has pairs within 1e-6 r^2 of the boundary
    (by at most that many), sums within rtol = atol = 1e-5 of the float64
    sums where the counts agree (the plain route's tolerance against brute
    force), 0 where the query is masked. Against radius_moments_ref on the
    card: the kernel's counts are off float64's on no more queries than
    the plain route's (whose q^2 + p^2 - 2 q.p rounds farther from the
    boundary). Prints both routes' counts and gaps."""
    from gpd_tpu_torch.ops.neighbors import radius_moments_ref
    torch.cuda.synchronize()
    sums, counts = got
    r2 = float(np.float32(radius) * np.float32(radius))
    q64, p64, f64 = query.double(), points.double(), feats.double()
    c64, s64, edge = [], [], []
    for i in range(0, query.shape[0], 1024):
        d2 = ((q64[i:i + 1024, None] - p64[None]) ** 2).sum(-1)
        live = pmask[None] & qmask[i:i + 1024, None]
        w = ((d2 <= r2) & live).double()
        c64.append(w.sum(1))
        s64.append(w @ f64)
        edge.append((((d2 - r2).abs() <= 1e-6 * r2) & live).sum(1))
    c64, s64, edge = torch.cat(c64), torch.cat(s64), torch.cat(edge)

    def gap_of(s, c):
        same = c.double() == c64
        gap = float((s[same].double() - s64[same]).abs().max()) \
            if same.any() else 0.0
        return same, gap
    off = (counts.double() - c64).abs()
    assert bool((off <= edge).all()), label
    same, gap = gap_of(sums, counts)
    torch.testing.assert_close(sums[same].double(), s64[same], rtol=1e-5,
                               atol=1e-5, msg=label)
    assert bool((sums[~qmask] == 0).all() and (counts[~qmask] == 0).all())
    ref_same, ref_gap = gap_of(*radius_moments_ref(query, qmask, points,
                                                   pmask, feats, radius))
    assert int((~same).sum()) <= int((~ref_same).sum()), label
    print(f"radius_moments {label}: Q={query.shape[0]} N={points.shape[0]} "
          f"members {int(c64.sum())}; pairs within 1e-6 r^2 of the boundary "
          f"{int(edge.sum())}; queries whose count is off float64's: kernel "
          f"{int((~same).sum())}, plain route {int((~ref_same).sum())}; "
          f"sums' gap to float64 {gap:.3e} (plain route {ref_gap:.3e})")


def moment_inputs(kind, Q, N, feats_of):
    """(query, qmask, points, pmask, feats, radius) on the card: the first N
    points of the benchmark's first ``kind`` cloud (lexicographic cell
    order, its padding masked), the normals' or the frames' features and
    radius, and as queries the points themselves (Q = N) or Q of them
    drawn at random, every seventh masked."""
    cloud, cfg = benchmark_cloud(kind)
    points = cloud.points[:N].contiguous()
    pmask = cloud.mask[:N].contiguous()
    if feats_of == "normals":
        points, feats = normal_feats(points, pmask)
        radius = cfg.normals_radius
    else:
        feats = outer_feats(cloud.normals[:N])
        radius = cfg.nn_radius_frames
    if Q == N:
        return points, pmask, points, pmask, feats, radius
    gen = torch.Generator(device="cuda").manual_seed(Q)
    pick = torch.randint(0, N, (Q,), generator=gen, device="cuda")
    qmask = pmask[pick] & (torch.arange(Q, device="cuda") % 7 != 6)
    return (points[pick].contiguous(), qmask.contiguous(), points, pmask,
            feats, radius)


@pytest.mark.cuda
@pytest.mark.parametrize("feats_of", ["normals", "frames"])
@pytest.mark.parametrize("kind,Q,N", [
    ("table", 50, 14336), ("table", 1000, 14336), ("pcd", 8192, 8192),
    ("table", 14336, 14336), ("table", 133, 2047), ("table", 1, 300)])
def test_moments_kernel_matches_float64_on_card(kind, Q, N, feats_of):
    """The kernel against float64 and radius_moments_ref on the benchmark's
    clouds at the main path's shapes and off the tile sizes, twice (bit
    for bit); one launch a call. Its probe, with and without culling,
    gives the same sums bit for bit and counts every (query warp, point
    group) pair of the live query warps as judged; without culling every
    one is swept, and at Q = N culling skips at least half of them."""
    from gpd_tpu_torch.ops import neighbors as nbr
    needs_card()
    args = moment_inputs(kind, Q, N, feats_of)
    before = _build.LAUNCHES["radius_moments"]
    got = nbr.radius_moments(*args)
    again = nbr.radius_moments(*args)
    assert _build.LAUNCHES["radius_moments"] == before + 2
    hold_moments(got, *args, f"{kind} {feats_of}")
    qmask = args[1]
    pad = -Q % 32
    warps = int(torch.nn.functional.pad(qmask, (0, pad)).view(-1, 32)
                .any(1).sum())
    pairs = warps * -(-N // 32)
    *culled, judged, swept = nbr.radius_moments_probe(*args)
    *full, judged_full, swept_full = nbr.radius_moments_probe(*args,
                                                              cull=False)
    assert judged == judged_full == swept_full == pairs
    assert swept <= judged
    if Q == N:
        assert 2 * swept < judged, (swept, judged)
    print(f"radius_moments {kind} {feats_of}: groups swept {swept} of "
          f"{judged} ({1 - swept / max(1, judged):.1%} culled)")
    for a, b, c, d in zip(got, again, culled, full):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)


@pytest.mark.cuda
def test_moments_kernel_edge_cases_on_card():
    """A query with no neighbour, masked queries, an all-masked cloud, no
    query, and N below one group: against float64 and the plain route."""
    from gpd_tpu_torch.ops import neighbors as nbr
    needs_card()
    rng = np.random.default_rng(4)
    pts = torch.from_numpy((rng.random((700, 3)) * 0.1).astype(np.float32))
    pts = pts.cuda()
    feats = outer_feats(pts)
    pmask = torch.from_numpy(rng.random(700) < 0.9).cuda()
    query = pts[:37].clone()
    query[5] += 10.0                                 # no neighbour
    qmask = torch.ones(37, dtype=torch.bool, device="cuda")
    qmask[[0, 9, 36]] = False
    sums, counts = nbr.radius_moments(query, qmask, pts, pmask, feats, 0.02)
    hold_moments((sums, counts), query, qmask, pts, pmask, feats, 0.02,
                 "edge cases")
    assert counts[5] == 0 and bool((sums[5] == 0).all())
    assert bool((counts[qmask & (torch.arange(37, device="cuda") != 5)]
                 > 0).all())
    none = torch.zeros_like(pmask)
    s0, c0 = nbr.radius_moments(query, qmask, pts, none, feats, 0.02)
    assert not s0.any() and not c0.any()
    s1, c1 = nbr.radius_moments(query, torch.zeros_like(qmask), pts, pmask,
                                feats, 0.02)
    assert not s1.any() and not c1.any()
    s2, c2 = nbr.radius_moments(query[:0], qmask[:0], pts, pmask, feats,
                                0.02)
    assert s2.shape == (0, 9) and c2.shape == (0,)
    few = (query, qmask, pts[:5].contiguous(), pmask[:5].contiguous(),
           feats[:5].contiguous(), 0.5)
    hold_moments(nbr.radius_moments(*few), *few, "N = 5")


@pytest.mark.cuda
def test_moments_kernel_replays_as_called_on_card():
    """A CUDA graph of the wrapper records one launch and replays the
    eager call's sums and counts bit for bit; the replay calls no
    wrapper."""
    from gpd_tpu_torch.ops import neighbors as nbr
    needs_card()
    args = moment_inputs("table", 14336, 14336, "normals")
    eager = nbr.radius_moments(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nbr.radius_moments(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.LAUNCHES["radius_moments"]
    with torch.cuda.graph(graph):
        out = nbr.radius_moments(*args)
    assert _build.LAUNCHES["radius_moments"] == before + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)
    assert _build.LAUNCHES["radius_moments"] == before + 1


# The outlier filter's nearest distances (csrc/outlier_knn.cu against
# outlier_knn_ref, the float64 reference and a plain emulation).

def stray_cloud(rng, n=400, strays=20):
    """A jittered 3 mm grid patch of ``n - strays`` points, bent into a
    ridge, and ``strays`` points scattered 2-5 cm above it: the filter's
    work on a small scale. float32 (n, 3), in lexicographic order."""
    side = int(np.ceil(np.sqrt(n - strays)))
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                             indexing="ij"), -1).reshape(-1, 2)[:n - strays]
    xy = g * 0.003 + rng.normal(0, 3e-4, (len(g), 2))
    z = 0.2 * np.abs(xy[:, 0] - xy[:, 0].mean())
    surface = np.column_stack([xy, z])
    lo, hi = surface.min(0), surface.max(0)
    stray = lo + rng.random((strays, 3)) * (hi - lo)
    stray[:, 2] += rng.uniform(0.02, 0.05, strays)
    pts = np.concatenate([surface, stray]).astype(np.float32)
    return pts[np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))]


def outlier_case(case, seed=0):
    """(points, mask, mean_k) on the CPU for the filter's edge cases:
    ``duplicates`` (every fifth point twice, so equal distances straddle
    the list's edge), ``few_live`` (30 live points at capacity 64, fewer
    than mean_k + 1), ``masked_rows`` (400 live points among 512 rows, the
    masked ones at coordinates inside the cloud)."""
    rng = np.random.default_rng(seed)
    pts = stray_cloud(rng)
    if case == "duplicates":
        pts = np.concatenate([pts, pts[::5]])
        pts = pts[np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))]
        mask = np.ones(len(pts), bool)
    elif case == "few_live":
        live = pts[rng.choice(len(pts), 30, replace=False)]
        pts = np.full((64, 3), 1.0e6, np.float32)
        pts[:30] = live
        mask = np.arange(64) < 30
    else:
        rows = np.sort(rng.choice(512, len(pts), replace=False))
        full = pts[rng.integers(0, len(pts), 512)].copy()
        full[rows] = pts
        pts, mask = full, np.zeros(512, bool)
        mask[rows] = True
    return torch.from_numpy(pts), torch.from_numpy(mask), 50


def reference_keep(points, mask, mean_k):
    """h100_bench's float64 StatisticalOutlierRemoval over the live points,
    with mean_k cut to the others there are (every live point then
    averages over all of them, as the port does)."""
    from h100_bench.reference.gpd import outlier_mask
    live = points[mask].double()
    return outlier_mask(live, min(mean_k, len(live) - 1))


def test_outlier_knn_wrapper_checks_and_cpu_dispatch():
    """On the CPU the wrapper is outlier_knn_ref bit for bit, float64 too,
    and launches nothing; it refuses operands the kernel does not take,
    and the kernel's own checks refuse float64, strided operands and
    mean_k + 1 above KNN_MAX_KEPT."""
    from gpd_tpu_torch.ops import neighbors as nbr
    points, mask, mean_k = outlier_case("masked_rows")
    before = (_build.LAUNCHES["outlier_knn"],
              _build.LAUNCHES["outlier_knn_probe"])
    for p in (points, points.double()):
        got = nbr.outlier_knn(p, mask, mean_k)
        assert torch.equal(got, nbr.outlier_knn_ref(p, mask, mean_k))
        assert got.dtype == p.dtype and got.shape == mask.shape
        assert bool((got[~mask] == 0).all() and (got[mask] > 0).all())
    assert (_build.LAUNCHES["outlier_knn"],
            _build.LAUNCHES["outlier_knn_probe"]) == before
    bad = [(points[:, :2].contiguous(), mask, mean_k),   # shape
           (points.int(), mask, mean_k),                  # dtype
           (points, mask.int(), mean_k),                  # mask dtype
           (points, mask[:-1], mean_k),                   # mask length
           (points, mask.to("meta"), mean_k),             # one device
           (points.to("meta"), mask.to("meta"), mean_k),  # cuda or cpu
           (points, mask, -1),
           (points, mask, 2.0),
           (points, mask, True)]
    for args in bad:
        with pytest.raises(ValueError):
            nbr.outlier_knn(*args)
    with pytest.raises(ValueError):
        nbr.outlier_knn_probe(points, mask, mean_k)     # the card's alone
    nbr._check_knn_cuda(points, mask, nbr.KNN_MAX_KEPT - 1)
    for args in [(points, mask, nbr.KNN_MAX_KEPT),     # list too long
                 (points.double(), mask, mean_k),
                 (points.t().contiguous().t(), mask, mean_k)]:
        with pytest.raises(ValueError):
            nbr._check_knn_cuda(*args)
    assert (_build.LAUNCHES["outlier_knn"],
            _build.LAUNCHES["outlier_knn_probe"]) == before


@pytest.mark.parametrize("case", ["duplicates", "few_live", "masked_rows"])
def test_outlier_plain_route_edge_cases_match_float64(case):
    """The CPU route of the outlier filter (remove_statistical_outliers'
    mask) keeps the float64 reference's points on duplicates, on fewer
    than mean_k + 1 live points and among masked rows; masked rows are
    never kept."""
    from gpd_tpu_torch.ops import preprocess as pp
    points, mask, mean_k = outlier_case(case)
    keep = pp._outlier_mask(points, mask, mean_k, 1.0)
    want = reference_keep(points, mask, mean_k)
    assert not bool(keep[~mask].any())
    assert torch.equal(keep[mask], want), int((keep[mask] != want).sum())
    assert 0 < int(want.sum()) < len(want)


def fma32(a, b, c):
    """fl32(a * b + c) for float32 a, b, c, rounded once as a fused
    multiply-add: the float64 product is exact, the sum's error comes from
    TwoSum, and rounding to odd in float64 (53 bits >= 24 + 2) then to
    nearest in float32 rounds the exact value once."""
    import math
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)          # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def knn_emulation(points, mask, mean_k, rows=None, block=256):
    """The kernel's mean distances in plain PyTorch, in its arithmetic, at
    the query rows ``rows`` (all by default): d2 = fma(dz, dz, fma(dy, dy,
    dx * dx)) in float32, the mean_k + 1 smallest over live points, the
    smallest dropped, the rest square-rooted (correctly rounded, through
    float64), added in ascending order in float32 and divided by their
    count (through float64); 0 for a masked row."""
    rows = torch.arange(points.shape[0], device=points.device) \
        if rows is None else rows
    k1 = mean_k + 1
    out = []
    for i in range(0, len(rows), block):
        r = rows[i:i + block]
        d = [points[r, a, None] - points[None, :, a] for a in range(3)]
        d2 = fma32(d[2], d[2], fma32(d[1], d[1], d[0] * d[0]))
        d2 = torch.where(mask[None, :], d2, torch.inf)
        kept = torch.sort(d2, dim=1).values[:, 1:k1]
        valid = kept < torch.inf
        root = torch.sqrt(kept.double()).float()
        s = torch.zeros(len(r), dtype=torch.float32, device=points.device)
        for j in range(kept.shape[1]):
            s = torch.where(valid[:, j], s + root[:, j], s)
        c = valid.sum(1).clamp(min=1)
        mean = (s.double() / c.double()).float()
        out.append(torch.where(mask[r], mean, 0.0))
    return torch.cat(out)


def test_knn_emulation_rounds_fused_multiply_adds_once():
    """fma32 against exact rational arithmetic on float32 operands whose
    products and sums need more than float64's 53 bits, and the
    emulation's means against a direct sort of the distances."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a, b = (rng.random(200) * 2 - 1).astype(np.float32), \
        (rng.random(200) * 2 - 1).astype(np.float32)
    c = ((rng.random(200) * 2 - 1) * 10.0 ** rng.integers(-12, 3, 200)
         ).astype(np.float32)
    got = fma32(*map(torch.from_numpy, (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert g == best, (x, y, z, g, best)
    points, mask, mean_k = outlier_case("masked_rows")
    emu = knn_emulation(points, mask, mean_k)
    ref = torch.zeros_like(emu)
    live = points[mask].double()
    d = torch.cdist(live, live).sort(1).values[:, 1:mean_k + 1]
    ref[mask] = d.mean(1).float()
    torch.testing.assert_close(emu, ref, rtol=1e-5, atol=1e-7)


def pcd_filter_inputs(seeds):
    """The benchmark's pcd scenes at the scene seeds ``seeds``, through the
    detector's first preprocess program on the card (the workspace filter,
    the voxels) and compacted to the serve bucket: what the outlier
    filter takes in the pcd cell."""
    from gpd_tpu_torch.core.types import CloudArrays
    from h100_bench.inputs import generate
    root = os.path.join(os.path.dirname(__file__), os.pardir, "h100_bench")
    with open(os.path.join(root, "traffic", "pcd_stream.json")) as f:
        mix = dict(json.load(f), scene_seeds=list(seeds))
    with open(os.path.join(root, "configs", "gpd3.json")) as f:
        spec = json.load(f)["detector"]
    cam = np.asarray(spec["camera_position"], np.float32).reshape(1, 3)
    for pts in generate.single_camera_scenes(mix):
        cloud = CloudArrays.from_numpy(
            pts, view_points=cam, capacity=tdet.serve_capacity(len(pts)),
            device="cuda")
        cloud = tdet._prep_filter_voxel(cloud, tuple(spec["workspace"]),
                                        spec["voxel_size"], True)
        yield cloud.compact_host(tdet.serve_capacity(int(cloud.mask.sum())))


def bucket_cloud(capacity):
    """(points, mask) of the first pcd scene's filter input at a serve
    bucket: its first ``capacity`` rows at 2048 and 8192, itself at
    16384, and at 65536 six copies 1 m apart along x (the sort's first
    key, so the cell order holds) padded with masked rows."""
    cloud = next(pcd_filter_inputs([200]))
    assert cloud.capacity == 16384
    points, mask = cloud.points, cloud.mask
    if capacity <= 16384:
        return points[:capacity].contiguous(), mask[:capacity].contiguous()
    live = points[mask]
    shift = torch.tensor([1.0, 0.0, 0.0], device="cuda")
    rows = torch.cat([live + i * shift for i in range(6)])
    pts = torch.full((capacity, 3), 1.0e6, device="cuda")
    pts[:len(rows)] = rows
    keep = torch.arange(capacity, device="cuda") < len(rows)
    return pts, keep


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [2048, 8192, 16384, 65536])
def test_outlier_knn_matches_emulation_on_card(capacity):
    """The kernel's mean distances at the serve buckets against the plain
    emulation of its arithmetic, bit for bit (at 65536 on 4096 rows drawn
    at random), twice; one launch a call. Its probe, with and without
    culling, gives the same bits; without culling it sweeps every (query,
    group) pair it judges, and with culling at most half of them."""
    from gpd_tpu_torch.ops import neighbors as nbr
    needs_card()
    points, mask = bucket_cloud(capacity)
    before = _build.LAUNCHES["outlier_knn"]
    got = nbr.outlier_knn(points, mask, 50)
    again = nbr.outlier_knn(points, mask, 50)
    assert _build.LAUNCHES["outlier_knn"] == before + 2
    rows = None
    if capacity > 16384:
        gen = torch.Generator(device="cuda").manual_seed(capacity)
        rows = torch.randperm(capacity, generator=gen, device="cuda")[:4096]
    want = knn_emulation(points, mask, 50, rows)
    sub = got if rows is None else got[rows]
    off = int((sub != want).sum())
    assert off == 0, f"{off} of {len(want)} means differ"
    assert torch.equal(got, again)
    culled, judged, swept, bound = nbr.outlier_knn_probe(points, mask, 50)
    full, judged_full, swept_full, bound_full = nbr.outlier_knn_probe(
        points, mask, 50, cull=False)
    live = int(mask.sum())
    assert judged_full == swept_full == live * -(-capacity // 32)
    assert swept <= judged <= judged_full and 2 * swept < judged_full
    assert bound == pytest.approx(bound_full, rel=1e-9)
    assert torch.equal(got, culled) and torch.equal(got, full)
    print(f"outlier_knn capacity {capacity}: {live} live; groups swept "
          f"{swept} of {judged} judged, {judged_full} pairs "
          f"({1 - swept / judged_full:.1%} culled); mean bound "
          f"{bound:.3e} m^2")


@pytest.mark.cuda
@pytest.mark.parametrize("seeds", [range(200, 216), range(300, 316),
                                   range(400, 416)])
def test_outlier_mask_matches_float64_on_card(seeds):
    """The filter's kept mask on the card (the kernel, then the mean and
    deviation) equals h100_bench's float64 StatisticalOutlierRemoval on
    the same voxelized points, on the 16 pcd_stream scenes and on two
    more sets of 16 scene seeds; prints the plain route's differences."""
    from gpd_tpu_torch.ops import neighbors as nbr
    from gpd_tpu_torch.ops import preprocess as pp
    needs_card()
    plain_off = 0
    for i, cloud in enumerate(pcd_filter_inputs(seeds)):
        points, mask = cloud.points, cloud.mask
        keep = pp._outlier_mask(points, mask, 50, 1.0)
        want = reference_keep(points, mask, 50)
        assert not bool(keep[~mask].any())
        assert torch.equal(keep[mask], want), \
            (seeds[i], int((keep[mask] != want).sum()))
        mean_d = nbr.outlier_knn_ref(points, mask, 50)
        n = mask.sum()
        mu = torch.where(mask, mean_d, 0.0).sum() / n
        sd = torch.sqrt(torch.where(mask, (mean_d - mu) ** 2, 0.0).sum() / n)
        plain_off += int(((mean_d <= mu + sd)[mask] != want).sum())
    print(f"outlier mask, scene seeds {seeds[0]}-{seeds[-1]}: kernel equals "
          f"float64 on all 16; the plain route differs at {plain_off} "
          f"points")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duplicates", "few_live", "masked_rows"])
def test_outlier_knn_edge_cases_on_card(case):
    """Duplicate points (equal distances at the list's edge), fewer than
    mean_k + 1 live points, masked rows among the live ones: the kernel
    against the emulation bit for bit, its kept mask against float64, 0
    where masked; and a cloud with no live point, and none at all."""
    from gpd_tpu_torch.ops import neighbors as nbr
    from gpd_tpu_torch.ops import preprocess as pp
    needs_card()
    points, mask, mean_k = (t.cuda() if torch.is_tensor(t) else t
                            for t in outlier_case(case))
    got = nbr.outlier_knn(points, mask, mean_k)
    assert torch.equal(got, knn_emulation(points, mask, mean_k))
    assert bool((got[~mask] == 0).all())
    keep = pp._outlier_mask(points, mask, mean_k, 1.0)
    assert torch.equal(keep[mask], reference_keep(points, mask, mean_k))
    assert not nbr.outlier_knn(points, torch.zeros_like(mask), mean_k).any()
    assert nbr.outlier_knn(points[:0], mask[:0], mean_k).shape == (0,)
    for k in (0, 1, 63):
        assert torch.equal(nbr.outlier_knn(points, mask, k),
                           knn_emulation(points, mask, k)), k


@pytest.mark.cuda
def test_outlier_knn_replays_as_called_on_card():
    """A CUDA graph of the wrapper records one launch and replays the
    eager call's means bit for bit; the replay calls no wrapper."""
    from gpd_tpu_torch.ops import neighbors as nbr
    needs_card()
    points, mask = bucket_cloud(16384)
    eager = nbr.outlier_knn(points, mask, 50)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nbr.outlier_knn(points, mask, 50)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.LAUNCHES["outlier_knn"]
    with torch.cuda.graph(graph):
        out = nbr.outlier_knn(points, mask, 50)
    assert _build.LAUNCHES["outlier_knn"] == before + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert _build.LAUNCHES["outlier_knn"] == before + 1
