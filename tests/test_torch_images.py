"""gpd_tpu_torch's descriptors against gpd_tpu on the CPU: the raster
sums, shadows and grasp images.

  - raster_blocks_ref against gpd_tpu's Pallas kernel _raster_blocks_pallas
    run with interpret=True: counts identical, values within 1e-5, also
    for one hand at K = 200 and 2047;
  - raster_sums_ref / raster_sums2_ref against _raster_sums_pallas /
    _raster_sums_pallas2 in interpret mode, the same tolerances and ragged
    shapes;
  - compute_shadows with JAX's own draws: shadow_valid identical, points
    within 1e-6;
  - make_images against gpd_tpu's make_images: at 12/15 channels against
    its float32 CPU route (the port's values enter the raster in bfloat16),
    at 1/3 channels against its Pallas route in interpret mode (both
    float32). The repo's own gate applies (tools/check_raster_tpu.py:100-105):
    under 0.5% of uint8 pixels off by more than one step.
"""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpd_tpu.detector as jdet
import gpd_tpu.ops.images as jimg
from gpd_tpu.config import DetectorConfig as JConfig
from gpd_tpu.config import ImageGeometry as JImageGeometry
from gpd_tpu_torch.config import ImageGeometry
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.ops import _build
from gpd_tpu_torch.ops import images as img
from test_torch_threads import set_cpu_share

set_cpu_share()

SIZE = 60


def T(a):
    return torch.from_numpy(np.array(a))


def interpret(pl_mod):
    orig = pl_mod.pallas_call

    def call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)
    return call


def jax_shadow_noise(key, S, V, K, n_sp, v_cap):
    """gpd_tpu's shadow draws for samples 0..S-1 of compute_shadows(key),
    in the layout of gpd_tpu_torch.ops.draws.shadow_noise."""
    rks = jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.arange(S, dtype=jnp.int32))
    u = jnp.stack([jax.vmap(lambda rk: jax.random.uniform(
        jax.random.fold_in(rk, 2 * c), (K, n_sp)))(rks) for c in range(V)], 1)
    jit = jax.vmap(lambda rk: jax.random.normal(
        jax.random.fold_in(rk, 1), (v_cap, 1)))(rks)[..., 0]
    return T(u), T(jit)


def raster_operands(rng, G, K, nval):
    idx = rng.integers(0, SIZE, (G, 4, K)).astype(np.int32)
    inside = rng.random((G, 1, K)) < 0.6
    idx = np.where(inside, idx, SIZE).astype(np.int32)
    vals = (rng.random((G, nval, K)) * inside).astype(np.float32)
    return idx, vals


class TestRasterBlocks:
    @pytest.mark.parametrize("with_shadow", [True, False])
    def test_ref_matches_pallas_interpret(self, with_shadow):
        rng = np.random.default_rng(int(with_shadow))
        G, Km, Ks = 4, 256, 384
        mi, mv = raster_operands(rng, G, Km, 6)
        si, sv = raster_operands(rng, G, Ks, 3)
        bf = jnp.bfloat16
        with mock.patch.object(jimg.pl, "pallas_call", interpret(jimg.pl)):
            ref = np.asarray(jimg._raster_blocks_pallas(
                jnp.asarray(mi), jnp.asarray(mv).astype(bf), jnp.asarray(si),
                jnp.asarray(sv).astype(bf), SIZE, with_shadow))
        tb = lambda a: T(a).to(torch.bfloat16)
        out = img.raster_blocks_ref(T(mi), tb(mv), T(si) if with_shadow else None,
                                    tb(sv) if with_shadow else None, SIZE).numpy()
        assert out.shape == ref.shape == (G, 21 if with_shadow else 15, 64, 64)
        counts = [4, 9, 14] + ([16, 18, 20] if with_shadow else [])
        np.testing.assert_array_equal(out[:, counts], ref[:, counts])
        np.testing.assert_allclose(out, ref, atol=1e-5)
        assert out[:, counts].sum() > 0
        assert not out[:, :, SIZE:, :].any() and not out[:, :, :, SIZE:].any()


    @pytest.mark.parametrize("K", [200, 2047])
    @pytest.mark.parametrize("with_shadow", [True, False])
    def test_ref_matches_pallas_interpret_ragged(self, with_shadow, K):
        """One hand, K short or not a multiple of 4 (the CUDA kernel's
        one-point-at-a-time walk): counts identical, values within 1e-5."""
        rng = np.random.default_rng(K + int(with_shadow))
        mi, mv = raster_operands(rng, 1, K, 6)
        si, sv = raster_operands(rng, 1, K, 3)
        bf = jnp.bfloat16
        with mock.patch.object(jimg.pl, "pallas_call", interpret(jimg.pl)):
            ref = np.asarray(jimg._raster_blocks_pallas(
                jnp.asarray(mi), jnp.asarray(mv).astype(bf), jnp.asarray(si),
                jnp.asarray(sv).astype(bf), SIZE, with_shadow))
        tb = lambda a: T(a).to(torch.bfloat16)
        out = img.raster_blocks_ref(T(mi), tb(mv), T(si) if with_shadow else None,
                                    tb(sv) if with_shadow else None, SIZE).numpy()
        assert out.shape == ref.shape == (1, 21 if with_shadow else 15, 64, 64)
        counts = [4, 9, 14] + ([16, 18, 20] if with_shadow else [])
        np.testing.assert_array_equal(out[:, counts], ref[:, counts])
        np.testing.assert_allclose(out, ref, atol=1e-5)
        assert out[:, counts].sum() > 0


def sums_operands(rng, G, K, Cp, n_rows=1):
    """Row sets, columns and pre-masked values with the count last, as
    scatter_mean builds them: ~60% of entries in the image, the rest on the
    sentinel (a few with only one index on it)."""
    inside = rng.random((G, K)) < 0.6
    rows = [np.where(inside, rng.integers(0, SIZE, (G, K)), SIZE)
            for _ in range(n_rows)]
    cols = np.where(inside | (rng.random((G, K)) < 0.1),
                    rng.integers(0, SIZE, (G, K)), SIZE)
    m = inside.astype(np.float32)[..., None]
    aug = np.concatenate([rng.random((G, K, Cp - 1)) * m, m], -1)
    return ([r.astype(np.int32) for r in rows], cols.astype(np.int32),
            aug.astype(np.float32))


class TestRasterSums:
    @pytest.mark.parametrize("Cp", [4, 2])
    def test_ref_matches_pallas_interpret(self, Cp):
        (rows,), cols, aug = sums_operands(np.random.default_rng(Cp), 4, 300,
                                           Cp)
        with mock.patch.object(jimg.pl, "pallas_call", interpret(jimg.pl)):
            ref = np.asarray(jimg._raster_sums_pallas(
                jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(aug), SIZE))
        out = img.raster_sums_ref(T(rows), T(cols), T(aug), SIZE).numpy()
        assert out.shape == ref.shape == (4, SIZE, SIZE, Cp)
        np.testing.assert_array_equal(out[..., -1], ref[..., -1])
        np.testing.assert_allclose(out, ref, atol=1e-5)
        assert out[..., -1].sum() > 0

    @pytest.mark.parametrize("K", [200, 2047])
    @pytest.mark.parametrize("Cp", [4, 2])
    def test_ref_matches_pallas_interpret_ragged(self, Cp, K):
        """One hand, K short or not a multiple of 4: counts identical,
        values within 1e-5."""
        (rows,), cols, aug = sums_operands(np.random.default_rng(K + Cp), 1,
                                           K, Cp)
        with mock.patch.object(jimg.pl, "pallas_call", interpret(jimg.pl)):
            ref = np.asarray(jimg._raster_sums_pallas(
                jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(aug), SIZE))
        out = img.raster_sums_ref(T(rows), T(cols), T(aug), SIZE).numpy()
        assert out.shape == ref.shape == (1, SIZE, SIZE, Cp)
        np.testing.assert_array_equal(out[..., -1], ref[..., -1])
        np.testing.assert_allclose(out, ref, atol=1e-5)
        assert out[..., -1].sum() > 0

    @pytest.mark.parametrize("Cp", [6, 3])
    def test_two_row_sets_match_pallas2_interpret(self, Cp):
        (ra, rb), cols, aug = sums_operands(np.random.default_rng(Cp), 4, 300,
                                            Cp, n_rows=2)
        with mock.patch.object(jimg.pl, "pallas_call", interpret(jimg.pl)):
            ref = np.asarray(jimg._raster_sums_pallas2(
                jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(cols),
                jnp.asarray(aug), SIZE))
        out = img.raster_sums2_ref(T(ra), T(rb), T(cols), T(aug), SIZE).numpy()
        assert out.shape == ref.shape == (4, 2, SIZE, SIZE, Cp)
        np.testing.assert_array_equal(out[..., -1], ref[..., -1])
        np.testing.assert_allclose(out, ref, atol=1e-5)
        assert not np.array_equal(out[:, 0], out[:, 1])

    @pytest.mark.parametrize("K", [200, 2047])
    @pytest.mark.parametrize("Cp", [6, 3])
    def test_two_row_sets_match_pallas2_interpret_ragged(self, Cp, K):
        """One hand, K short or not a multiple of 4 (the CUDA kernel's
        one-point-at-a-time walk over both row sets): counts identical,
        values within 1e-5."""
        (ra, rb), cols, aug = sums_operands(np.random.default_rng(K + Cp), 1,
                                            K, Cp, n_rows=2)
        with mock.patch.object(jimg.pl, "pallas_call", interpret(jimg.pl)):
            ref = np.asarray(jimg._raster_sums_pallas2(
                jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(cols),
                jnp.asarray(aug), SIZE))
        out = img.raster_sums2_ref(T(ra), T(rb), T(cols), T(aug), SIZE).numpy()
        assert out.shape == ref.shape == (1, 2, SIZE, SIZE, Cp)
        np.testing.assert_array_equal(out[..., -1], ref[..., -1])
        np.testing.assert_allclose(out, ref, atol=1e-5)
        assert out[:, 0, ..., -1].sum() > 0 and out[:, 1, ..., -1].sum() > 0


class TestShadows:
    @pytest.mark.parametrize("num_cameras", [1, 2])
    def test_matches_gpd_tpu_with_its_draws(self, num_cameras):
        rng = np.random.default_rng(num_cameras)
        S, K = 6, 150
        geom = ImageGeometry()
        centers = rng.uniform(-0.1, 0.1, (S, 1, 3))
        pts = (centers + rng.normal(scale=0.02, size=(S, K, 3))).astype(
            np.float32)
        valid = rng.random((S, K)) < 0.8
        vp = np.array([[0.4, 0.1, 0.5], [-0.3, 0.4, 0.4]],
                      np.float32)[:num_cameras]
        cam = rng.integers(1, 1 << num_cameras, (S, K)).astype(np.uint32)
        n_sp = img.num_shadow_points(geom)
        v_cap = 2048
        key = jax.random.PRNGKey(9)
        pj, vj = jimg.compute_shadows(
            key, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(cam),
            jnp.asarray(vp), jnp.float32(img.shadow_length_of(geom)),
            n_sp=n_sp, v_cap=v_cap)
        u, jit = jax_shadow_noise(key, S, num_cameras, K, n_sp, v_cap)
        pt, vt = img.compute_shadows(
            T(pts), T(valid), T(cam.astype(np.int64)), T(vp),
            img.shadow_length_of(geom), n_sp, v_cap, u, jit)
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
        v = vt.numpy()
        assert v.sum() > 0
        np.testing.assert_allclose(np.asarray(pj)[v], pt.numpy()[v], atol=1e-6)


@pytest.fixture(scope="module")
def hands():
    """gpd_tpu's candidates and descriptor inputs on a small two-camera
    table scene, for both neighborhood kinds."""
    rng = np.random.default_rng(5)
    pts, nrm = syn.make_scene(rng, n_objects=2, points_per_object=1500,
                              table_points=1500, table_halfsize=0.15)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))
    det = jdet.GraspDetector(JConfig(num_samples=24), params={})
    jc = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    key = jax.random.PRNGKey(3)
    spos, smask = det.sample_cloud(jc, key)
    out = {}
    for cap in (1 << 20, 256):        # identity, then nearest-K
        cfg = dataclasses.replace(det.effective_config(jc),
                                  image_neighbors_cap=min(cap, jc.capacity))
        g = jdet.candidates_stage(jc, spos, smask, cfg)
        inputs = jdet.image_inputs_stage(jc, spos, smask, key, cfg)
        g = jdet._compact_hands(g, 128)
        out[cap] = (jc, g, inputs, cfg)
    return out


@pytest.mark.parametrize("channels", [12, 15])
@pytest.mark.parametrize("cap", [1 << 20, 256])
def test_make_images_matches_f32_route(hands, channels, cap):
    jc, g, (nn_idx, nn_valid, spts, svalid), cfg = hands[cap]
    sid = np.asarray(g.sample_id)
    h_nvalid = np.asarray(nn_valid)[sid] & np.asarray(g.valid)[:, None]
    if nn_idx is None:
        h_pts, h_nrm = np.asarray(jc.points), np.asarray(jc.normals)
    else:
        h_idx = np.asarray(nn_idx)[sid]
        h_pts = np.asarray(jc.points)[h_idx]
        h_nrm = np.asarray(jc.normals)[h_idx]
    shadow = channels == 15
    sp = np.asarray(spts)[sid] if shadow else None
    sv = np.asarray(svalid)[sid] if shadow else None
    hand = [np.asarray(a) for a in (g.orientation, g.sample, g.bottom,
                                    g.center, g.valid)]
    ref = np.asarray(jimg.make_images(
        jnp.asarray(h_pts), jnp.asarray(h_nrm), jnp.asarray(h_nvalid),
        *map(jnp.asarray, hand), JImageGeometry(num_channels=channels),
        shadow_pts=None if sp is None else jnp.asarray(sp),
        shadow_valid=None if sv is None else jnp.asarray(sv)))
    out = img.make_images(
        T(h_pts), T(h_nrm), T(h_nvalid), *map(T, hand),
        ImageGeometry(num_channels=channels),
        shadow_pts=None if sp is None else T(sp),
        shadow_valid=None if sv is None else T(sv)).numpy()
    assert out.shape == ref.shape == (128, SIZE, SIZE, channels)
    assert out.dtype == np.uint8
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert (diff > 1).mean() < 5e-3, (diff > 1).mean()
    assert np.asarray(g.valid).sum() > 0 and out.any()


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("cap", [1 << 20, 256])
def test_make_images_p0_matches_pallas_route(hands, channels, cap):
    """1 and 3 channels: gpd_tpu's _scatter_mean route with its Pallas
    kernel (_use_pallas patched on, interpret mode) on the same hands."""
    jc, g, (nn_idx, nn_valid, _, _), cfg = hands[cap]
    sid = np.asarray(g.sample_id)
    h_nvalid = np.asarray(nn_valid)[sid] & np.asarray(g.valid)[:, None]
    if nn_idx is None:
        h_pts, h_nrm = np.asarray(jc.points), np.asarray(jc.normals)
    else:
        h_idx = np.asarray(nn_idx)[sid]
        h_pts = np.asarray(jc.points)[h_idx]
        h_nrm = np.asarray(jc.normals)[h_idx]
    hand = [np.asarray(a) for a in (g.orientation, g.sample, g.bottom,
                                    g.center, g.valid)]
    jax.clear_caches()
    try:
        with mock.patch.object(jimg, "_use_pallas", lambda: True), \
                mock.patch.object(jimg.pl, "pallas_call", interpret(jimg.pl)):
            ref = np.asarray(jimg.make_images(
                jnp.asarray(h_pts), jnp.asarray(h_nrm), jnp.asarray(h_nvalid),
                *map(jnp.asarray, hand), JImageGeometry(num_channels=channels)))
    finally:
        jax.clear_caches()
    before = _build.LAUNCHES["raster_sums"]
    out = img.make_images(T(h_pts), T(h_nrm), T(h_nvalid), *map(T, hand),
                          ImageGeometry(num_channels=channels)).numpy()
    assert _build.LAUNCHES["raster_sums"] == before      # no kernel on the CPU
    assert out.shape == ref.shape == (128, SIZE, SIZE, channels)
    assert out.dtype == np.uint8
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert (diff > 1).mean() < 5e-3, (diff > 1).mean()
    assert np.asarray(g.valid).sum() > 0 and out.any()


def test_unknown_channel_count_raises():
    z = torch.zeros((1, 3))
    with pytest.raises(ValueError):
        img.make_images(z, z, torch.zeros((1, 1), dtype=torch.bool),
                        torch.eye(3)[None], z, torch.zeros(1), torch.zeros(1),
                        torch.ones(1, dtype=torch.bool),
                        ImageGeometry(num_channels=4))
