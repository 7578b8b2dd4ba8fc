"""gpd_tpu_torch's geometry ops against gpd_tpu on the CPU: neighbors,
eigh3, preprocessing, normals, frames and the sample draws.

Inputs come from numpy seeds; gpd_tpu runs jitted as its pipeline runs it,
the port with device="cpu". Tolerances: masks, indices and voxelized
points identical; moments, eigenvectors, normals and frames within 1e-5 on
inputs whose eigenproblems are well conditioned (on flat patches the
reference's frame axes depend on float summation order; ROADMAP.md C).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpd_tpu.detector as jdet
from gpd_tpu.core.types import CloudArrays as JCloud
from gpd_tpu.core.types import Samples as JSamples
from gpd_tpu.ops import eigh3 as jeigh
from gpd_tpu.ops import frames as jframes
from gpd_tpu.ops import neighbors as jnbr
from gpd_tpu.ops import normals as jnormals
from gpd_tpu.ops import preprocess as jpp
from gpd_tpu_torch.core.types import CloudArrays, Samples, _next_size
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.ops import eigh3, frames, neighbors, normals, preprocess
from gpd_tpu_torch.ops import draws
from test_torch_threads import set_cpu_share

set_cpu_share()


def T(a):
    return torch.from_numpy(np.array(a))


def grid_cloud(rng, n, q, extent=0.1, voxel=0.003):
    """Points snapped to a voxel grid (equal distances are common there,
    so ties decide nearest-K order) and the first q as queries."""
    p = rng.uniform(-extent, extent, (n, 3))
    p = (np.round(p / voxel) * voxel).astype(np.float32)
    pm = np.ones(n, bool)
    pm[-n // 10:] = False
    qm = np.ones(q, bool)
    qm[::7] = False
    return p, pm, p[:q].copy(), qm


def cloud_pair(points, view_points=None, cam_source=None, normals_=None):
    j = JCloud.from_numpy(points, view_points=view_points,
                          cam_source=cam_source, normals=normals_)
    t = CloudArrays.from_numpy(points, view_points=view_points,
                               cam_source=cam_source, normals=normals_,
                               device="cpu")
    return j, t


# gpd_tpu's nearest-K routes: exact=True, exact=False, and exact=False
# with FORCE_EXACT set. The exact=True cases keep the ids they had before
# the port took ``exact``.
ROUTES = {"exact=True": (True, False), "exact=False": (False, False),
          "FORCE_EXACT": (False, True)}


def _route_cases(shapes):
    return [pytest.param(*shape, route, id="-".join(map(str, shape)) + (
        "" if route == "exact=True" else "-" + route))
        for route in ROUTES for shape in shapes]


class TestNeighbors:
    @pytest.mark.parametrize("n,q,k,block,route", _route_cases([
        (700, 50, 64, 1024),      # single block
        (1500, 300, 96, 128),     # blocked queries
        (400, 60, 512, 1024),     # cap covers the cloud: identity indices
    ]))
    def test_radius_neighbors_identical(self, n, q, k, block, route,
                                        monkeypatch):
        """radius_neighbors, and select_min_k / select_max_k on the grid's
        tie-rich distances, equal gpd_tpu's same call on each route."""
        exact, force = ROUTES[route]
        monkeypatch.setattr(jnbr, "FORCE_EXACT", force)
        monkeypatch.setattr(neighbors, "FORCE_EXACT", force)
        assert neighbors._use_approx("cpu") is jnbr._use_approx() is False
        assert neighbors._use_approx("cuda") is not force
        rng = np.random.default_rng(n + q)
        p, pm, qp, qm = grid_cloud(rng, n, q)
        ij, vj = jnbr.radius_neighbors(jnp.asarray(qp), jnp.asarray(qm),
                                       jnp.asarray(p), jnp.asarray(pm),
                                       0.05, k, block=block, exact=exact)
        it, vt = neighbors.radius_neighbors(T(qp), T(qm), T(p), T(pm), 0.05,
                                            k, block=block, exact=exact)
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
        np.testing.assert_array_equal(np.asarray(ij), it.numpy())
        assert vt.sum() > 0

        d2 = np.sum((qp[:, None, :] - p[None, :, :]) ** 2, axis=-1)
        kk = min(k, n)
        for jsel, tsel, x in [(jnbr.select_min_k, neighbors.select_min_k, d2),
                              (jnbr.select_max_k, neighbors.select_max_k,
                               -d2)]:
            jv, ji = jax.jit(jsel, static_argnums=(1, 2))(jnp.asarray(x), kk,
                                                          exact)
            tv, ti = tsel(T(x), kk, exact=exact)
            np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
            np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=0,
                                       atol=1e-6)
        assert (np.diff(np.sort(d2, axis=1)[:, :kk], axis=1) == 0).any()

    def test_approx_route_off_a_tpu_is_exact(self):
        """gpd_tpu's approximate route off a TPU, jax.lax.approx_min_k /
        approx_max_k lowered to their sort-and-slice fallback (here on the
        CPU, as on a GPU), selects the values the port's selection does; on
        distinct values, the same indices too."""
        rng = np.random.default_rng(3)
        tied = rng.integers(0, 40, (64, 700)).astype(np.float32)
        distinct = rng.permutation(64 * 700).reshape(64, 700).astype(
            np.float32)
        for x in (tied, distinct):
            for approx, sel in [
                    (jax.lax.approx_min_k, neighbors.select_min_k),
                    (jax.lax.approx_max_k, neighbors.select_max_k)]:
                jv, ji = jax.jit(approx, static_argnums=1)(jnp.asarray(x), 48)
                tv, ti = sel(T(x), 48, exact=False)
                np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
                if x is distinct:
                    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())

    def test_force_exact_reads_gpd_tpu_variable(self, monkeypatch):
        """FORCE_EXACT comes from GPD_TPU_EXACT_NEIGHBORS at import, as in
        gpd_tpu."""
        was = neighbors.FORCE_EXACT
        try:
            for value, want in [("1", True), ("0", False)]:
                monkeypatch.setenv("GPD_TPU_EXACT_NEIGHBORS", value)
                assert importlib.reload(neighbors).FORCE_EXACT is want
                assert neighbors._use_approx("cuda") is not want
        finally:
            neighbors.FORCE_EXACT = was

    def test_radius_mask_identical(self):
        p, pm, qp, qm = grid_cloud(np.random.default_rng(1), 900, 120)
        vj, _ = jax.jit(jnbr.radius_mask, static_argnums=4)(
            jnp.asarray(qp), jnp.asarray(qm), jnp.asarray(p), jnp.asarray(pm),
            0.03)
        vt, _ = neighbors.radius_mask(T(qp), T(qm), T(p), T(pm), 0.03)
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())

    @pytest.mark.parametrize("q,block", [(120, 1024), (300, 128)])
    def test_radius_moments(self, q, block):
        rng = np.random.default_rng(q)
        p, pm, qp, qm = grid_cloud(rng, 1200, q)
        n = rng.normal(size=(1200, 3))
        n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
        feats = np.concatenate([n[:, :, None] * n[:, None, :]],
                               1).reshape(1200, 9).astype(np.float32)
        sj, cj = jnbr.radius_moments(jnp.asarray(qp), jnp.asarray(qm),
                                     jnp.asarray(p), jnp.asarray(pm),
                                     jnp.asarray(feats), 0.03, block=block)
        st, ct = neighbors.radius_moments(T(qp), T(qm), T(p), T(pm),
                                          T(feats), 0.03, block=block)
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        np.testing.assert_allclose(np.asarray(sj), st.numpy(), atol=1e-5)

    def test_gather_neighborhoods_identical(self):
        """Each (N, ...) array at the nearest-K indices; one array comes
        back alone, several as a tuple."""
        rng = np.random.default_rng(5)
        p, pm, qp, qm = grid_cloud(rng, 600, 40)
        nrm = rng.normal(size=(600, 3)).astype(np.float32)
        cs = rng.integers(0, 4, 600)
        ij, vj = jnbr.radius_neighbors(jnp.asarray(qp), jnp.asarray(qm),
                                       jnp.asarray(p), jnp.asarray(pm),
                                       0.05, 32, exact=True)
        it, vt = neighbors.radius_neighbors(T(qp), T(qm), T(p), T(pm), 0.05,
                                            32)
        want = jnbr.gather_neighborhoods(ij, vj, jnp.asarray(p),
                                         jnp.asarray(nrm), jnp.asarray(cs))
        got = neighbors.gather_neighborhoods(it, vt, T(p), T(nrm), T(cs))
        assert len(got) == 3 and got[0].shape == (40, 32, 3)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        one = neighbors.gather_neighborhoods(it, vt, T(p))
        np.testing.assert_array_equal(
            np.asarray(jnbr.gather_neighborhoods(ij, vj, jnp.asarray(p))),
            one.numpy())


class TestEigh3:
    def test_matches_gpd_tpu(self):
        rng = np.random.default_rng(0)
        q, _ = np.linalg.qr(rng.normal(size=(500, 3, 3)))
        lam = rng.uniform(0.5, 1.0, (500, 3)) * np.array([1.0, 3.0, 9.0])
        lam[:100, 0] = 0.0                                 # rank-deficient
        A = np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)
        wj, Vj = jax.jit(jeigh.eigh3_sym)(jnp.asarray(A))
        wt, Vt = eigh3.eigh3_sym(T(A))
        np.testing.assert_allclose(np.asarray(wj), wt.numpy(), atol=1e-5)
        np.testing.assert_allclose(np.asarray(Vj), Vt.numpy(), atol=1e-5)


def two_camera_scene(seed, **kw):
    rng = np.random.default_rng(seed)
    pts, nrm = syn.make_scene(rng, **kw)
    return syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))


class TestPreprocess:
    def test_filter_and_voxelize_identical(self):
        p, cs, vp = two_camera_scene(3, n_objects=2, points_per_object=1500,
                                     table_points=1500, table_halfsize=0.15)
        ws = (-0.1, 0.12, -1, 1, -1, 0.2)
        jc, tc = cloud_pair(p, vp, cs)
        jc = jdet._prep_filter_voxel(jc, ws, 0.003, True)
        tc = preprocess.voxelize(preprocess.filter_workspace(tc, ws), 0.003)
        np.testing.assert_array_equal(np.asarray(jc.mask), tc.mask.numpy())
        np.testing.assert_array_equal(np.asarray(jc.points), tc.points.numpy())
        np.testing.assert_array_equal(np.asarray(jc.cam_source),
                                      tc.cam_source.numpy())
        assert 0 < tc.mask.sum() < len(p)

    def test_remove_nans_identical(self):
        """Rows with a NaN or an infinity leave the mask and move to
        PAD_COORD; padded slots stay out."""
        rng = np.random.default_rng(6)
        p = rng.normal(size=(300, 3)).astype(np.float32)
        p[::17, 1] = np.nan
        p[5, 2] = np.inf
        p[8, 0] = -np.inf
        jc, tc = cloud_pair(p)
        jr, tr = jpp.remove_nans(jc), preprocess.remove_nans(tc)
        np.testing.assert_array_equal(np.asarray(jr.mask), tr.mask.numpy())
        np.testing.assert_array_equal(np.asarray(jr.points), tr.points.numpy())
        assert tr.mask.sum() == 300 - len(range(0, 300, 17)) - 2
        assert torch.isfinite(tr.points).all()

    @pytest.mark.parametrize("n,capacity", [(1, None), (8, None), (9, None),
                                            (300, None), (5, 64)])
    def test_samples_from_numpy_identical(self, n, capacity):
        """PAD_COORD padding to _next_size with a minimum of 8, or to a
        given capacity."""
        pos = np.random.default_rng(n).normal(size=(n, 3))
        j = JSamples.from_numpy(pos, capacity=capacity)
        t = Samples.from_numpy(pos, capacity=capacity, device="cpu")
        np.testing.assert_array_equal(np.asarray(j.positions),
                                      t.positions.numpy())
        np.testing.assert_array_equal(np.asarray(j.mask), t.mask.numpy())
        assert t.positions.dtype == torch.float32 and t.mask.dtype == torch.bool

    def test_next_size_and_compaction(self):
        for n in (1, 255, 257, 1000, 13500, 70000):
            from gpd_tpu.core.types import _next_size as jnext
            assert _next_size(n) == jnext(n)
        p = np.random.default_rng(0).normal(size=(300, 3)).astype(np.float32)
        jc, tc = cloud_pair(p)
        tc = preprocess.filter_workspace(tc, (-1, 1, -1, 1, -1, 1)).compact_host()
        jc = jdet._prep_filter_voxel(jc, (-1, 1, -1, 1, -1, 1), 0.003,
                                     False).compact_host()
        assert tc.capacity == jc.capacity
        np.testing.assert_array_equal(np.asarray(jc.points), tc.points.numpy())


@functools.lru_cache(maxsize=None)
def cylinder(radius):
    """One uncapped cylinder seen by two cameras, voxelized by both
    packages: a curved surface with no flat patch, centered near the
    origin."""
    rng = np.random.default_rng(11)
    pts, nrm = syn.sample_cylinder(rng, radius, 0.12, 3000, caps=False)
    cams = np.array([[0.5, 0.1, 0.2], [-0.3, 0.45, 0.1]], np.float32)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, cams)
    jc, tc = cloud_pair(p, vp, cs)
    jc = jdet._prep_filter_voxel(jc, (-1, 1, -1, 1, -1, 1), 0.003, True)
    tc = preprocess.voxelize(tc, 0.003)
    return jc.compact_host(), tc.compact_host()


class TestNormalsAndFrames:
    def test_normals_lattice(self):
        """On a cloud of dyadic lattice points, symmetric about the origin,
        the centroid is exactly 0 and every moment sum is exact in float32,
        so both packages see identical covariances."""
        g = np.arange(-24, 25)
        x, y, z = np.meshgrid(g, g, g, indexing="ij")
        pts = np.stack([x, y, z], -1).reshape(-1, 3)
        r = np.linalg.norm(pts, axis=1)
        pts = (pts[(r > 20) & (r <= 21)] / 512.0).astype(np.float32)
        vp = np.array([[0.3, 0.2, 0.1], [-0.2, -0.3, 0.25]], np.float32)
        cam = np.stack([pts[:, 0] > -0.01, pts[:, 0] < 0.01]).astype(np.int32)
        jc, tc = cloud_pair(pts, vp, cam)
        jn = jdet._prep_normals(jc, 0.008, 128, do_estimate=True, refine_k=0,
                                flip=False)
        tn = normals.reverse_normals_cloud(normals.estimate_normals(tc, 0.008))
        np.testing.assert_allclose(np.asarray(jn.normals), tn.normals.numpy(),
                                   atol=1e-5)
        assert (tn.normals.norm(dim=1)[tn.mask] > 0.99).all()

    def test_normals_as_accurate_as_gpd_tpu(self):
        """On a scanned surface the float32 moment sums cancel (cov =
        E[pp^T] - mu mu^T), and their summation order sets the last digits:
        measured against a float64 evaluation of the same formula, gpd_tpu's
        own normals are off by up to ~1e-2. The port must be no less
        accurate, point for point in distribution."""
        jc, tc = cylinder(0.035)
        jn = np.asarray(jdet._prep_normals(jc, 0.03, 128, do_estimate=True,
                                           refine_k=0, flip=False).normals)
        tn = normals.reverse_normals_cloud(normals.estimate_normals(tc, 0.03))
        c64 = dataclasses.replace(tc, points=tc.points.double(),
                                  view_points=tc.view_points.double())
        ref = normals.reverse_normals_cloud(
            normals.estimate_normals(c64, 0.03)).normals.numpy()
        m = tc.mask.numpy()
        err_j = np.abs(jn - ref)[m].max(1)
        err_t = np.abs(tn.normals.numpy() - ref)[m].max(1)
        for q in (0.9, 0.99, 1.0):
            assert np.quantile(err_t, q) <= 1.5 * np.quantile(err_j, q), q
        assert np.median(err_t) < 1e-5

    def test_reverse_and_refine(self):
        jc, tc = cylinder(0.035)
        rng = np.random.default_rng(2)
        nrm = rng.normal(size=(tc.capacity, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        args = (jc.points, jnp.asarray(nrm), jc.mask, jc.cam_source,
                jc.view_points)
        rj = jnormals.reverse_normals(*args)
        rt = normals.reverse_normals(tc.points, T(nrm), tc.mask,
                                     tc.cam_source, tc.view_points)
        np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
        fj = jnormals.refine_normals(jc.points, rj, jc.mask, k=10)
        ft = normals.refine_normals(tc.points, rt, tc.mask, k=10)
        np.testing.assert_allclose(np.asarray(fj), ft.numpy(), atol=1e-5)

    def test_frames(self):
        """Frames where gpd_tpu's own frame is defined: the curvature axis is
        the eigenvector of the smallest eigenvalue of M = sum n n^T, so where
        the two smaller eigenvalues nearly coincide it moves with the last
        bits of M (ROADMAP.md C). Compared where (l1 - l0) / l2 > 0.05,
        on a cylinder thin enough to curve within the frame radius."""
        jc, tc = cylinder(0.015)
        jn = jdet._prep_normals(jc, 0.03, 128, do_estimate=True, refine_k=0,
                                flip=False)
        S = 48
        spos = np.asarray(jc.points)[:S * 11:11]
        smask = np.ones(S, bool)
        smask[5] = False
        fj, vj = jframes.estimate_frames(jnp.asarray(spos), jnp.asarray(smask),
                                         jn.points, jn.mask, jn.normals, 0.01)
        ft, vt = frames.estimate_frames(T(spos), T(smask), tc.points, tc.mask,
                                        T(jn.normals), 0.01)
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
        ok = np.asarray(vj) & frame_gap_ok(jn, spos, 0.01)
        assert ok.sum() >= S // 4
        np.testing.assert_allclose(np.asarray(fj)[ok], ft.numpy()[ok],
                                   atol=1e-5)

    @pytest.mark.parametrize("op", ["estimate_frames", "estimate_normals"])
    def test_k_is_accepted_and_unused(self, op):
        """gpd_tpu takes ``k`` at the same place and drops it; a call with
        it equals the call without, bit for bit."""
        _, tc = cylinder(0.015)
        if op == "estimate_normals":
            want = normals.estimate_normals(tc, 0.03).normals
            got = normals.estimate_normals(tc, 0.03, 7).normals
            np.testing.assert_array_equal(want.numpy(), got.numpy())
            got = normals.estimate_normals(tc, 0.03, k=300).normals
            np.testing.assert_array_equal(want.numpy(), got.numpy())
            return
        cloud = normals.estimate_normals(tc, 0.03)
        args = (cloud.points[:40], cloud.mask[:40], cloud.points, cloud.mask,
                cloud.normals, 0.01)
        want = frames.estimate_frames(*args)
        for got in (frames.estimate_frames(*args, 5),
                    frames.estimate_frames(*args, k=300)):
            for a, b in zip(want, got):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


def frame_gap_ok(jcloud, spos, radius, min_gap=0.05):
    """(S,) bool: gpd_tpu's local frame at each sample is well conditioned,
    (l1 - l0) / l2 > min_gap for the eigenvalues of M = sum n n^T."""
    n = np.asarray(jcloud.normals, np.float64)
    p = np.asarray(jcloud.points, np.float64)
    inr = (np.sum((spos[:, None, :] - p[None]) ** 2, -1) <= radius ** 2) & \
        np.asarray(jcloud.mask)[None]
    M = np.einsum("sk,ki,kj->sij", inr.astype(np.float64), n, n)
    w = np.linalg.eigvalsh(M)
    return (w[:, 1] - w[:, 0]) > min_gap * np.maximum(w[:, 2], 1e-12)


class TestDraws:
    def test_subsample_without_replacement_pool_first(self):
        pool = torch.zeros(500, dtype=torch.bool)
        pool[::3] = True
        gen = torch.Generator().manual_seed(0)
        idx, valid = preprocess.subsample_uniform(gen, pool, 200)
        assert len(set(idx.tolist())) == 200
        n_pool = int(pool.sum())
        assert pool[idx[:n_pool]].all() and valid[:n_pool].all()
        assert not valid[n_pool:].any()
        with pytest.raises(ValueError):
            draws.subsample(gen, pool, 501)

    def test_shadow_noise_shapes_and_seed(self):
        a = draws.shadow_noise(torch.Generator().manual_seed(4), 5, 2, 7, 3,
                               11, "cpu")
        b = draws.shadow_noise(torch.Generator().manual_seed(4), 5, 2, 7, 3,
                               11, "cpu")
        assert a[0].shape == (5, 2, 7, 3) and a[1].shape == (5, 11)
        assert ((a[0] >= 0) & (a[0] < 1)).all()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
