"""The whole slice, gpd_tpu_torch.detector against gpd_tpu.detector on the
CPU, and properties of the port itself.

The slice: GraspDetector.preprocess_cloud + detect of both packages, on
two-camera scenes, at 15, 12, 3 and 1 channels.

  - Scanned rods on a table: the voxelized clouds must be identical; detect
    then runs on gpd_tpu's preprocessed cloud in both packages, because the
    normals' last bits come from cancelling float32 moment sums whose order
    differs (test_torch_ops.py holds them to gpd_tpu's own accuracy;
    ROADMAP.md C). image_neighbors_cap=256, so the nearest-K image route
    runs.
  - A tube of dyadic lattice points, where the moment sums are exact: each
    package detects on its own preprocessed cloud (identity image
    neighborhoods).

Both detects get the same sample positions (taken where gpd_tpu's local
frame is defined), gpd_tpu's draws injected through
gpd_tpu_torch.ops.draws, and the same weights (the packaged 15- and
3-channel checkpoints; one random-init dict at 12 and 1 channels).
gpd_tpu runs its accelerator routes, the Pallas rasters in interpret mode.
The selected grasps must be the same set, positions within 1e-5 and scores
within 1e-3.

The preprocessing options (statistical outliers, RANSAC plane fits,
sampling above the plane, plane removal before the images), the serving
capacity buckets, the staged route and score_candidates' images are held
against gpd_tpu the same way; profiling's traces of detect are checked on
the port alone.
"""

import dataclasses
import json
import os
import subprocess
import sys
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpd_tpu.detector as jdet
import gpd_tpu.ops.images as jimg
import gpd_tpu.ops.preprocess as jpp
from gpd_tpu.config import DetectorConfig as JConfig
from gpd_tpu.config import ImageGeometry as JImageGeometry
from gpd_tpu.core.types import CloudArrays as JCloud
from gpd_tpu.net import lenet as jlenet
from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch import profiling
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.core.types import CloudArrays, Grasps
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.ops import draws
from gpd_tpu_torch.ops import preprocess as tpp
from test_torch_threads import set_cpu_share, share_env

set_cpu_share()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))


def jax_noise(key, S, V, K, n_sp, v_cap):
    """gpd_tpu's shadow draws of detect(key) for samples 0..S-1, in the
    layout of gpd_tpu_torch.ops.draws.shadow_noise."""
    rks = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(key, 2), jnp.arange(S, dtype=jnp.int32))
    u = jnp.stack([jax.vmap(lambda rk: jax.random.uniform(
        jax.random.fold_in(rk, 2 * c), (K, n_sp)))(rks) for c in range(V)], 1)
    jit = jax.vmap(lambda rk: jax.random.normal(
        jax.random.fold_in(rk, 1), (v_cap, 1)))(rks)[..., 0]
    return T(u), T(jit)


def inject(key):
    return mock.patch.object(
        draws, "shadow_noise",
        lambda gen, S, V, K, n_sp, v_cap, device: jax_noise(
            key, S, V, K, n_sp, v_cap))


@jax.jit
def _jax_triplets(key, mask):
    """fit_plane_ransac's draw (gpd_tpu/ops/preprocess.py:169-171)."""
    probs = mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return jax.random.choice(key, mask.shape[0], shape=(128, 3), p=probs)


def inject_triplets(key):
    """draws.ransac_triplets returns gpd_tpu's triplets for ``key``."""
    return mock.patch.object(
        draws, "ransac_triplets",
        lambda gen, mask, num_iters: T(_jax_triplets(
            key, jnp.asarray(mask.numpy()))).long())


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


def port_cloud(jc):
    return CloudArrays(points=T(jc.points), normals=T(jc.normals),
                       cam_source=T(jc.cam_source).to(torch.int64),
                       mask=T(jc.mask), view_points=T(jc.view_points))


def port_grasps(g):
    return Grasps(**{f.name: T(getattr(g, f.name)).to(
        torch.int64 if f.name in ("sample_id", "finger_placement") else None)
        for f in dataclasses.fields(Grasps)})


def rod_scene(seed):
    """Three thin upright rods (graspable, curved, so their frames are
    defined) on a small table patch, seen by two cameras."""
    rng = np.random.default_rng(seed)
    parts, nrms = [], []
    for x, y in ((-0.05, -0.03), (0.04, -0.04), (0.0, 0.05)):
        p, n = syn.sample_cylinder(rng, rng.uniform(0.012, 0.02), 0.1, 1500)
        parts.append(p + np.array([x, y, 0.05], np.float32))
        nrms.append(n)
    txy = rng.uniform(-0.1, 0.1, (1200, 2)).astype(np.float32)
    parts.append(np.concatenate([txy, np.zeros((1200, 1), np.float32)], 1))
    nrms.append(np.tile(np.array([0, 0, 1], np.float32), (1200, 1)))
    cams = np.array([[0.45, 0.15, 0.35], [-0.2, 0.45, 0.3]], np.float32)
    return syn.render_fused_views(rng, np.concatenate(parts),
                                  np.concatenate(nrms), cams)


def rods_only(seed):
    """Three thin upright rods without caps and without a table, seen by
    two cameras: every neighborhood is curved. With normals estimated over
    6 mm (``ROD_KW``) the normals follow the curvature, and frames over
    2 cm see them turn: every surface point and nearly every point within
    a few mm of the surface has a well-conditioned frame."""
    rng = np.random.default_rng(seed)
    parts, nrms = [], []
    for x, y in ((-0.05, -0.03), (0.04, -0.04), (0.0, 0.05)):
        p, n = syn.sample_cylinder(rng, rng.uniform(0.007, 0.01), 0.1, 1800,
                                   caps=False)
        parts.append(p + np.array([x, y, 0.05], np.float32))
        nrms.append(n)
    cams = np.array([[0.45, 0.15, 0.35], [-0.2, 0.45, 0.3]], np.float32)
    return syn.render_fused_views(rng, np.concatenate(parts),
                                  np.concatenate(nrms), cams)


ROD_KW = dict(normals_radius=0.006, nn_radius_frames=0.02)


def sample_where_frames_defined(jd, jc, n, seed=0):
    """``n`` cloud points, in a seeded random order, at which gpd_tpu's local
    frame is well conditioned; all valid."""
    pool = np.asarray(jc.points)[np.asarray(jc.mask)]
    pool = pool[np.random.default_rng(seed).permutation(len(pool))]
    spos = pool[frame_gap_ok(jc, pool, jd.cfg.nn_radius_frames)][:n]
    assert len(spos) == n
    return spos, np.ones(n, bool)


def _interpret(call):
    def run(*args, **kw):
        kw["interpret"] = True
        return call(*args, **kw)
    return run


def jax_detect(jd, jc, spos, smask, key):
    """gpd_tpu's detect on its bfloat16 channel-major route, the Pallas
    raster in interpret mode."""
    jax.clear_caches()
    try:
        with mock.patch.object(jimg, "_use_pallas", lambda: True), \
                mock.patch.object(jimg.pl, "pallas_call",
                                  _interpret(jimg.pl.pallas_call)):
            return jd.detect(jc, jnp.asarray(spos), jnp.asarray(smask),
                             key=key, verbose=False).to_host()
    finally:
        jax.clear_caches()


def assert_same_selection(gj, gt):
    """The same set of selected grasps: positions and orientations within
    1e-5, scores within 1e-3, all finite."""
    vj, vt = gj.valid, gt.valid
    assert vj.sum() == vt.sum() > 0
    assert np.isfinite(gj.score[vj]).all() and np.isfinite(gt.score[vt]).all()
    oj = np.lexsort(gj.position[vj].T)
    ot = np.lexsort(gt.position[vt].T)
    np.testing.assert_allclose(gj.position[vj][oj], gt.position[vt][ot],
                               atol=1e-5)
    np.testing.assert_allclose(gj.orientation[vj][oj],
                               gt.orientation[vt][ot], atol=1e-5)
    np.testing.assert_allclose(gj.score[vj][oj], gt.score[vt][ot], atol=1e-3)


def whole_slice_on_rods(channels):
    """preprocess_cloud + detect of both packages on the rod scene at 15
    (the packaged weights) or 12 channels (gpd_tpu's random init, carried
    across): identical clouds, then the same selection on gpd_tpu's."""
    p, cs, vp = rod_scene(2)
    kw = dict(num_samples=64, image_neighbors_cap=256, num_selected=12)
    params = None if channels == 15 else p0_params(channels)
    jd = jdet.GraspDetector(JConfig(
        image_geometry=JImageGeometry(num_channels=channels), **kw),
        params=params)
    td = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels), **kw),
        params=params, device="cpu")
    jc = jd.preprocess_cloud(p, view_points=vp, cam_source=cs)
    tc = td.preprocess_cloud(p, view_points=vp, cam_source=cs)
    np.testing.assert_array_equal(np.asarray(jc.points), tc.points.numpy())
    np.testing.assert_array_equal(np.asarray(jc.mask), tc.mask.numpy())
    assert (tc.normals.norm(dim=1)[tc.mask] > 0.99).all()
    tc = port_cloud(jc)
    assert td.effective_config(tc).image_neighbors_cap == 256 < tc.capacity

    key = jax.random.PRNGKey(11)
    spos, smask = sample_where_frames_defined(jd, jc, 64)
    gj = jax_detect(jd, jc, spos, smask, key)
    with inject(key):
        gt = td.detect(tc, T(spos), T(smask), verbose=False).to_host()
    assert td.last_counts["candidates"] >= 64    # clustering sees no -inf row
    assert_same_selection(gj, gt)


def test_whole_slice_selects_the_same_grasps():
    whole_slice_on_rods(15)


def test_whole_slice_selects_the_same_grasps_at_12_channels():
    """The shadow-free raster_blocks route: gpd_tpu's test_12_channel_path
    on the repo's own scene."""
    whole_slice_on_rods(12)


def lattice_shell():
    """A skewed elliptic tube of dyadic lattice points (1/512 m spacing),
    symmetric about the origin only through it: the centroid is exactly 0
    and every moment sum is exact in float32, so both packages estimate
    the same normals; no mirror symmetry makes hands tie. Two cameras."""
    g = np.arange(-16, 17)
    x, y, z = np.meshgrid(g, g, np.arange(-15, 16), indexing="ij")
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    q = pts[:, 0] ** 2 + pts[:, 0] * pts[:, 1] + 2 * pts[:, 1] ** 2
    pts = (pts[(q > 60) & (q <= 80)] / 512.0).astype(np.float32)
    vp = np.array([[0.3, 0.2, 0.1], [-0.2, -0.3, 0.25]], np.float32)
    cam = np.stack([pts[:, 0] > -0.01, pts[:, 0] < 0.01]).astype(np.int32)
    return pts, cam, vp


def test_whole_slice_on_own_preprocessed_clouds():
    """Each package detects on the cloud its own preprocess_cloud made
    (identity image neighborhoods: the cloud is under the cap)."""
    p, cs, vp = lattice_shell()
    kw = dict(num_samples=32, voxelize=False, normals_radius=0.008,
              num_selected=12)
    jd = jdet.GraspDetector(JConfig(**kw))
    td = tdet.GraspDetector(DetectorConfig(**kw), device="cpu")
    jc = jd.preprocess_cloud(p, view_points=vp, cam_source=cs)
    tc = td.preprocess_cloud(p, view_points=vp, cam_source=cs)
    np.testing.assert_array_equal(np.asarray(jc.points), tc.points.numpy())
    np.testing.assert_array_equal(np.asarray(jc.mask), tc.mask.numpy())
    np.testing.assert_allclose(np.asarray(jc.normals), tc.normals.numpy(),
                               atol=1e-5)
    assert td.effective_config(tc).image_neighbors_cap == tc.capacity

    key = jax.random.PRNGKey(3)
    spos, smask = sample_where_frames_defined(jd, jc, 32)
    gj = jax_detect(jd, jc, spos, smask, key)
    with inject(key):
        gt = td.detect(tc, T(spos), T(smask), verbose=False).to_host()
    assert td.last_counts["candidates"] >= 64    # clustering sees no -inf row
    assert_same_selection(gj, gt)


def test_detect_stage_times():
    """The staged route times each stage; the stages sum to at most the
    request."""
    p, cs, vp = lattice_shell()
    td = tdet.GraspDetector(DetectorConfig(num_samples=16, voxelize=False,
                                           normals_radius=0.008),
                            device="cpu")
    cloud = td.preprocess_cloud(p, view_points=vp, cam_source=cs)
    td.detect(cloud, verbose=False)
    assert set(td.last_runtimes) == {"detect", "select", "total"}
    td.detect(cloud, verbose=False, staged=True)
    rt = td.last_runtimes
    stages = ("candidates", "images", "classify")
    assert set(rt) == {"total", *stages}
    assert all(rt[s] > 0 for s in stages)
    assert sum(rt[s] for s in stages) <= rt["total"] * 1.001


def cluster_batch(n_valid, G=64, seed=0):
    """Hands as select_top_k hands them to clustering: the first n_valid
    valid and score-descending, the rest invalid with score -inf. Two
    groups of nearly aligned hands along their axes, the rest scattered."""
    rng = np.random.default_rng(seed)
    axis = np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.05, (G, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    pos = rng.uniform(-0.2, 0.2, (G, 3))
    pos[:G // 4] = [0.01, 0.02, 0.0] + axis[:G // 4] * rng.uniform(
        -0.02, 0.02, (G // 4, 1)) + rng.normal(0, 0.001, (G // 4, 3))
    pos[G // 4:G // 2] = [-0.05, 0.0, 0.1] + rng.normal(0, 0.002,
                                                        (G // 4, 3))
    rng.shuffle(pos)
    orientation = np.zeros((G, 3, 3))
    orientation[:, :, 2] = axis
    valid = np.arange(G) < n_valid
    score = np.where(valid, np.sort(rng.uniform(-5, 15, G))[::-1], -np.inf)
    f32 = np.float32
    zeros = np.zeros(G, f32)
    return dict(position=pos.astype(f32), orientation=orientation.astype(f32),
                sample=np.zeros((G, 3), f32), width=zeros,
                score=score.astype(f32), bottom=zeros, top=zeros,
                center=zeros, finger_placement=np.zeros(G, np.int32),
                full_antipodal=np.zeros(G, bool),
                half_antipodal=np.zeros(G, bool), valid=valid,
                sample_id=np.arange(G, dtype=np.int32))


def cluster_numpy(pos, axis, score, valid, min_inliers):
    """clustering.cpp's non-greedy clustering, hand by hand over its
    partners only, in float64."""
    pos, axis, score = (np.asarray(a, np.float64) for a in (pos, axis, score))
    out_pos, out_score, ok = pos.copy(), score.copy(), np.zeros(len(pos), bool)
    cos12 = np.cos(np.deg2rad(12.0))
    for i in np.nonzero(valid)[0]:
        d = pos[i] - pos
        proj = d - axis[i] * (d @ axis[i])[:, None]
        pair = (valid & (np.abs(axis @ axis[i]) > cos12)
                & (np.linalg.norm(d, axis=1) <= 0.05)
                & (np.linalg.norm(proj, axis=1) <= 0.005))
        pair[i] = False
        n = pair.sum()
        if n < max(min_inliers, 1):
            continue
        ok[i] = True
        out_pos[i] = pos[pair].mean(0)
        out_score[i] = score[pair].mean() - 2.576 * score[pair].std() / \
            np.sqrt(n)
    return out_pos, out_score, ok


@pytest.mark.parametrize("n_valid", [10, 64])
def test_cluster_scores_over_pairs_only(n_valid):
    """Fewer valid hands than the batch (the -inf rows gpd_tpu's
    cluster_grasps turns into NaN scores, ROADMAP.md C) and a full batch:
    the port against a NumPy evaluation over the pairs only, and against
    gpd_tpu where the batch is full."""
    from gpd_tpu.core.types import Grasps as JGrasps
    import gpd_tpu.select as jsel
    from gpd_tpu_torch import select as tsel
    b = cluster_batch(n_valid)
    gt = tsel.cluster_grasps(port_grasps(JGrasps(**b)), 1)
    pos, score, ok = cluster_numpy(b["position"], b["orientation"][:, :, 2],
                                   b["score"], b["valid"], 1)
    assert 2 <= ok.sum() < n_valid
    np.testing.assert_array_equal(gt.valid.numpy(), ok)
    np.testing.assert_allclose(gt.position.numpy()[ok], pos[ok], atol=1e-5)
    np.testing.assert_allclose(gt.score.numpy()[ok], score[ok], atol=1e-5)
    if n_valid == len(ok):
        gj = jsel.cluster_grasps(JGrasps(**{k: jnp.asarray(v)
                                            for k, v in b.items()}), 1)
        np.testing.assert_array_equal(np.asarray(gj.valid), ok)
        np.testing.assert_allclose(np.asarray(gj.position),
                                   gt.position.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(gj.score), gt.score.numpy(),
                                   atol=1e-5)


def test_active_sample_blocked_descriptor_inputs():
    """More samples than one block (_SAMPLE_BLOCK = 512): active samples
    first, inactive blocks skipped, shadow draws taken by original sample
    id. Identical neighborhoods, shadow sets and sample map."""
    assert tdet._SAMPLE_BLOCK == jdet._SAMPLE_BLOCK == 512
    p, cs, vp = rod_scene(4)
    kw = dict(num_samples=600, image_neighbors_cap=256)
    jd = jdet.GraspDetector(JConfig(**kw), params={})
    jc = jd.preprocess_cloud(p, view_points=vp, cam_source=cs)
    cfg_j = jd.effective_config(jc)
    cfg_t = dataclasses.replace(DetectorConfig(**kw), **{
        k: getattr(cfg_j, k) for k in ("search_neighbors_cap",
                                       "image_neighbors_cap")})
    key = jax.random.PRNGKey(5)
    spos, smask = jd.sample_cloud(jc, key)
    g = jdet.candidates_stage(jc, spos, smask, cfg_j)
    active = np.asarray(g.valid).reshape(600, -1).any(1)
    assert 0 < active.sum() < 512 < 600
    out_j = jdet._descriptor_inputs(jc, g, spos, smask, key, cfg_j,
                                    canonical=True)
    noise = jax_noise(key, 600, 2, *tdet._shadow_shape(port_cloud(jc), cfg_t))
    tc = port_cloud(jc)
    out_t = tdet._descriptor_inputs(tc, tc.mask, port_grasps(g), T(spos),
                                    T(smask), noise, cfg_t)
    nn_j, nv_j, sp_j, sv_j, sid_j = map(np.asarray, out_j)
    nn_t, nv_t, sp_t, sv_t, sid_t = (a.numpy() for a in out_t)
    np.testing.assert_array_equal(sid_j, sid_t)
    np.testing.assert_array_equal(nv_j, nv_t)
    np.testing.assert_array_equal(nn_j[nv_j], nn_t[nv_t])
    np.testing.assert_array_equal(sv_j, sv_t)
    np.testing.assert_allclose(sp_j[sv_j], sp_t[sv_t], atol=1e-6)
    assert sv_t.any()


def test_imports_neither_jax_nor_gpd_tpu():
    """Every module of the port, io/ and apps/ included; and parsing an
    ascii PCD loads the port's own parser, never gpd_tpu's native/
    library."""
    code = ("import importlib, pkgutil, sys\n"
            "import gpd_tpu_torch\n"
            "for m in pkgutil.walk_packages(gpd_tpu_torch.__path__,\n"
            "                               'gpd_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "new = {'gpd_tpu_torch.' + m for m in ('cem', 'api', 'profiling',\n"
            "       'apps.detect_grasps', 'apps.cem_detect_grasps',\n"
            "       'apps.generate_candidates')}\n"
            "assert new <= set(sys.modules), new - set(sys.modules)\n"
            "from gpd_tpu_torch.io import pcd\n"
            "assert pcd.ascii_route() == 'native'\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'libpcd_ascii' in maps and 'libgpd_native' not in maps\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gpd_tpu')]; print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=share_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_module_imports_without_triton_or_nvcc():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['triton'] = None\n"
        "import gpd_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    gpd_tpu_torch.__path__, 'gpd_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert {'gpd_tpu_torch.io.pcd', 'gpd_tpu_torch.apps.detect_grasps',\n"
        "        'gpd_tpu_torch.ops.images'} <= set(names), names\n"
        "from gpd_tpu_torch.ops import _build\n"
        "try:\n"
        "    _build.nvcc()\n"
        "except RuntimeError:\n"
        "    print(len(names))\n"
        "else:\n"
        "    sys.exit('nvcc found')\n")
    env = share_env(dict(os.environ, PATH="/usr/bin:/bin",
                         CUDA_HOME="/nonexistent"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 24


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdet.GraspDetector(DetectorConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        CloudArrays.from_numpy(np.zeros((4, 3), np.float32))
    det = tdet.GraspDetector(DetectorConfig(), device="cpu")
    assert det.device.type == "cpu"
    assert next(det.net.parameters()).device.type == "cpu"


def p0_params(channels):
    """The packaged 3-channel checkpoint, or one random-init parameter dict
    (gpd_tpu's init_params) as numpy arrays for 1 or 12 channels, which
    have no packaged checkpoint."""
    if channels == 3:
        return None
    return {k: np.asarray(v) for k, v in
            jlenet.init_params(jax.random.PRNGKey(1), channels).items()}


@pytest.mark.parametrize("channels", [3, 1])
def test_whole_slice_at_p0_channels(channels):
    """1 and 3 channels (projection P0, the raster_sums route) on the rod
    scene, nearest-K image neighborhoods."""
    p, cs, vp = rod_scene(2)
    kw = dict(num_samples=64, image_neighbors_cap=256, num_selected=12)
    params = p0_params(channels)
    jd = jdet.GraspDetector(JConfig(
        image_geometry=JImageGeometry(num_channels=channels), **kw),
        params=params)
    td = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels), **kw),
        params=params, device="cpu")
    jc = jd.preprocess_cloud(p, view_points=vp, cam_source=cs)
    tc = port_cloud(jc)
    assert td.effective_config(tc).image_neighbors_cap == 256 < tc.capacity
    key = jax.random.PRNGKey(11)
    spos, smask = sample_where_frames_defined(jd, jc, 64)
    gj = jax_detect(jd, jc, spos, smask, key)
    gt = td.detect(tc, T(spos), T(smask), verbose=False).to_host()
    assert td.last_counts["candidates"] >= 64    # clustering sees no -inf row
    assert_same_selection(gj, gt)


def test_whole_slice_with_plane_removed_before_images():
    """remove_plane_before_image_calculation on the rod scene's table: the
    image mask drops gpd_tpu's RANSAC plane (its triplets injected)."""
    p, cs, vp = rod_scene(3)
    kw = dict(num_samples=48, image_neighbors_cap=256, num_selected=12,
              remove_plane_before_image_calculation=True)
    jd = jdet.GraspDetector(JConfig(
        image_geometry=JImageGeometry(num_channels=3), **kw))
    td = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=3), **kw), device="cpu")
    jc = jd.preprocess_cloud(p, view_points=vp, cam_source=cs)
    tc = port_cloud(jc)
    key = jax.random.PRNGKey(6)
    inl, _ = jpp.fit_plane_ransac(jc.points, jc.mask,
                                  jax.random.fold_in(key, 1))
    assert 1000 < int(np.asarray(inl).sum()) < int(np.asarray(jc.mask).sum())
    spos, smask = sample_where_frames_defined(jd, jc, 48)
    gj = jax_detect(jd, jc, spos, smask, key)
    with inject_triplets(jax.random.fold_in(key, 1)):
        gt = td.detect(tc, T(spos), T(smask), verbose=False).to_host()
    assert td.last_counts["candidates"] >= 64
    assert_same_selection(gj, gt)


def test_no_packaged_checkpoint_asks_for_params(capsys):
    """Without a checkpoint for the channel count (1 and 12 channels), the
    detector warns as gpd_tpu does and falls back to random init; params=
    still takes a given dict."""
    for channels in (1, 12):
        cfg = DetectorConfig(image_geometry=ImageGeometry(
            num_channels=channels))
        det = tdet.GraspDetector(cfg, device="cpu")
        assert det.net.conv1.in_channels == channels
        assert ("WARNING: could not load classifier weights (no weights_file "
                "configured); using random initialization.") in \
            capsys.readouterr().out
    det = tdet.GraspDetector(cfg, params=p0_params(1), device="cpu")
    assert det.net.conv1.in_channels == 1
    assert "WARNING" not in capsys.readouterr().out


def test_random_init_detector_runs_detect():
    """A 1-channel GraspDetector built with no params (random init) runs
    detect on a small scene and scores its hands with finite values."""
    p, cs, vp = lattice_shell()
    det = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=1), num_samples=16,
        voxelize=False, normals_radius=0.008), device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    out = det.detect(cloud, generator=torch.Generator().manual_seed(0),
                     verbose=False).to_host()
    assert det.last_counts["selected"] > 0
    assert np.all(np.isfinite(out.score[out.valid]))


def test_serve_capacity_matches_gpd_tpu():
    assert tdet._SERVE_BUCKETS == jdet._SERVE_BUCKETS
    sizes = [0, 1, 2047, 2048, 2049, 5000, 8192, 8193, 65536, 131071,
             131072, 131073, 150000, 300001]
    assert [tdet.serve_capacity(n) for n in sizes] == \
        [jdet.serve_capacity(n) for n in sizes]


@pytest.mark.parametrize("remove_outliers", [False, True])
def test_preprocess_serve_capacity_matches_gpd_tpu(remove_outliers):
    """capacity="serve" (and outlier removal with its second compaction):
    the same capacity, points and mask as gpd_tpu's."""
    p, cs, vp = rod_scene(5)
    kw = dict(remove_outliers=remove_outliers)
    jc = jdet.GraspDetector(JConfig(**kw), params={}).preprocess_cloud(
        p, view_points=vp, cam_source=cs, capacity="serve")
    tc = tdet.GraspDetector(DetectorConfig(**kw), device="cpu").preprocess_cloud(
        p, view_points=vp, cam_source=cs, capacity="serve")
    assert tc.capacity == jc.points.shape[0] == 4096
    np.testing.assert_array_equal(np.asarray(jc.mask), tc.mask.numpy())
    np.testing.assert_array_equal(np.asarray(jc.points), tc.points.numpy())
    n = int(tc.mask.sum())                # 2857 voxels, 2369 kept
    assert n > 2048 and (n < 2500) == remove_outliers


def scattered_cloud(seed, n=700):
    """A table patch with two boxes and a sparse halo of stray points, as
    a CloudArrays of both packages (capacity 1024)."""
    rng = np.random.default_rng(seed)
    table = np.c_[rng.uniform(-0.15, 0.15, (n, 2)), np.zeros(n)]
    boxes = [rng.uniform([x, y, 0.0], [x + 0.04, y + 0.05, 0.08], (80, 3))
             for x, y in ((-0.1, -0.05), (0.04, 0.02))]
    halo = rng.uniform(-0.3, 0.3, (40, 3))
    pts = np.concatenate([table, *boxes, halo]).astype(np.float32)
    jc = JCloud.from_numpy(pts, capacity=1024)
    return jc, port_cloud(jc)


@pytest.mark.parametrize("seed", [0, 1])
def test_outlier_mask_matches_gpd_tpu(seed):
    jc, tc = scattered_cloud(seed)
    keep_j = np.asarray(jpp.remove_statistical_outliers(jc).mask)
    keep_t = tpp.remove_statistical_outliers(tc).mask.numpy()
    np.testing.assert_array_equal(keep_j, keep_t)
    assert 0 < (tc.mask.numpy() & ~keep_t).sum() < 100


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_plane_matches_gpd_tpu(seed):
    jc, tc = scattered_cloud(seed)
    key = jax.random.PRNGKey(seed)
    inl_j, plane_j = jpp.fit_plane_ransac(jc.points, jc.mask, key)
    with inject_triplets(key):
        inl_t, plane_t = tpp.fit_plane_ransac(tc.points, tc.mask, None)
    np.testing.assert_array_equal(np.asarray(inl_j), inl_t.numpy())
    plane_j = np.asarray(plane_j)
    sign = np.sign(plane_j[2] * plane_t[2].item())
    np.testing.assert_allclose(plane_j, sign * plane_t.numpy(), atol=1e-6)
    assert inl_t.sum() >= 650 and abs(plane_t[2]) > 0.99


def test_sample_above_plane_matches_gpd_tpu():
    jc, tc = scattered_cloud(2)
    key = jax.random.PRNGKey(4)
    above_j = np.asarray(jpp.sample_above_plane(jc, key))
    with inject_triplets(key):
        above_t = tpp.sample_above_plane(tc, None).numpy()
    np.testing.assert_array_equal(above_j, above_t)
    assert 150 < above_t.sum() < 300
    # Nothing off the plane: the whole cloud, as the reference falls back.
    flat = np.c_[np.random.default_rng(0).uniform(-0.1, 0.1, (300, 2)),
                 np.zeros(300)].astype(np.float32)
    jf = JCloud.from_numpy(flat)
    with inject_triplets(key):
        above_t = tpp.sample_above_plane(port_cloud(jf), None).numpy()
    np.testing.assert_array_equal(np.asarray(jpp.sample_above_plane(jf, key)),
                                  above_t)
    np.testing.assert_array_equal(above_t, np.asarray(jf.mask))


def test_sample_cloud_draws_above_the_plane():
    """sample_above_plane through GraspDetector.sample_cloud: every valid
    sample lies off the table."""
    jc, tc = scattered_cloud(3)
    det = tdet.GraspDetector(DetectorConfig(num_samples=64,
                                            sample_above_plane=True),
                             device="cpu")
    pos, valid = det.sample_cloud(tc, torch.Generator().manual_seed(0))
    assert valid.all() and (pos[:, 2].abs() > 0.005).float().mean() > 0.95


def test_staged_route_matches_gpd_tpu_and_detect(capsys):
    """detect(staged=True, staged_cap=256) over several live chunks against
    gpd_tpu's staged route (its draws injected) and against the port's own
    detect on the same generator seed; its report and last_runtimes."""
    p, cs, vp = rods_only(6)
    kw = dict(num_samples=96, image_neighbors_cap=256, num_selected=12,
              **ROD_KW)
    jd = jdet.GraspDetector(JConfig(**kw))
    td = tdet.GraspDetector(DetectorConfig(**kw), device="cpu")
    jc = jd.preprocess_cloud(p, view_points=vp, cam_source=cs)
    tc = port_cloud(jc)
    key = jax.random.PRNGKey(8)
    spos, smask = sample_where_frames_defined(jd, jc, 96)
    jax.clear_caches()
    try:
        with mock.patch.object(jimg, "_use_pallas", lambda: True), \
                mock.patch.object(jimg.pl, "pallas_call",
                                  _interpret(jimg.pl.pallas_call)):
            gj = jd.detect(jc, jnp.asarray(spos), jnp.asarray(smask), key=key,
                           verbose=False, staged=True,
                           staged_cap=256).to_host()
    finally:
        jax.clear_caches()
    capsys.readouterr()
    with inject(key):
        gt = td.detect(tc, T(spos), T(smask), verbose=True, staged=True,
                       staged_cap=256).to_host()
    assert td.last_counts["candidates"] > 256      # 2 or more live chunks
    assert_same_selection(gj, gt)
    assert set(td.last_runtimes) == {"candidates", "images", "classify",
                                     "total"}
    assert all(v > 0 for v in td.last_runtimes.values())
    report = capsys.readouterr().out.splitlines()
    assert report[0] == f"Selected the {int(gt.valid.sum())} best grasps."
    assert [r.split(":")[0] for r in report[1:]] == [
        "======== RUNTIMES ========", " 1. Candidate generation",
        " 2. Descriptors/images", " 3. Classification", "==========",
        " TOTAL"]

    # The port's detect on the same draws: the same candidates and grasps.
    n_staged = td.last_counts["candidates"]
    with inject(key):
        gd = td.detect(tc, T(spos), T(smask), verbose=False).to_host()
    assert td.last_counts["candidates"] == n_staged
    for name in ("position", "score", "valid"):
        np.testing.assert_array_equal(getattr(gd, name), getattr(gt, name))



def test_staged_route_traces_itself(tmp_path, monkeypatch):
    """With GPD_TPU_PROFILE set, detect(staged=True) writes its own trace,
    which holds the detect_core and select_and_cluster spans."""
    p, cs, vp = lattice_shell()
    det = tdet.GraspDetector(DetectorConfig(num_samples=8, voxelize=False,
                                            normals_radius=0.008),
                             device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    monkeypatch.setenv("GPD_TPU_PROFILE", str(tmp_path))
    det.detect(cloud, verbose=False, staged=True)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"detect_core", "select_and_cluster"} <= names


def test_stage_timer_marks():
    """StageTimer.mark adds the time since the previous mark to its stage,
    so a stage marked twice sums both; with on=False it records nothing."""
    timer = profiling.StageTimer(torch.device("cpu"))
    timer.mark("a")
    timer.mark("b")
    timer.mark("a")
    assert list(timer.stages) == ["a", "b"]
    assert sum(timer.stages.values()) <= timer.total()
    off = profiling.StageTimer(torch.device("cpu"), on=False)
    off.mark("a")
    with off.stage("b"):
        pass
    assert off.stages == {}


def image_gate(a, b):
    """The repo's image gate: under 0.5% of pixels more than one step
    apart."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert (diff > 1).mean() < 5e-3, (diff > 1).mean()


@pytest.mark.parametrize("channels", [15, 12, 3, 1])
def test_score_candidates_keeps_images(channels):
    """score_candidates(scores_only=False) against gpd_tpu's: the same
    valid-first order and scores, images within the gate, zeros past the
    live chunks; scores_only=True gives the same grasps and no images. 12
    and 1 channels have no packaged weights: gpd_tpu's random init."""
    p, cs, vp = rods_only(7)
    kw = dict(num_samples=48, image_neighbors_cap=256, **ROD_KW)
    params = None if channels in (15, 3) else p0_params(channels)
    jd = jdet.GraspDetector(JConfig(
        image_geometry=JImageGeometry(num_channels=channels), **kw),
        params=params)
    td = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels), **kw),
        params=params, device="cpu")
    jc = jd.preprocess_cloud(p, view_points=vp, cam_source=cs)
    tc = port_cloud(jc)
    cfg_j = jd.effective_config(jc)
    cfg_t = td.effective_config(tc)
    key = jax.random.PRNGKey(9)
    spos, smask = sample_where_frames_defined(jd, jc, 48)
    g = jdet.candidates_stage(jc, jnp.asarray(spos), jnp.asarray(smask),
                              cfg_j)
    cap = 128
    assert 0 < int(np.asarray(g.valid).sum()) <= 2 * cap < g.valid.shape[0]
    jax.clear_caches()
    try:
        with mock.patch.object(jimg, "_use_pallas", lambda: True), \
                mock.patch.object(jimg.pl, "pallas_call",
                                  _interpret(jimg.pl.pallas_call)):
            sj, ij = jdet.score_candidates(
                jc, g, jnp.asarray(spos), jnp.asarray(smask), jd.params, key,
                cfg_j, cap, scores_only=False, canonical=True)
            sj, ij = sj.to_host(), np.asarray(ij)
    finally:
        jax.clear_caches()
    gt = port_grasps(g)
    with inject(key):
        st, it = tdet.score_candidates(tc, gt, T(spos), T(smask), td.net,
                                       None, cfg_t, cap, scores_only=False)
    st, it = st.to_host(), it.numpy()
    np.testing.assert_array_equal(sj.valid, st.valid)
    np.testing.assert_array_equal(sj.sample_id, st.sample_id)
    np.testing.assert_allclose(sj.score[sj.valid], st.score[st.valid],
                               atol=1e-3)
    image_gate(ij, it)
    n_live = -(-int(st.valid.sum()) // cap)
    assert it[:n_live * cap].any() and not it[n_live * cap:].any()
    with inject(key):
        s2, none = tdet.score_candidates(tc, gt, T(spos), T(smask), td.net,
                                         None, cfg_t, cap)
    assert none is None
    np.testing.assert_array_equal(s2.score.numpy(), st.score)
    # descriptors_stage: the first valid hands' images, once more.
    noise = jax_noise(key, 48, 2, *tdet._shadow_shape(tc, cfg_t))
    inputs = tdet.image_inputs_stage(tc, tc.mask, T(spos), T(smask),
                                     noise if channels == 15 else None, cfg_t)
    gc, ic = tdet.descriptors_stage(tc, gt, *inputs, cfg_t, cap)
    np.testing.assert_array_equal(gc.sample_id.numpy(), st.sample_id[:cap])
    np.testing.assert_array_equal(ic.numpy(), it[:cap])


def test_profiling_traces_detect(tmp_path, monkeypatch):
    """maybe_trace is a no-op without a directory; with one it writes a
    Chrome trace that holds detect's spans, and GPD_TPU_PROFILE makes
    detect trace itself. StageTimer reports in the reference's format."""
    p, cs, vp = lattice_shell()
    det = tdet.GraspDetector(DetectorConfig(num_samples=8, voxelize=False,
                                            normals_radius=0.008),
                             device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    monkeypatch.delenv("GPD_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace() as prof:
        det.detect(cloud, verbose=False)
    assert prof is None and not os.listdir(tmp_path)

    def names(d):
        files = os.listdir(d)
        assert len(files) == 1 and files[0].endswith(".json")
        with open(os.path.join(d, files[0])) as f:
            return {e.get("name") for e in json.load(f)["traceEvents"]}
    with profiling.maybe_trace(str(tmp_path / "a")) as prof:
        det.detect(cloud, verbose=False)
    assert prof is not None
    assert {"detect_core", "select_and_cluster"} <= names(tmp_path / "a")
    monkeypatch.setenv("GPD_TPU_PROFILE", str(tmp_path / "b"))
    det.detect(cloud, verbose=False)
    assert "detect_core" in names(tmp_path / "b")

    timer = profiling.StageTimer()
    with timer.stage("candidates"):
        pass
    with timer.stage("candidates"):
        pass
    lines = timer.report().splitlines()
    assert lines[0] == "======== RUNTIMES ========"
    assert lines[1].startswith(" 1. candidates: ") and lines[2] == "=========="
    assert lines[3].startswith(" TOTAL: ") and len(lines) == 4
