"""gpd_tpu_torch's candidate stage (frames -> hand search -> filters)
against gpd_tpu.detector.candidates_stage on the CPU.

Both packages get gpd_tpu's preprocessed cloud and the same samples, taken
where gpd_tpu's own local frame is defined (the curvature axis of a flat
patch moves with the last bits of its moment sums; ROADMAP.md C). Masks
must agree exactly (XOR 0 on valid / full_antipodal / half_antipodal) and
poses, widths and closing-box coordinates within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpd_tpu.detector as jdet
import gpd_tpu.ops.candidates as jcand
from gpd_tpu.config import DetectorConfig as JConfig
from gpd_tpu.core.types import CloudArrays as JCloud
from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.config import DetectorConfig
from gpd_tpu_torch.core.types import CloudArrays, Grasps
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.ops import candidates as cand
from test_torch_threads import set_cpu_share

set_cpu_share()

MASKS = ("valid", "full_antipodal", "half_antipodal")
VALUES = ("position", "orientation", "width", "bottom", "top", "center")


def T(a):
    return torch.from_numpy(np.array(a))


def port_cloud(jc):
    """gpd_tpu's cloud arrays as the port's CloudArrays (on the CPU)."""
    return CloudArrays(points=T(jc.points), normals=T(jc.normals),
                       cam_source=T(jc.cam_source).to(torch.int64),
                       mask=T(jc.mask), view_points=T(jc.view_points))


def port_grasps(g):
    """gpd_tpu's Grasps as the port's (on the CPU)."""
    return Grasps(**{f.name: T(getattr(g, f.name)).to(
        torch.int64 if f.name in ("sample_id", "finger_placement") else None)
        for f in dataclasses.fields(Grasps)})


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


def prepared(points, view_points, cam_source, num_samples, seed):
    """gpd_tpu's preprocessed cloud and up to num_samples sample positions
    at well-conditioned frames."""
    cfg = JConfig(num_samples=num_samples)
    det = jdet.GraspDetector(cfg, params={})
    jc = det.preprocess_cloud(points, view_points=view_points,
                              cam_source=cam_source)
    pts = np.asarray(jc.points)[np.asarray(jc.mask)]
    cand_pos = pts[np.random.default_rng(seed).permutation(len(pts))]
    ok = frame_gap_ok(jc, cand_pos, cfg.nn_radius_frames)
    return jc, cand_pos[ok][:num_samples]


def compare(jc, spos, cfg_kw=None):
    kw = dict(num_samples=len(spos), **(cfg_kw or {}))
    jcfg, tcfg = JConfig(**kw), DetectorConfig(**kw)
    det = jdet.GraspDetector(jcfg, params={})
    jcfg = det.effective_config(jc)
    tcfg = tdet.GraspDetector(tcfg, device="cpu").effective_config(
        port_cloud(jc))
    smask = np.ones(len(spos), bool)
    gj = jdet.candidates_stage(jc, jnp.asarray(spos), jnp.asarray(smask), jcfg)
    gt = tdet.candidates_stage(port_cloud(jc), T(spos), T(smask), tcfg)
    for f in MASKS:
        xor = np.asarray(getattr(gj, f)) ^ getattr(gt, f).numpy()
        assert xor.sum() == 0, (f, int(xor.sum()))
    v = gt.valid.numpy()
    assert v.sum() > 0
    for f in VALUES:
        np.testing.assert_allclose(np.asarray(getattr(gj, f))[v],
                                   getattr(gt, f).numpy()[v], atol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(np.asarray(gj.sample_id),
                                  gt.sample_id.numpy())
    return gt


CAMS = np.array([[0.5, 0.1, 0.2], [-0.3, 0.45, 0.1]], np.float32)


def thin_cylinder(seed):
    """A capped 15 mm cylinder: curved enough that its side has defined
    frames (seen from the two CAMS), narrow enough to grasp."""
    rng = np.random.default_rng(seed)
    pts, nrm = syn.sample_cylinder(rng, 0.015, 0.1, 3000)
    return rng, pts, nrm


def test_single_object():
    rng, pts, nrm = thin_cylinder(21)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, CAMS)
    jc, spos = prepared(p, vp, cs, 48, 0)
    gt = compare(jc, spos)
    assert gt.half_antipodal.sum() > 0


def test_two_camera_table_scene():
    rng = np.random.default_rng(5)
    pts, nrm = syn.make_scene(rng, n_objects=2, points_per_object=1500,
                              table_points=1500, table_halfsize=0.15)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))
    assert vp.shape[0] == 2
    jc, spos = prepared(p, vp, cs, 64, 1)
    gt = compare(jc, spos)
    assert gt.half_antipodal.sum() > 0


@pytest.mark.parametrize("block_elems,search_cap", [(1 << 18, 0), (1 << 16, 512)])
def test_blocked_search(monkeypatch, block_elems, search_cap):
    """Sample blocks (identity and nearest-K neighborhoods), with samples of
    invalid frames ordered last and skipped, give gpd_tpu's single-block
    result."""
    rng, pts, nrm = thin_cylinder(8)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, CAMS)
    jc, spos = prepared(p, vp, cs, 40, 3)
    # Samples far from the cloud have no frame (invalid, skipped blocks).
    spos = np.concatenate([spos, np.full((9, 3), 0.9, np.float32)])[
        np.random.default_rng(0).permutation(len(spos) + 9)]
    monkeypatch.setattr(cand, "_BLOCK_ELEMS", block_elems)
    kw = {"search_neighbors_cap": search_cap, "search_identity_max": 0} \
        if search_cap else None
    compare(jc, spos, kw)


def test_search_hands_matches_gpd_tpu():
    """search_hands (frames, then the search, no filters) against
    gpd_tpu's: masks exactly, values within 1e-5, the HandSet layout."""
    rng, pts, nrm = thin_cylinder(13)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, CAMS)
    jc, spos = prepared(p, vp, cs, 32, 2)
    kw = dict(num_samples=32, search_neighbors_cap=jc.points.shape[0])
    cfg = JConfig(**kw)
    smask = np.ones(len(spos), bool)
    gj = jcand.search_hands(jc, jnp.asarray(spos), jnp.asarray(smask), cfg)
    gt = cand.search_hands(port_cloud(jc), T(spos), T(smask),
                           DetectorConfig(**kw))
    assert gt.capacity == 32 * 8
    for f in MASKS:
        np.testing.assert_array_equal(np.asarray(getattr(gj, f)),
                                      getattr(gt, f).numpy(), err_msg=f)
    v = gt.valid.numpy()
    assert v.sum() > 0
    for f in VALUES:
        np.testing.assert_allclose(np.asarray(getattr(gj, f))[v],
                                   getattr(gt, f).numpy()[v], atol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(gt.sample_id.numpy(),
                                  np.repeat(np.arange(32), 8))


@pytest.mark.parametrize("num_samples,cap", [(32, 0), (80, 1024), (80, 0)])
def test_reevaluate_hypotheses_matches_gpd_tpu(num_samples, cap):
    """Ground-truth relabeling of gpd_tpu's candidates from two views of a
    cylinder against the whole cylinder (exact normals): both antipodal
    flags and the labels equal exactly. 32 samples (256 hands, one block)
    and 80 samples (640 hands, the blocked route with a padded last block),
    with neighbourhoods of the whole mesh (cap 0: the mesh's capacity) and
    of its nearest 1024 points."""
    rng, pts, nrm = thin_cylinder(17)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, CAMS)
    jc, spos = prepared(p, vp, cs, num_samples, 4)
    mesh = JCloud.from_numpy(pts, normals=nrm)
    kw = dict(num_samples=num_samples,
              search_neighbors_cap=cap or mesh.points.shape[0])
    g = jcand.search_hands(jc, jnp.asarray(spos),
                           jnp.ones(num_samples, bool), JConfig(**kw))
    jl, jg = jcand.reevaluate_hypotheses(mesh, g, JConfig(**kw))
    tl, tg = cand.reevaluate_hypotheses(port_cloud(mesh),
                                        port_grasps(g), DetectorConfig(**kw))
    assert tg.capacity == num_samples * 8 and tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for f in ("full_antipodal", "half_antipodal"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(tg.position.numpy(), np.asarray(g.position))
    assert 0 < int(tl.sum()) < int(np.asarray(g.valid).sum())


def greedy_numpy(pos, axis, score, valid, min_inliers):
    """clustering.cpp's greedy clustering (remove_inliers=true) in float64:
    hands in order, each taking the partners no accepted cluster took."""
    pos, axis, score = (np.asarray(a, np.float64) for a in (pos, axis, score))
    out_pos, out_score = pos.copy(), score.copy()
    ok = np.zeros(len(pos), bool)
    used = np.zeros(len(pos), bool)
    cos12 = np.cos(np.deg2rad(12.0))
    for i in range(len(pos)):
        d = pos[i] - pos
        proj = d - axis[i] * (d @ axis[i])[:, None]
        inl = (valid & valid[i] & (np.abs(axis @ axis[i]) > cos12)
               & (np.linalg.norm(d, axis=1) <= 0.05)
               & (np.linalg.norm(proj, axis=1) <= 0.005) & ~used)
        inl[i] = False
        n = inl.sum()
        if not valid[i] or n < min_inliers:
            continue
        ok[i], used = True, used | inl
        out_pos[i] = pos[inl].mean(0) if n else pos[i]
        out_score[i] = (score[inl].mean() - 2.576 * score[inl].std() /
                        np.sqrt(n)) if n else 0.0
    return out_pos, out_score, ok


@pytest.mark.parametrize("n_valid,min_inliers", [(64, 1), (64, 3), (20, 1)])
def test_greedy_clustering(n_valid, min_inliers):
    """cluster_grasps(remove_inliers=True) against a float64 evaluation of
    the greedy pass, and against gpd_tpu's where gpd_tpu is finite (a full
    batch: with invalid rows at -inf gpd_tpu's sums give NaN)."""
    from gpd_tpu.core.types import Grasps as JGrasps
    import gpd_tpu.select as jsel
    from gpd_tpu_torch import select as tsel
    from test_torch_detector import cluster_batch, port_grasps as grasps_of
    b = cluster_batch(n_valid, seed=3)
    gt = tsel.cluster_grasps(grasps_of(JGrasps(**b)), min_inliers,
                             remove_inliers=True)
    pos, score, ok = greedy_numpy(b["position"], b["orientation"][:, :, 2],
                                  b["score"], b["valid"], min_inliers)
    assert 2 <= ok.sum() < n_valid
    np.testing.assert_array_equal(gt.valid.numpy(), ok)
    np.testing.assert_allclose(gt.position.numpy()[ok], pos[ok], atol=1e-5)
    np.testing.assert_allclose(gt.score.numpy()[ok], score[ok], atol=1e-5)
    plain = tsel.cluster_grasps(grasps_of(JGrasps(**b)), min_inliers)
    assert plain.valid.sum() > gt.valid.sum()
    if n_valid == len(ok):
        gj = jsel.cluster_grasps(JGrasps(**{k: jnp.asarray(v)
                                            for k, v in b.items()}),
                                 min_inliers, remove_inliers=True)
        np.testing.assert_array_equal(np.asarray(gj.valid), ok)
        np.testing.assert_allclose(np.asarray(gj.position),
                                   gt.position.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(gj.score), gt.score.numpy(),
                                   atol=1e-5)
