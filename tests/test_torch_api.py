"""gpd_tpu_torch.api against gpd_tpu.api on the CPU.

Both packages preprocess the dyadic lattice tube of test_torch_detector to
the same cloud (its moment sums are exact in float32), the port with
gpd_tpu's draws injected (the subsample of ``sample_cloud`` and the shadow
draws of ``seed``'s key) and gpd_tpu on its bfloat16 image route with the
Pallas rasters in interpret mode. Every drawn sample has a well-conditioned
local frame (asserted). Grasp lists must be the same set (positions 1e-5,
scores 1e-3), descriptor images within the repo's gate.

Hand poses agree to ~1e-6 there, not exactly, and a hand point on an image
cell's edge lands in either neighboring cell by the sign of its rounding:
on the serving path 3-16% of the tube's 256 hands (seeds 2, 3, 5) get
images more than one step apart somewhere, and scores up to 0.74 apart.
``test_scores_diverge_only_with_images`` holds that the scores diverge only
through those images. The descriptor test holds every other hand's score to
1e-3; the selection tests use seed 2, whose selection holds no such hand
(seeds 3 and 5 of detect_grasps_in_cloud do).
"""

import dataclasses
import os
import shutil
import unittest.mock as mock
import weakref

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpd_tpu.api as japi
import gpd_tpu.detector as jdet
import gpd_tpu.ops.images as jimg
import gpd_tpu.ops.preprocess as jpp
from gpd_tpu.config import DetectorConfig as JConfig
from gpd_tpu_torch import api
from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.config import DetectorConfig
from gpd_tpu_torch.detector import GraspDetector
from gpd_tpu_torch.net import lenet
from gpd_tpu_torch.ops import draws
from test_torch_detector import (T, _interpret, frame_gap_ok, inject,
                                 lattice_shell, port_cloud)
from test_torch_io import ascii_pcd
from test_torch_threads import set_cpu_share

set_cpu_share()

KW = dict(num_samples=32, voxelize=False, normals_radius=0.008,
          nn_radius_frames=0.015, num_selected=12)


def run_gpd_tpu(fn):
    """gpd_tpu's call on its bfloat16 image route, Pallas in interpret
    mode."""
    jax.clear_caches()
    try:
        with mock.patch.object(jimg, "_use_pallas", lambda: True), \
                mock.patch.object(jimg.pl, "pallas_call",
                                  _interpret(jimg.pl.pallas_call)):
            return fn()
    finally:
        jax.clear_caches()


def inject_draws(jc, cfg, seed):
    """The port's draws patched with gpd_tpu's for ``seed``: the subsample
    of sample_cloud (key folded with 4) and the shadow draws; asserts that
    every drawn sample has a well-conditioned frame."""
    key = jax.random.PRNGKey(seed)
    idx = np.array(jpp.subsample_uniform(jax.random.fold_in(key, 4), jc.mask,
                                         cfg.num_samples)[0])
    assert frame_gap_ok(jc, np.asarray(jc.points)[idx],
                        cfg.nn_radius_frames).all()
    sub = mock.patch.object(draws, "subsample", lambda g, pool, n:
                            torch.from_numpy(idx).long())
    return sub, inject(key)


def same_grasps(theirs, ours, ordered=False):
    """Two grasp-dict lists: the same set (the same order with
    ``ordered``), positions and orientations within 1e-5, scores 1e-3."""
    assert len(theirs) == len(ours) > 0

    def arrays(gs):
        return (np.array([g["position"] for g in gs]),
                np.array([g["orientation"] for g in gs]),
                np.array([g["score"] for g in gs]))
    pj, rj, sj = arrays(theirs)
    pt, rt, st = arrays(ours)
    oj = np.arange(len(pj)) if ordered else np.lexsort(pj.T)
    ot = np.arange(len(pt)) if ordered else np.lexsort(pt.T)
    np.testing.assert_allclose(pj[oj], pt[ot], atol=1e-5)
    np.testing.assert_allclose(rj[oj], rt[ot], atol=1e-5)
    np.testing.assert_allclose(sj[oj], st[ot], atol=1e-3)
    assert np.isfinite(st).all()
    assert set(ours[0]) == set(theirs[0])


def test_detect_grasps_in_cloud():
    pts, cam, vp = lattice_shell()
    jd = jdet.GraspDetector(JConfig(**KW))
    td = GraspDetector(DetectorConfig(**KW), device="cpu")
    theirs = run_gpd_tpu(lambda: japi.detect_grasps_in_cloud(
        jd, pts, view_points=vp, cam_source=cam, seed=2))
    jc = jd.preprocess_cloud(pts, view_points=vp, cam_source=cam,
                             capacity="serve")
    sub, noise = inject_draws(jc, jd.cfg, 2)
    with sub, noise:
        ours = api.detect_grasps_in_cloud(td, pts, view_points=vp,
                                          cam_source=cam, seed=2)
    same_grasps(theirs, ours)


def test_detect_grasps_in_file(tmp_path):
    pts, _, vp = lattice_shell()
    path = str(tmp_path / "tube.pcd")
    ascii_pcd(path, pts, repr)
    kw = dict(KW, camera_position=tuple(vp[0].tolist()))
    theirs = run_gpd_tpu(lambda: japi.detect_grasps_in_file(
        JConfig(**kw), path, seed=2))
    jd = jdet.GraspDetector(JConfig(**kw), params={})
    jc = jd.preprocess_cloud(pts, view_points=vp[:1], capacity="serve")
    sub, noise = inject_draws(jc, jd.cfg, 2)
    with sub, noise:
        ours = api.detect_grasps_in_file(DetectorConfig(**kw), path, seed=2,
                                         device="cpu")
    same_grasps(theirs, ours)
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            pytest.raises(RuntimeError, match="CUDA"):
        api.detect_grasps_in_file(DetectorConfig(**kw), path)


def test_calc_grasp_descriptors():
    """The valid candidates in valid-first order with their images, at
    snug capacities and the configured neighbor caps."""
    pts, cam, vp = lattice_shell()
    kw = dict(KW, image_neighbors_cap=512)
    jd = jdet.GraspDetector(JConfig(**kw))
    td = GraspDetector(DetectorConfig(**kw), device="cpu")
    theirs, ij = run_gpd_tpu(lambda: japi.calc_grasp_descriptors(
        jd, pts, view_points=vp, seed=2))
    jc = jd.preprocess_cloud(pts, view_points=vp)
    assert jc.points.shape[0] > 512 == td.cfg.image_neighbors_cap
    sub, noise = inject_draws(jc, jd.cfg, 2)
    with sub, noise:
        ours, it = api.calc_grasp_descriptors(td, pts, view_points=vp, seed=2)
    assert len(ours) == len(theirs) > 200
    ij = np.asarray(ij)
    assert it.shape == ij.shape == (len(ours), 60, 60, 15)
    assert it.dtype == np.uint8 and it.any(axis=(1, 2, 3)).all()
    diff = np.abs(ij.astype(np.int32) - it.astype(np.int32))
    assert (diff > 1).mean() < 5e-3
    same = (diff <= 1).all(axis=(1, 2, 3))
    assert same.mean() > 0.95
    same_grasps([g for g, k in zip(theirs, same) if k],
                [g for g, k in zip(ours, same) if k], ordered=True)
    for name in ("position", "orientation"):
        np.testing.assert_allclose(np.array([g[name] for g in theirs]),
                                   np.array([g[name] for g in ours]),
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [2, 3, 5])
def test_scores_diverge_only_with_images(seed):
    """The serving path's candidates on the tube, both packages on the same
    samples and shadow draws: the same hands, poses within 1e-5, images
    within the repo's gate, and every score more than 1e-3 apart belongs to
    a hand whose image is more than one step apart somewhere."""
    pts, cam, vp = lattice_shell()
    jd = jdet.GraspDetector(JConfig(**KW))
    td = GraspDetector(DetectorConfig(**KW), device="cpu")
    key = jax.random.PRNGKey(seed)
    jc = jd.preprocess_cloud(pts, view_points=vp, cam_source=cam,
                             capacity="serve")
    cfg = jd.effective_config(jc)
    idx = np.array(jpp.subsample_uniform(jax.random.fold_in(key, 4), jc.mask,
                                         cfg.num_samples)[0])
    spos = np.asarray(jc.points)[idx]
    smask = np.ones(len(idx), bool)
    assert frame_gap_ok(jc, spos, cfg.nn_radius_frames).all()
    cap = jd.image_cap(len(idx))
    gj, ij = run_gpd_tpu(lambda: jdet.detect_core(
        jc, jnp.asarray(spos), jnp.asarray(smask), jd.params, key, cfg, cap,
        scores_only=False))
    gj, ij = gj.to_host(), np.asarray(ij)
    tc = port_cloud(jc)
    with inject(key):
        gt, it = tdet.detect_core(tc, T(spos), T(smask), td.net, None,
                                  td.effective_config(tc), cap,
                                  scores_only=False)
    gt, it = gt.to_host(), it.numpy()
    v = gj.valid
    np.testing.assert_array_equal(v, gt.valid)
    assert v.sum() > 200
    for name in ("position", "orientation"):
        np.testing.assert_allclose(getattr(gj, name)[v],
                                   getattr(gt, name)[v], atol=1e-5)
    diff = np.abs(ij[v].astype(np.int32) - it[v].astype(np.int32)) > 1
    assert diff.mean() < 5e-3
    apart = np.abs(gj.score[v] - gt.score[v]) > 1e-3
    assert not (apart & ~diff.any(axis=(1, 2, 3))).any()


def weights_config(tmp_path, **kw):
    """A config whose weights file is a copy of the packaged 15-channel
    checkpoint in ``tmp_path``, and that file's path."""
    path = tmp_path / "lenet.npz"
    shutil.copy(lenet.default_params_path(15), path)
    return DetectorConfig(weights_file=str(path), **kw), path


def test_equal_configs_share_one_detector(tmp_path):
    """Equal configs, as values or as equal cfg files, get the process's one
    detector on a device; a detector passed in is used as it is; another
    config gets another detector."""
    cfg, path = weights_config(tmp_path, num_samples=32)
    text = f"weights_file = {path}\nnum_samples = 32\n"
    for name in ("a.cfg", "b.cfg"):
        (tmp_path / name).write_text(text)
    det = api._as_detector(cfg, "cpu")
    assert api._as_detector(dataclasses.replace(cfg), "cpu") is det
    assert api._as_detector(str(tmp_path / "a.cfg"), "cpu") is \
        api._as_detector(str(tmp_path / "b.cfg"), "cpu")
    assert api._as_detector(det, "meta") is det
    assert api._as_detector(dataclasses.replace(cfg, num_samples=64),
                            "cpu") is not det


def test_changed_weights_or_device_give_another_detector(tmp_path):
    """A weights file touched since the last call gives a new detector with
    the file's weights, which later calls share; another device gives
    another detector."""
    cfg, path = weights_config(tmp_path, num_samples=32)
    det = api._as_detector(cfg, "cpu")
    params = lenet.load_params_npz(str(path))
    params = {k: v * 2 for k, v in params.items()}
    np.savez(path, **params)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    new = api._as_detector(cfg, "cpu")
    assert new is not det and api._as_detector(cfg, "cpu") is new
    np.testing.assert_array_equal(
        new.net.conv1.weight.detach().numpy(),
        2 * det.net.conv1.weight.detach().numpy())
    meta = api._as_detector(cfg, "meta")
    assert meta is not new and meta.net.conv1.weight.device.type == "meta"
    assert api._as_detector(cfg, "cpu") is new


def test_another_config_replaces_the_detector(tmp_path):
    """A device keeps one detector: another config replaces it (the old one
    is freed), and the first config then gets a new one; 'cpu' and
    torch.device('cpu') are one device."""
    cfg, _ = weights_config(tmp_path, num_samples=32)
    det = api._as_detector(cfg, "cpu")
    assert api._as_detector(cfg, torch.device("cpu")) is det
    gone = weakref.ref(det)
    del det
    other = api._as_detector(dataclasses.replace(cfg, num_samples=64), "cpu")
    assert gone() is None
    assert [d for *_, d in api._DETECTORS.values()
            if d.device.type == "cpu"] == [other]
    again = api._as_detector(cfg, "cpu")
    assert again is not other and again.cfg == cfg
