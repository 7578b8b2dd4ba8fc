"""The packaged classifier's quality gates (tests/test_classifier_quality.py,
``TestTrainedClassifier``) held on the port, on the CPU.

1. Scores rank true grasps above false ones: the rank AUC of the port's
   scores against full-mesh antipodal labels (``reevaluate_hypotheses``
   against the whole object) on held-out zoo objects, beside gpd_tpu's AUC
   on the same views, computed here with JAX. gpd_tpu's test reads the
   reference's cfg/eigen_params.cfg, which the repo does not hold; both
   packages run ``DetectorConfig()``'s defaults with the test's overrides.
   The port detects on gpd_tpu's preprocessed cloud and samples, with
   gpd_tpu's shadow draws injected, as the whole-slice parity does (frames
   on the zoo's flat box faces are set by rounding, ROADMAP C).
2. The normals blend->mean rasterizer divergence stays score-neutral under
   the port's ``make_images`` and LeNet.
3. ``tools.slice_channels``' premise: channels 0:3 of the 15-channel images
   are the 3-channel images, within the repo's image gate, on the plain
   kernels (``raster_blocks_ref`` against ``raster_sums_ref``).

The clutter-scene AUC runs on the card (tests/test_torch_classifier_graph.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpd_tpu.config import DetectorConfig as JConfig
from gpd_tpu.core.types import CloudArrays as JCloud
from gpd_tpu.detector import GraspDetector as JDetector
from gpd_tpu.detector import detect_core as jdetect_core
from gpd_tpu.ops import candidates as jcand
from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.core.types import CloudArrays
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.net import lenet
from gpd_tpu_torch.ops import candidates as cand
from gpd_tpu_torch.ops import images as img
from test_classifier_quality import _auc
from test_images import np_normals_image, np_unit_and_cells
from test_torch_detector import (ROD_KW, T, image_gate, inject, port_cloud,
                                 rods_only, sample_where_frames_defined)
from test_torch_threads import set_cpu_share

set_cpu_share()

QUALITY = dict(min_inliers=0, weights_file="")


def test_heldout_object_auc_matches_gpd_tpu():
    """Held-out objects (object_zoo(3, seed=17), rng 99, one camera each,
    80 samples): the port's AUC clears gpd_tpu's floor of 0.80 wherever
    gpd_tpu's does, and lies within 0.02 of it."""
    jd = JDetector(JConfig(num_samples=80, **QUALITY))
    td = tdet.GraspDetector(DetectorConfig(num_samples=80, **QUALITY),
                            device="cpu")
    rng = np.random.default_rng(99)
    theirs, ours = ([], []), ([], [])
    for name, mpts, mnrm in syn.object_zoo(3, seed=17):
        mesh = JCloud.from_numpy(mpts, normals=mnrm,
                                 view_points=np.zeros((1, 3), np.float32))
        cam = syn.view_cameras(rng, 1)[0]
        vpts = syn.render_view(rng, mpts, mnrm, cam)
        view = jd.preprocess_cloud(vpts, view_points=cam.reshape(1, 3))
        cfg_j = jd.effective_config(view)
        key = jax.random.PRNGKey(7)
        spos, smask = jd.sample_cloud(view, key)
        g, _ = jdetect_core(view, spos, smask, jd.params, key, cfg_j,
                            jd.image_cap(spos.shape[0]), scores_only=True)
        lab, _ = jcand.reevaluate_hypotheses(mesh, g, cfg_j)
        n = int(np.asarray(jnp.sum(g.valid)))
        theirs[0].append(np.asarray(g.score[:n]))
        theirs[1].append(np.asarray(lab[:n]))

        cloud = port_cloud(view)
        cfg_t = td.effective_config(cloud)
        with inject(key):
            g, _ = tdet.detect_core(cloud, T(spos), T(smask), td.net, None,
                                    cfg_t, td.image_cap(spos.shape[0]),
                                    scores_only=True)
        lab, _ = cand.reevaluate_hypotheses(
            CloudArrays.from_numpy(mpts, normals=mnrm, device="cpu"), g,
            cfg_t)
        n = int(g.valid.sum())
        ours[0].append(g.score[:n].numpy())
        ours[1].append(lab[:n].numpy())
    auc_j, auc_t = (_auc(np.concatenate(s), np.concatenate(lb))
                    for s, lb in (theirs, ours))
    n_j, n_t = len(np.concatenate(theirs[1])), len(np.concatenate(ours[1]))
    print(f"held-out objects, score/label AUC: gpd_tpu {auc_j:.4f} over "
          f"{n_j} candidates, the port {auc_t:.4f} over {n_t}")
    assert abs(auc_t - auc_j) < 0.02
    if auc_j > 0.80:
        assert auc_t > 0.80, f"port AUC {auc_t:.3f} <= 0.80"


def test_blend_vs_mean_score_delta(rng):
    """The reference's order-dependent normals blend against the port's
    cell mean, each projection's normals channels rebuilt by the blend
    oracle: the positive-class probability under the packaged weights moves
    by under 0.05 on average and 0.25 at most, gpd_tpu's bounds."""
    net = lenet.params_from_numpy(
        lenet.load_params_npz(lenet.default_params_path(15)), device="cpu")
    geom = ImageGeometry(num_channels=15)
    G, K, Ks = 24, 600, 400

    pts = rng.uniform(-0.06, 0.08, size=(G, K, 3)).astype(np.float32)
    nrm = rng.normal(size=(G, K, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    spts = rng.uniform(-0.06, 0.08, size=(G, Ks, 3)).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (G, 3, 3)).copy()
    bottom = np.full(G, -0.01, np.float32)
    center = np.full(G, 0.005, np.float32)

    ours = img.make_images(
        T(pts), T(nrm), torch.ones(G, K, dtype=torch.bool), T(R),
        torch.zeros(G, 3), T(bottom), T(center),
        torch.ones(G, dtype=torch.bool), geom, shadow_pts=T(spts),
        shadow_valid=torch.ones(G, Ks, dtype=torch.bool)).numpy()

    blended = ours.copy()
    for g in range(G):
        unit, ins = np_unit_and_cells(pts[g].astype(np.float64),
                                      float(bottom[g]), float(center[g]),
                                      geom)
        absn = np.abs(nrm[g]).astype(np.float64)
        for pi, p in enumerate(((0, 1, 2), (2, 1, 0), (2, 0, 1))):
            b = np_normals_image(unit[:, p], ins, absn, geom, blend=True)
            blended[g, :, :, 5 * pi:5 * pi + 3] = b

    def pos_prob(batch):
        with torch.no_grad():
            return torch.softmax(net(torch.from_numpy(batch)), -1)[:, 1]

    delta = (pos_prob(ours) - pos_prob(blended)).abs().numpy()
    print(f"blend->mean |dP(pos)|: mean {delta.mean():.4f} "
          f"max {delta.max():.4f}")
    assert delta.mean() < 0.05, f"mean score delta {delta.mean():.4f}"
    assert delta.max() < 0.25, f"max score delta {delta.max():.4f}"


@pytest.mark.parametrize("seed", [7, 8])
def test_sliced_images_equal_native_three_channel_images(seed):
    """One cloud, one sample set, one generator state, through a 15- and a
    3-channel detector: channels 0:3 of the 15-channel images (the
    ``raster_blocks`` plain route) equal the 3-channel images (the
    ``raster_sums`` plain route) within the repo's image gate."""
    p, cs, vp = rods_only(seed)
    kw = dict(num_samples=48, image_neighbors_cap=256, **ROD_KW, **QUALITY)
    dets = {c: tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=c), **kw), device="cpu")
        for c in (15, 3)}
    jd = JDetector(JConfig(**kw))
    cloud = port_cloud(jd.preprocess_cloud(p, view_points=vp,
                                           cam_source=cs))
    spos, smask = sample_where_frames_defined(jd, jd.preprocess_cloud(
        p, view_points=vp, cam_source=cs), 48)
    out = {}
    for c, det in dets.items():
        cfg = det.effective_config(cloud)
        g, images = tdet.detect_core(cloud, T(spos), T(smask), det.net,
                                     torch.Generator().manual_seed(seed),
                                     cfg, det.image_cap(48))
        out[c] = (g, images.numpy())
    (g15, i15), (g3, i3) = out[15], out[3]
    np.testing.assert_array_equal(g15.valid.numpy(), g3.valid.numpy())
    n = int(g3.valid.sum())
    assert n > 0
    for f in ("sample_id", "orientation", "position"):
        np.testing.assert_array_equal(getattr(g15, f)[:n].numpy(),
                                      getattr(g3, f)[:n].numpy())
    assert i3[:n].any()
    image_gate(np.ascontiguousarray(i15[:n, ..., 0:3]), i3[:n])
