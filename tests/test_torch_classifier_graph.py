"""The packaged classifier's quality gates on the card
(tests/test_classifier_quality.py, ``TestTrainedClassifier``): the rank
AUC of the shipped ``lenet_15ch`` scores against full-mesh antipodal labels,
each view's candidates and scores from the detector's programs (detect's A
and B as CUDA graphs) and its labels from ``reevaluate_hypotheses`` on the
card; and ``tools.slice_channels``' premise on the card's kernels.

gpd_tpu's floors: 0.80 on held-out zoo objects, 0.85 on two-camera clutter
scenes. Under ``DetectorConfig()``'s defaults (the reference's
cfg/eigen_params.cfg is not in the repo) gpd_tpu clears both on the CPU:
tests/test_torch_classifier_quality.py computes the first beside the
port's. Every test here needs a card and skips without one; the module
imports no JAX, so it runs where there is none:

    python -m pytest tests/test_torch_classifier_graph.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.core.types import CloudArrays
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.ops import candidates as cand
from test_torch_threads import set_cpu_share

set_cpu_share()

QUALITY = dict(min_inliers=0, weights_file="")


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the detector's programs run as "
                    "CUDA graphs only there (chip_smoke.py runs them)")


def auc(scores, labels):
    """Rank AUC: the probability that a random positive outscores a random
    negative (gpd_tpu's test's ``_auc``)."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    npos = int(labels.sum())
    nneg = len(labels) - npos
    assert npos > 0 and nneg > 0
    return (ranks[labels == 1].sum() - npos * (npos + 1) / 2) / (npos * nneg)


def heldout_views(det):
    """gpd_tpu's held-out objects: object_zoo(3, seed=17), one camera each
    from rng 99; (view, mesh) on the detector's device."""
    rng = np.random.default_rng(99)
    for _, mpts, mnrm in syn.object_zoo(3, seed=17):
        cam = syn.view_cameras(rng, 1)[0]
        view = det.preprocess_cloud(syn.render_view(rng, mpts, mnrm, cam),
                                    view_points=cam.reshape(1, 3))
        yield view, CloudArrays.from_numpy(mpts, normals=mnrm,
                                           device=det.device)


def clutter_views(det):
    """gpd_tpu's held-out clutter: 2 make_scene(n_objects=3) table scenes
    from rng 1234, each seen by two fused occluded cameras."""
    rng = np.random.default_rng(1234)
    for _ in range(2):
        spts, snrm = syn.make_scene(rng, n_objects=3)
        cams = syn.view_cameras(rng, 2, dist=0.7)
        vpts, vcam, vps = syn.render_fused_views(rng, spts, snrm, cams,
                                                 occluded=True)
        view = det.preprocess_cloud(vpts, view_points=vps, cam_source=vcam)
        yield view, CloudArrays.from_numpy(spts, normals=snrm,
                                           device=det.device)


def scored_auc(det, views, seed):
    """Over ``views``: each one's samples drawn by the detector, its valid
    candidates' scores from detect's A and B, their full-mesh labels; the
    rank AUC and the candidate count."""
    scores, labels = [], []
    for i, (view, mesh) in enumerate(views):
        gen = torch.Generator(device=det.device).manual_seed(seed + i)
        cfg = det.effective_config(view)
        spos, smask = det.sample_cloud(view, gen)
        scored, _, counts, _ = det._scored_programs(view, spos, smask, gen,
                                                    cfg)
        n = counts[0]
        lab, _ = cand.reevaluate_hypotheses(mesh, scored, cfg)
        scores.append(scored.score[:n].cpu().numpy())
        labels.append(lab[:n].cpu().numpy())
    return auc(np.concatenate(scores), np.concatenate(labels)), sum(
        map(len, labels))


@pytest.mark.cuda
@pytest.mark.parametrize("views,samples,floor", [
    (heldout_views, 80, 0.80), (clutter_views, 120, 0.85)])
def test_shipped_classifier_auc_on_the_card(views, samples, floor):
    needs_card()
    det = tdet.GraspDetector(DetectorConfig(num_samples=samples, **QUALITY),
                             device="cuda")
    value, n = scored_auc(det, views(det), 7)
    print(f"{views.__name__}: AUC {value:.4f} over {n} candidates")
    assert value > floor
    assert any(k[0] == "score" for k in det.graphs)


@pytest.mark.cuda
def test_sliced_images_equal_native_three_channel_images_on_the_card():
    """One clutter view through a 15- and a 3-channel detector from one
    generator state: channels 0:3 of the ``raster_blocks`` images equal
    the ``raster_sums`` images within the repo's image gate."""
    needs_card()
    dets = {c: tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=c), num_samples=120,
        **QUALITY), device="cuda") for c in (15, 3)}
    view, _ = next(clutter_views(dets[15]))
    out = {}
    for c, det in dets.items():
        gen = torch.Generator(device="cuda").manual_seed(3)
        g, images, n = det.candidates_with_images(view, gen)
        out[c] = (g.position[:n].cpu(), images[:n].cpu().numpy())
    (p15, i15), (p3, i3) = out[15], out[3]
    assert torch.equal(p15, p3) and len(p3) > 0 and i3.any()
    diff = np.abs(i15[..., :3].astype(np.int32) - i3.astype(np.int32))
    assert (diff > 1).mean() < 5e-3
