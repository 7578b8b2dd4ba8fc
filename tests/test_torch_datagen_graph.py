"""Data generation's attempt as device programs (gpd_tpu_torch/datagen.py,
``DataGenerator._attempt``; gpd_tpu_torch/detector.py,
``GraspDetector.candidates_with_images``): on the CPU against the eager
attempt, and on the card as CUDA graphs.

An attempt runs detect's A (samples and candidates), one read of A's
counts, B (images and scores over the live sample blocks and image chunks)
and R (the relabeling against the mesh cloud), then reads the valid
labels; on a card each program replays a CUDA graph captured at the first
request of its key. The CPU tests hold the program route to the eager
attempt's labels and images bit for bit, the programs to reading nothing
back to the host, and ``api.calc_grasp_descriptors`` to the eager
``detect_core``. The tests marked ``cuda`` need a card and skip without
one; this module imports no JAX, so they run where there is none:

    python -m pytest tests/test_torch_datagen_graph.py -m cuda --noconftest
"""

import unittest.mock as mock

import numpy as np
import pytest
import torch

from gpd_tpu_torch import api, datagen
from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.core.types import CloudArrays
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.ops import _build
from gpd_tpu_torch.ops import candidates as cand
from test_torch_threads import set_cpu_share

set_cpu_share()

SMALL = dict(search_neighbors_cap=256, frame_neighbors_cap=32,
             normals_neighbors_cap=32, shadow_voxel_cap=256)


def cylinder(seed=1234):
    """A half-cylinder view and the full cylinder as mesh (r = 3 cm,
    exact normals) on the CPU, as tests/test_torch_datagen.py makes them."""
    rng = np.random.default_rng(seed)
    n = 2000

    def cyl(theta):
        pts = np.stack([0.03 * np.cos(theta), 0.03 * np.sin(theta),
                        rng.uniform(-0.05, 0.05, n)], 1).astype(np.float32)
        nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)],
                       1).astype(np.float32)
        return CloudArrays.from_numpy(pts, normals=nrm, device="cpu")
    return cyl(rng.uniform(-np.pi / 2, np.pi / 2, n)), cyl(
        rng.uniform(0, 2 * np.pi, n))


def cpu_generator(channels=15, num_samples=16, min_pos=1, **kw):
    det = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels),
        num_samples=num_samples, **SMALL, **kw), device="cpu")
    return datagen.DataGenerator(det, datagen.DataGenConfig(
        min_grasps_per_view=min_pos, max_grasps_per_view=50))


def by_route(gen, view, mesh, seed=3):
    """generate_view by the program route (the default) and the eager
    attempt (``_force_eager``) from one generator seed: per route (images,
    labels, last_counts, the generator's state after)."""
    out = {}
    for route in ("programs", "eager"):
        gen.detector._force_eager = route == "eager"
        g = torch.Generator(device=gen.detector.device).manual_seed(seed)
        images, labels = gen.generate_view(view, mesh, g,
                                           np.random.default_rng(5))
        out[route] = (images, labels, dict(gen.last_counts), g.get_state())
    gen.detector._force_eager = False
    return out


@pytest.mark.parametrize("channels,num_samples,min_pos,kw", [
    (15, 16, 1, {}), (15, 16, 150, {}), (3, 16, 1, {}),
    (15, 96, 1, dict(workspace_grasps=(-1, 1, -1, 1, 0.01, 1))),
    (15, 600, 1, {})], ids=["15ch-1", "15ch-2attempts", "3ch", "15ch-sparse",
                            "15ch-2blocks"])
def test_program_route_equals_the_eager_route(channels, num_samples, min_pos,
                                              kw):
    """The same attempts, candidates and positives, labels and images bit
    for bit, and the generator left at the same state. The cases: one
    attempt, two (min 150 positives, about 100 an attempt), 3 channels,
    hands cut to under one image chunk of two by the grasp workspace, and
    600 samples (two sample blocks of 512). The program route calls no
    eager detect_core."""
    gen = cpu_generator(channels, num_samples, min_pos, **kw)
    view, mesh = cylinder()
    with mock.patch.object(tdet, "detect_core",
                           wraps=tdet.detect_core) as core:
        out = by_route(gen, view, mesh)
    assert core.call_count == out["eager"][2]["attempts"]
    (pi, pl, pc, ps), (ei, el, ec, es) = out["programs"], out["eager"]
    assert pc == ec and pc["attempts"] == (2 if min_pos == 150 else 1)
    if kw:
        assert pc["candidates"] < gen.detector.image_cap(num_samples)
    assert len(pl) > 0 and 2 * pl.sum() == len(pl)
    np.testing.assert_array_equal(pl, el)
    np.testing.assert_array_equal(pi, ei)
    assert torch.equal(ps, es)


def _no_host_read(*args, **kwargs):
    raise AssertionError("an attempt's program read a tensor back to the host")


@pytest.mark.parametrize("channels", [15, 3])
def test_attempt_programs_read_nothing_back(channels):
    """A, B (with images) and R run with every way of reading a tensor back
    to the host patched to raise; the eager attempt, which reads its counts
    where it needs them, trips the same guard."""
    from test_torch_cem import HOST_READS, run_patched
    gen = cpu_generator(channels, 96)
    det = gen.detector
    view, mesh = cylinder()
    cfg = det.effective_config(view)
    cap = det.image_cap(cfg.num_samples)
    patches = [mock.patch.object(torch.Tensor, name, _no_host_read)
               for name in HOST_READS]
    g = torch.Generator().manual_seed(0)
    grasps, spos, smask, counts = run_patched(
        patches, lambda: tdet.candidates_program(view, None, None, g, cfg))
    n_valid, n_active = counts.tolist()[:2]
    scored, images = run_patched(patches, lambda: tdet.score_candidates(
        view, grasps, spos, smask, det.net, g, cfg, cap, scores_only=False,
        live=(n_valid, n_active)))
    labels, _ = run_patched(patches, lambda: cand.reevaluate_hypotheses(
        mesh, scored, cfg))
    assert images.shape == (scored.capacity, 60, 60, channels)
    assert 0 < int(labels.sum()) <= n_valid == int(scored.valid.sum())
    det._force_eager = True
    with pytest.raises(AssertionError, match="read a tensor back"):
        run_patched(patches, lambda: gen._attempt(view, mesh, g, cfg))


def test_images_into_a_buffer_equal_fresh_images():
    """B with images writing into a given buffer (on a card the detector's
    one buffer, which every such B key shares) gives the fresh tensor's
    images and scores bit for bit: the dead chunk, here the second of two,
    is zeroed over what the buffer held. A buffer of another shape
    raises."""
    gen = cpu_generator(15, 96, workspace_grasps=(-1, 1, -1, 1, 0.01, 1))
    det = gen.detector
    view, _ = cylinder()
    cfg = det.effective_config(view)
    cap = det.image_cap(cfg.num_samples)
    g = torch.Generator().manual_seed(0)
    grasps, spos, smask, counts = tdet.candidates_program(view, None, None,
                                                          g, cfg)
    live = tuple(counts.tolist()[:2])
    rows = -(-grasps.capacity // cap) * cap
    assert live[0] <= cap < rows
    state = g.get_state()

    def score(out):
        g.set_state(state)
        return tdet.score_candidates(view, grasps, spos, smask, det.net, g,
                                     cfg, cap, scores_only=False, live=live,
                                     images_out=out)
    buf = torch.full((rows, 60, 60, 15), 255, dtype=torch.uint8)
    fresh, into = score(None), score(buf)
    assert into[1] is buf and torch.equal(into[1], fresh[1])
    assert not buf[cap:].any()
    assert torch.equal(into[0].score, fresh[0].score)
    with pytest.raises(ValueError, match="images_out"):
        score(buf[:cap])


def test_calc_grasp_descriptors_by_programs_equals_detect_core():
    """calc_grasp_descriptors (A, the read, B with images, at ``det.cfg``)
    against the eager detect_core on the same cloud and seed: the same
    grasps and images bit for bit, and no eager detect_core call."""
    view, _ = cylinder(7)
    pts = view.points.numpy()
    vp = np.float32([[0.4, 0.0, 0.0]])
    det = tdet.GraspDetector(DetectorConfig(num_samples=32, **SMALL),
                             device="cpu")
    with mock.patch.object(tdet, "detect_core",
                           wraps=tdet.detect_core) as core:
        grasps, images = api.calc_grasp_descriptors(det, pts, view_points=vp,
                                                    seed=2)
    assert core.call_count == 0
    cloud = det.preprocess_cloud(pts, view_points=vp)
    gen = torch.Generator().manual_seed(2)
    spos, smask = det.sample_cloud(cloud, gen)
    g, ref = tdet.detect_core(cloud, spos, smask, det.net, gen, det.cfg,
                              det.image_cap(spos.shape[0]))
    assert len(grasps) == int(g.valid.sum()) > 100
    np.testing.assert_array_equal(images, ref.numpy()[g.valid.numpy()])
    for ours, theirs in zip(grasps, g.to_host_list()):
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])


# ------------------------------------------------------------- on the card

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: an attempt's programs are "
                    "captured as CUDA graphs only there (chip_smoke.py runs "
                    "them)")


def zoo_unit(channels=15):
    """A card DataGenerator at the default configs and one synthetic zoo
    object: a rendered view, preprocessed into its serving bucket, and the
    whole object as mesh cloud."""
    det = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels)), device="cuda")
    rng = np.random.default_rng(7)
    (_, pts, nrm), = syn.object_zoo(1, seed=7)
    cam = syn.view_cameras(rng, 1)[0]
    view = det.preprocess_cloud(syn.render_view(rng, pts, nrm, cam),
                                view_points=cam[None], capacity="serve")
    mesh = CloudArrays.from_numpy(pts, normals=nrm, device="cuda")
    return datagen.DataGenerator(det, datagen.DataGenConfig()), view, mesh


def attempt_keys(det):
    return [k for k in det.graphs
            if k[0] in ("candidates", "score", "relabel")]


@pytest.mark.cuda
def test_one_capture_per_datagen_key():
    """A view captures A, B (with images) and R once per key it meets, and
    a view of seen keys captures nothing and calls no kernel wrapper."""
    needs_card()
    gen, view, mesh = zoo_unit()
    det = gen.detector
    g = torch.Generator(device="cuda")
    gen.generate_view(view, mesh, g.manual_seed(0), np.random.default_rng(0))
    seen = set(det.last_graphs)
    assert {k[0] for k in seen} == {"candidates", "score", "relabel"}
    assert all(k[-1] == "images" for k in seen if k[0] == "score")
    assert set(attempt_keys(det)) == seen
    n, before = len(det.graphs), _build.LAUNCHES.copy()
    gen.generate_view(view, mesh, g.manual_seed(0), np.random.default_rng(0))
    assert len(det.graphs) == n and set(det.last_graphs) == seen
    assert _build.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [15, 3])
def test_graph_labels_equal_eager_labels(channels):
    """The graph route and the eager attempt from one seed: the same
    counts, labels and generator state, images within the repo's gate
    (under 0.5% of pixels more than one step apart)."""
    needs_card()
    gen, view, mesh = zoo_unit(channels)
    by_route(gen, view, mesh)                      # captures
    out = by_route(gen, view, mesh)
    (pi, pl, pc, ps), (ei, el, ec, es) = out["programs"], out["eager"]
    assert pc == ec and len(pl) > 0
    np.testing.assert_array_equal(pl, el)
    assert torch.equal(ps, es)
    diff = np.abs(pi.astype(np.int32) - ei.astype(np.int32))
    assert (diff > 1).mean() < 5e-3


@pytest.mark.cuda
def test_graph_hands_equal_eager_hands():
    """A second view, whose A and B are captured after the first view's R,
    keeps the same hands and labels by the graph route as by the eager
    attempt: B's hands are copied before R replays, so R's working memory,
    which a later capture may share, does not reach them."""
    needs_card()
    gen, view, mesh = zoo_unit()
    det = gen.detector
    rng = np.random.default_rng(11)
    (_, pts, nrm), = syn.object_zoo(1, seed=8)
    cams = syn.view_cameras(rng, 2)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, cams, occluded=False)
    second = det.preprocess_cloud(p, view_points=vp, cam_source=cs,
                                  capacity="serve")
    g = torch.Generator(device="cuda")
    gen.generate_view(view, mesh, g.manual_seed(0), np.random.default_rng(0))
    relabel = [k for k in det.graphs if k[0] == "relabel"]
    out = {}
    for route in ("programs", "eager"):
        det._force_eager = route == "eager"
        _, labels = gen.generate_view(second, mesh, g.manual_seed(1),
                                      np.random.default_rng(1))
        out[route] = labels, {k: v.clone()
                              for k, v in gen.last_candidates.items()}
    det._force_eager = False
    assert [k for k in det.graphs if k[0] == "relabel"] == relabel
    (pl, pc), (el, ec) = out["programs"], out["eager"]
    np.testing.assert_array_equal(pl, el)
    assert len(pc["label"]) > 0 and set(pc) == set(ec)
    assert all(torch.equal(pc[k], ec[k]) for k in pc), [
        k for k in pc if not torch.equal(pc[k], ec[k])]


@pytest.mark.cuda
def test_datagen_b_keys_share_one_images_buffer():
    """Every B key with images of one shape writes into the detector's one
    images buffer, outside the graphs' pool: the images are not an output
    of any graph, and no B capture adds their bytes to the pool. A detect
    request on the view first captures A and a B without images, so the
    pool already holds a B's working set (the raster planes of a chunk)
    and what a B with images adds is what it keeps."""
    needs_card()
    gen, view, mesh = zoo_unit()
    det = gen.detector
    g = torch.Generator(device="cuda")
    det.detect(view, generator=g.manual_seed(0), verbose=False)
    for seed in range(3):
        gen.generate_view(view, mesh, g.manual_seed(seed),
                          np.random.default_rng(0))
    (buf,) = det._images.values()
    bs = [e for k, e in det.graphs.items()
          if k[0] == "score" and k[-1] == "images"]
    assert bs and all(e.out[1].data_ptr() == buf.data_ptr() for e in bs)
    assert all(e.pool_bytes < buf.nbytes for e in bs)
