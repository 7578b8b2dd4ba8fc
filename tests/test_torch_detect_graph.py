"""detect's three device programs (gpd_tpu_torch/detector.py,
``GraspDetector._detect_programs``): on the CPU against the eager route,
and on the card as CUDA graphs.

A request runs A (``candidates_program``: samples, candidates, counts), one
read of A's counts, B (``score_candidates`` over the live sample blocks and
image chunks, ``live=`` from that read) and C (``select_and_cluster``); on
a card each part replays a CUDA graph captured at the first request of its
key. The CPU tests hold the parts to reading nothing back to the host and
the split route to the eager route's grasps and draws, at 15 and 3 channels
(3 with sampling above the plane and plane removal before the images on,
so that A and B both draw RANSAC triplets), on the thin rods of
tests/test_torch_detector.py. The tests marked ``cuda`` need a card and
skip without one; this module imports no JAX, so they run where there is
none:

    python -m pytest tests/test_torch_detect_graph.py -m cuda --noconftest
"""

import gc
import unittest.mock as mock

import numpy as np
import pytest
import torch

from gpd_tpu_torch import api, datagen
from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.net import lenet
from gpd_tpu_torch.ops import _build
from gpd_tpu_torch.ops import candidates as cand
from gpd_tpu_torch.ops.frames import estimate_frames
from gpd_tpu_torch.ops.neighbors import radius_neighbors
from test_torch_threads import set_cpu_share

set_cpu_share()


def gen(seed):
    return torch.Generator().manual_seed(seed)


def rods_detector(channels, num_samples=96):
    """A CPU detector on the rods of test_torch_detector.py (imported here,
    not at the top: that module imports JAX) and its cloud. At 96 samples
    the 768 hands make two image chunks of 512."""
    from test_torch_detector import ROD_KW, rods_only
    p, cs, vp = rods_only(6)
    det = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels),
        num_samples=num_samples, image_neighbors_cap=256, num_selected=12,
        sample_above_plane=channels == 3,
        remove_plane_before_image_calculation=channels == 3, **ROD_KW),
        device="cpu")
    return det, det.preprocess_cloud(p, view_points=vp, cam_source=cs)


def two_hand_blocks():
    """The hand search's block budget cut so that 96 samples on the rods
    make two sample blocks, as 1000 samples do on the card's scenes: the
    eager search then reads its valid-frame count, A runs both blocks."""
    return mock.patch.object(cand, "_BLOCK_ELEMS", 1 << 20)


def _no_host_read(*args, **kwargs):
    raise AssertionError("detect's part read a tensor back to the host")


@pytest.mark.parametrize("channels", [15, 3])
def test_parts_read_nothing_back(channels):
    """A, B and C, called with their static arguments, run with every way
    of reading a tensor back to the host patched to raise; A's counts are
    the valid hands, active samples, valid samples, cloud points and the
    largest hand-search neighbourhood. The eager detect_core +
    select_and_cluster trips the same guard. The hand search runs in two
    sample blocks (``two_hand_blocks``)."""
    from test_torch_cem import HOST_READS, run_patched
    det, cloud = rods_detector(channels)
    cfg = det.effective_config(cloud)
    cap = det.image_cap(cfg.num_samples)
    patches = [two_hand_blocks()] + [
        mock.patch.object(torch.Tensor, name, _no_host_read)
        for name in HOST_READS]
    g = gen(0)
    grasps, spos, smask, counts = run_patched(
        patches, lambda: tdet.candidates_program(cloud, None, None, g, cfg))
    n_valid, n_active, n_samples, n_points, n_hood = counts.tolist()
    active = grasps.valid.reshape(cfg.num_samples, -1).any(1) & smask
    _, fvalid = estimate_frames(spos, smask, cloud.points, cloud.mask,
                                cloud.normals, radius=cfg.nn_radius_frames)
    _, member = radius_neighbors(spos, fvalid, cloud.points, cloud.mask,
                                 cfg.hand_search_radius,
                                 cfg.search_neighbors_cap)
    assert [n_valid, n_active, n_samples, n_points, n_hood] == [
        int(grasps.valid.sum()), int(active.sum()), int(smask.sum()),
        int(cloud.mask.sum()), int(member.sum(1).max())]
    assert 0 < n_valid and 0 < n_active <= n_samples == cfg.num_samples
    out = run_patched(patches, lambda: tdet.select_and_cluster(
        tdet.score_candidates(cloud, grasps, spos, smask, det.net, g, cfg,
                              cap, live=(n_valid, n_active))[0], cfg))
    assert out.valid.any()
    with pytest.raises(AssertionError, match="read a tensor back"):
        run_patched(patches, lambda: tdet.select_and_cluster(tdet.detect_core(
            cloud, spos, smask, det.net, gen(0), cfg, cap,
            scores_only=True)[0], cfg))


@pytest.mark.parametrize("channels,num_samples", [(15, 96), (3, 96),
                                                  (15, 600)])
def test_split_route_equals_the_eager_route(channels, num_samples):
    """One generator seed through detect's default route (A, the read, B,
    C) and its eager route (_force_eager): the same counts, valid flags,
    positions (1e-6) and scores (1e-5), and the generator left at the same
    state. The hand search runs in two or more sample blocks
    (``two_hand_blocks``): A runs them all, the eager route those up to
    its valid-frame count. 600 samples are two sample blocks of 512 for
    the descriptor inputs too, which B skips by the active-sample count."""
    det, cloud = rods_detector(channels, num_samples)
    g_split, g_eager = gen(3), gen(3)
    with two_hand_blocks(), \
            mock.patch.object(tdet, "candidates_program",
                              wraps=tdet.candidates_program) as part_a, \
            mock.patch.object(tdet, "detect_core",
                              wraps=tdet.detect_core) as core:
        split = det.detect(cloud, generator=g_split, verbose=False)
    assert part_a.call_count == 1 and core.call_count == 0
    counts = det.last_counts
    det._force_eager = True
    with two_hand_blocks():
        eager = det.detect(cloud, generator=g_eager, verbose=False)
    assert counts == det.last_counts and counts["candidates"] > 0
    vs, ve = split.valid.numpy(), eager.valid.numpy()
    np.testing.assert_array_equal(vs, ve)
    np.testing.assert_allclose(split.position.numpy()[vs],
                               eager.position.numpy()[ve], atol=1e-6)
    np.testing.assert_allclose(split.score.numpy()[vs],
                               eager.score.numpy()[ve], atol=1e-5)
    assert torch.equal(g_split.get_state(), g_eager.get_state())


def test_few_valid_hands_take_one_live_chunk():
    """Under 512 valid hands of 768: B runs with one live chunk of two,
    and the LeNet scores one chunk."""
    det, cloud = rods_detector(15)
    cap = det.image_cap(96)
    with mock.patch.object(tdet, "score_candidates",
                           wraps=tdet.score_candidates) as part_b, \
            mock.patch.object(tdet.lenet, "score",
                              wraps=tdet.lenet.score) as score:
        det.detect(cloud, generator=gen(0), verbose=False)
    assert 0 < det.last_counts["candidates"] <= cap == 512 < 96 * 8
    assert part_b.call_args.kwargs["live"] == (cap, 0)
    assert score.call_count == 1


def test_a_new_net_drops_the_old_nets_graphs():
    """GraspDetector.net's setter on the keys a request, a preprocess and a
    data-generation view make (``det.programs.run`` patched to record each
    key, as a card would capture it): the same net drops nothing; another net drops
    the keys that hold the old net's identity (detect's A, B and C and
    data generation's B) and keeps the preprocess and relabeling keys."""
    det, cloud = rods_detector(15)
    run = det.programs.run

    def recording_run(key, program, inputs=(), generator=None, **kw):
        det.graphs[key] = None
        return run(key, program, inputs, generator, **kw)
    dg = datagen.DataGenerator(det, datagen.DataGenConfig(
        min_grasps_per_view=1))
    with mock.patch.object(det.programs, "run", recording_run):
        from test_torch_detector import rods_only
        p, cs, vp = rods_only(6)
        det.preprocess_cloud(p, view_points=vp, cam_source=cs)
        det.detect(cloud, generator=gen(0), verbose=False)
        dg.generate_view(cloud, cloud, gen(1), np.random.default_rng(0))
    keys = list(det.graphs)
    names = [k[0] for k in keys]
    assert {"prep_filter_voxel", "prep_normals", "candidates", "score",
            "select", "relabel"} == set(names)
    old = det.net
    det.net = old
    assert list(det.graphs) == keys
    det.net = lenet.params_from_numpy(lenet.params_to_numpy(old), "cpu")
    assert [k[0] for k in det.graphs] == [
        n for n in names if n not in ("candidates", "score", "select")]
    assert not any(id(old) in k for k in det.graphs)


# ------------------------------------------------------------- on the card

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: detect's programs are captured "
                    "as CUDA graphs only there (chip_smoke.py runs them)")


def table_detector(capacity=None):
    """A card detector at the default config (15 channels, 1000 samples)
    and a small table scene (2 objects, 2 cameras)."""
    rng = np.random.default_rng(3)
    pts, nrm = syn.make_scene(rng, n_objects=2, points_per_object=1500,
                              table_points=1500, table_halfsize=0.15)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))
    det = tdet.GraspDetector(DetectorConfig(), device="cuda")
    return det, det.preprocess_cloud(p, view_points=vp, cam_source=cs,
                                     capacity=capacity)


def seeded(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def detect_keys(det):
    """The detector's graph keys of detect's parts (its preprocess programs
    share ``det.graphs``)."""
    return [k for k in det.graphs
            if k[0] in ("candidates", "score", "select")]


@pytest.mark.cuda
def test_one_capture_per_key_and_live_pair():
    """A request captures A, B and C once; B and C again for each new
    (sample blocks, image chunks) pair, A again for a new capacity."""
    needs_card()
    det, cloud = table_detector()
    det.detect(cloud, generator=seeded(0), verbose=False)
    assert [k[0] for k in det.last_graphs] == ["candidates", "score",
                                               "select"]
    pairs = set()
    for seed in (0, 1, 2, 3):
        det.detect(cloud, generator=seeded(seed), verbose=False)
        pairs.add(det.last_graphs[1][-2:])
    assert len(detect_keys(det)) == 1 + 2 * len(pairs)
    _, bigger = table_detector(capacity=2 * cloud.capacity)
    n = len(det.graphs)
    det.detect(bigger, generator=seeded(0), verbose=False)
    assert len(det.graphs) == n + 3
    det.detect(bigger, generator=seeded(0), verbose=False)
    assert len(det.graphs) == n + 3


@pytest.mark.cuda
def test_returned_grasps_survive_the_next_request():
    """A request's grasps are copies: the next replay, on other draws,
    leaves them as they were."""
    needs_card()
    det, cloud = table_detector()
    first = det.detect(cloud, generator=seeded(0), verbose=False)
    kept = first.to_host()
    second = det.detect(cloud, generator=seeded(5), verbose=False)
    again = first.to_host()
    for name in ("position", "score", "valid"):
        np.testing.assert_array_equal(getattr(kept, name),
                                      getattr(again, name))
    assert not np.array_equal(kept.position, second.to_host().position)


@pytest.mark.cuda
def test_replay_runs_the_captured_launches():
    """The capture of A records its one hand_search launch and its one
    radius_moments launch (the frames), B's its raster_images launches
    (one per live chunk), C's none. A replay calls no wrapper, and a
    profiler trace of it shows the card running the recorded launches (the
    images kernel's name holds raster_blocks)."""
    needs_card()
    det, cloud = table_detector()
    det.detect(cloud, generator=seeded(0), verbose=False)
    a, b, c = (det.graphs[k] for k in det.last_graphs)
    chunks = det.last_graphs[1][-2] // det.image_cap(1000)
    assert a.launches == {"hand_search": 1, "radius_moments": 1}
    assert c.launches == {}
    assert b.launches == {"raster_images": chunks} and chunks >= 1
    before = _build.LAUNCHES.copy()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        det.detect(cloud, generator=seeded(0), verbose=False)
    assert _build.LAUNCHES == before
    for name, n in (("raster_blocks", chunks), ("hand_search", 1),
                    ("radius_moments_kernel", 1)):
        ran = [e for e in prof.events() if name in e.name
               and e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ran) == n, name


@pytest.mark.cuda
def test_keys_in_one_pool_keep_their_results():
    """Two keys captured into the detector's one pool, replayed in turns
    (A, B, A, B): each request finds the candidate count that the same key
    found on the same seed before the other key's replay, and >= 90% of
    its selection by position (1e-5; the rasters' float atomics make
    images not bit-repeatable)."""
    needs_card()
    det, cloud = table_detector()
    _, bigger = table_detector(capacity=2 * cloud.capacity)
    seen = []
    for c in (cloud, bigger, cloud, bigger):
        out = det.detect(c, generator=seeded(6), verbose=False).to_host()
        seen.append((det.last_counts["candidates"], out))
    assert det.pool is not None
    assert len({k[1:8] for k in detect_keys(det)}) == 2
    for (n, out), (n2, out2) in zip(seen[:2], seen[2:]):
        assert n == n2 > 0
        pa, pb = out.position[out.valid], out2.position[out2.valid]
        near = np.abs(pa[:, None] - pb[None]).max(-1) <= 1e-5
        assert near.any(1).mean() >= 0.9


@pytest.mark.cuda
def test_graphs_keep_the_eager_counts_and_draws():
    """The replayed graphs and the eager route on one generator seed: the
    same counts, and the generator left at the same state."""
    needs_card()
    det, cloud = table_detector()
    g_graph, g_eager = seeded(4), seeded(4)
    det.detect(cloud, generator=seeded(4), verbose=False)     # captures
    det.detect(cloud, generator=g_graph, verbose=False)
    counts = det.last_counts
    det._force_eager = True
    det.detect(cloud, generator=g_eager, verbose=False)
    assert counts == det.last_counts and counts["candidates"] > 0
    assert torch.equal(g_graph.get_state(), g_eager.get_state())


@pytest.mark.cuda
def test_generator_on_another_device_raises():
    """detect's programs draw on the card: a CPU generator is refused, not
    silently replaced."""
    needs_card()
    det, cloud = table_detector()
    with pytest.raises(ValueError, match="draw on"):
        det.detect(cloud, generator=torch.Generator().manual_seed(0),
                   verbose=False)


@pytest.mark.cuda
def test_swapped_nets_score_as_a_fresh_detector():
    """det.net swapped to three nets made from the same parameters, each
    freed by the next swap, then back to the first, with garbage
    collected: a request scores as a fresh detector's on the same seed
    (1e-5), and the graphs held only ever hold the current net."""
    needs_card()
    det, cloud = table_detector()
    first = det.net
    params = lenet.params_to_numpy(first)
    det.detect(cloud, generator=seeded(0), verbose=False)
    for _ in range(3):
        det.net = lenet.params_from_numpy(params, "cuda")
        det.detect(cloud, generator=seeded(0), verbose=False)
        assert {k[4] for k in detect_keys(det)} == {id(det.net)}
    det.net = first
    gc.collect()
    out = det.detect(cloud, generator=seeded(0), verbose=False).to_host()
    fresh = tdet.GraspDetector(DetectorConfig(), device="cuda").detect(
        cloud, generator=seeded(0), verbose=False).to_host()
    np.testing.assert_array_equal(out.valid, fresh.valid)
    assert out.valid.any()
    np.testing.assert_allclose(out.score[out.valid], fresh.score[fresh.valid],
                               atol=1e-5)
    np.testing.assert_allclose(out.position[out.valid],
                               fresh.position[fresh.valid], atol=1e-5)


@pytest.mark.cuda
def test_api_second_call_captures_nothing():
    """Two detect_grasps_in_cloud calls with equal configs: one detector
    serves both, and the second call captures no graph."""
    needs_card()
    rng = np.random.default_rng(3)
    pts, nrm = syn.make_scene(rng, n_objects=2, points_per_object=1500,
                              table_points=1500, table_halfsize=0.15)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))
    first = api.detect_grasps_in_cloud(DetectorConfig(), p, view_points=vp,
                                       cam_source=cs)
    det = api._as_detector(DetectorConfig(), None)
    n = len(det.graphs)
    second = api.detect_grasps_in_cloud(DetectorConfig(), p, view_points=vp,
                                        cam_source=cs)
    assert len(det.graphs) == n and det.last_graphs
    assert len(first) == len(second) > 0
