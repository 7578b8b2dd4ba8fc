"""The fused CEM program's CUDA graphs on the card, without JAX (marked
``cuda``; skips without a card). On a machine with a card:

    python -m pytest tests/test_torch_cem_graph.py -m cuda --noconftest

A CEM request on a card replays two captured graphs per static key, R (the
rounds) and S (the scoring and the selection), back to back
(``SequentialImportanceSampling.graphs``, gpd_tpu_torch/cem.py). These hold
the cache to one capture of each per key, a request to the two launches
with no host read between them and one after, the returned grasps to
copies that the next replay leaves alone, a replay to the launches its
captures recorded, the keys of one shared pool to their own results, and
the graphs to the loop's round counts, scored batch and generator state.
"""

import json

import numpy as np
import pytest
import torch

from gpd_tpu_torch import cem
from gpd_tpu_torch.config import CEMConfig, DetectorConfig
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.detector import GraspDetector
from gpd_tpu_torch.ops import _build
from test_torch_threads import set_cpu_share

set_cpu_share()

CEM_KW = dict(num_init_samples=24, num_iterations=2,
              num_samples_per_iteration=20)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CEM program is captured as a "
                    "CUDA graph only there (chip_smoke.py runs it)")


def scene_sis(capacity=None, **cem_kw):
    """A CEM detector on the card at the default widths and a small table
    scene (2 objects, 2 cameras), with few samples a round (CEM_KW, and
    ``cem_kw`` over it)."""
    rng = np.random.default_rng(3)
    pts, nrm = syn.make_scene(rng, n_objects=2, points_per_object=1500,
                              table_points=1500, table_halfsize=0.15)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))
    det = GraspDetector(DetectorConfig(), device="cuda")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs,
                                 capacity=capacity)
    return (cem.SequentialImportanceSampling(
        det, CEMConfig(**{**CEM_KW, **cem_kw})), cloud)


def seeded(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.cuda
def test_one_capture_per_key():
    """A second request of the same key captures nothing; a cloud of
    another capacity bucket is a new key."""
    needs_card()
    sis, cloud = scene_sis()
    sis.detect(cloud, generator=seeded(0), verbose=False)
    sis.detect(cloud, generator=seeded(1), verbose=False)
    assert [k[0] for k in sis.graphs] == ["cem_rounds", "cem_scoring"]
    _, bigger = scene_sis(capacity=2 * cloud.capacity)
    sis.detect(bigger, generator=seeded(0), verbose=False)
    assert len(sis.graphs) == 4
    sis.detect(bigger, generator=seeded(2), verbose=False)
    assert len(sis.graphs) == 4


@pytest.mark.cuda
def test_request_launches_two_graphs_then_reads(tmp_path):
    """A request of a seen key, traced: two graph launches (R, then S)
    with no copy or wait between them, and the one read (a copy to the
    host and its wait) after S's launch."""
    needs_card()
    sis, cloud = scene_sis()
    sis.detect(cloud, generator=seeded(0), verbose=False)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sis.detect(cloud, generator=seeded(1), verbose=False)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        calls = sorted((e["ts"], e["name"]) for e in json.load(f)[
            "traceEvents"] if e.get("ph") == "X"
            and e.get("cat") == "cuda_runtime")
    launches = [t for t, n in calls if n.startswith("cudaGraphLaunch")]
    assert len(launches) == 2 and len(sis.graphs) == 2
    reads = [t for t, n in calls
             if n.startswith(("cudaMemcpy", "cudaStreamSynchronize",
                              "cudaDeviceSynchronize"))]
    assert not [t for t in reads if launches[0] < t < launches[1]]
    assert [t for t in reads if t > launches[1]]


@pytest.mark.cuda
def test_returned_grasps_survive_the_next_request():
    """A request's grasps are copies: the next replay, on other draws,
    leaves them as they were."""
    needs_card()
    sis, cloud = scene_sis()
    first = sis.detect(cloud, generator=seeded(0), verbose=False)
    kept = first.to_host()
    second = sis.detect(cloud, generator=seeded(5), verbose=False)
    again = first.to_host()
    for name in ("position", "score", "valid"):
        np.testing.assert_array_equal(getattr(kept, name),
                                      getattr(again, name))
    assert not np.array_equal(kept.position, second.to_host().position)


@pytest.mark.cuda
def test_replay_runs_the_captured_launches():
    """The capture records each wrapper's launches into the graph: one
    raster_images launch per round at one chunk a round, one hand_search
    launch and one radius_moments launch (the frames) per round, none of
    the 3-channel kernels nor raster_blocks' sums alone. A replay calls no
    wrapper, and a profiler trace of it shows the card running the
    recorded launches (the images kernel's name holds raster_blocks)."""
    needs_card()
    sis, cloud = scene_sis()
    sis.detect(cloud, generator=seeded(0), verbose=False)
    r, s = sis.graphs.values()
    rounds = 1 + CEM_KW["num_iterations"]
    assert r.launches == {"hand_search": rounds, "radius_moments": rounds}
    assert s.launches == {"raster_images": rounds}
    before = _build.LAUNCHES.copy()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        sis.detect(cloud, generator=seeded(1), verbose=False)
    assert _build.LAUNCHES == before
    for name in ("raster_blocks", "hand_search", "radius_moments_kernel"):
        ran = [e for e in prof.events() if name in e.name
               and e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ran) == rounds, name


@pytest.mark.cuda
def test_keys_in_one_pool_keep_their_results():
    """Two keys captured into the SIS's one pool, replayed in turns (A, B,
    A, B): each request finds the round counts and grasp count that the
    same key found on the same seed before the other key's replay, and
    >= 90% of its selection by position (1e-5; the rasters' float atomics
    make images not bit-repeatable). Every scored candidate passes the
    prune (min_score -1e9), so the selections compared are not empty."""
    needs_card()
    sis, cloud = scene_sis(min_score=-1e9)
    _, bigger = scene_sis(capacity=2 * cloud.capacity)
    seen = []
    for c in (cloud, bigger, cloud, bigger):
        out = sis.detect(c, generator=seeded(6), verbose=False).to_host()
        seen.append((sis.last_round_counts, sis.last_num_grasps, out))
    assert len(sis.graphs) == 4 and sis.pool is not None
    for (rounds, n, out), (rounds2, n2, out2) in zip(seen[:2], seen[2:]):
        assert rounds == rounds2 and n == n2 > 0
        pa, pb = out.position[out.valid], out2.position[out2.valid]
        near = np.abs(pa[:, None] - pb[None]).max(-1) <= 1e-5
        assert near.any(1).mean() >= 0.9


@pytest.mark.cuda
def test_graph_keeps_the_loop_rounds_and_draws():
    """The replayed graphs and the loop on one generator seed: the same
    round counts and scored batch's valid slots, and the generator left at
    the same state."""
    needs_card()
    sis, cloud = scene_sis()
    g_fused, g_loop = seeded(4), seeded(4)
    sis.detect(cloud, generator=seeded(0), verbose=False)     # captures
    sis.detect(cloud, generator=g_fused, verbose=False)
    counts = sis.last_round_counts
    valid = sis.last_scored.valid.cpu().numpy()
    slots, stats = sis.last_round_slots, sis.last_counts
    sis._force_loop = True
    sis.detect(cloud, generator=g_loop, verbose=False)
    assert counts == sis.last_round_counts and min(counts) > 0
    assert torch.equal(g_fused.get_state(), g_loop.get_state())
    # The scored batch: the same slots valid, each round's hands at its
    # slots, the counters alike.
    np.testing.assert_array_equal(valid,
                                  sis.last_scored.valid.cpu().numpy())
    assert slots == sis.last_round_slots and stats == sis.last_counts
    assert [int(valid[a:a + n].sum()) for a, n in slots] == counts


@pytest.mark.cuda
def test_generator_on_another_device_raises():
    """The program draws on the card: a CPU generator is refused, not
    silently replaced."""
    needs_card()
    sis, cloud = scene_sis()
    with pytest.raises(ValueError, match="draws on"):
        sis.detect(cloud, generator=torch.Generator().manual_seed(0),
                   verbose=False)
