"""gpd_tpu_torch.cem against gpd_tpu.cem on the CPU, and the CEM draws.

The draws (gpd_tpu_torch/ops/draws.py) come from a torch.Generator, so they
are held to the reference's distributions statistically, as
tests/test_cem.py holds gpd_tpu's, including the loop-until-accepted oracle
of drawSamplesFromMaxOfGaussians.

The whole CEM run is held against gpd_tpu's with every draw injected, in
call order: the round-0 subsample, each round's positions (gpd_tpu's
_draw_round on its key for that round, given the port's mixture centers)
and each round's shadow draws (keyed per round as gpd_tpu keys them,
cem.py:312-324). Both run on gpd_tpu's preprocessed cloud of thin rods with
no table and no caps, where every injected position has a well-conditioned
local frame (asserted; ROADMAP.md C). Round counts must be equal, and the
selected grasps the same set (positions 1e-5, scores 1e-3).
"""

import dataclasses
import json
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpd_tpu.cem as jcem
import gpd_tpu.detector as jdet
import gpd_tpu.ops.images as jimg
import gpd_tpu.ops.preprocess as jpp
from gpd_tpu.apps.cem_detect_grasps import main as jmain
from gpd_tpu.config import CEMConfig as JCEMConfig
from gpd_tpu.config import DetectorConfig as JConfig
from gpd_tpu.config import ImageGeometry as JImageGeometry
from gpd_tpu_torch import cem as tcem
from gpd_tpu_torch import profiling
from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.apps.cem_detect_grasps import main
from gpd_tpu_torch.config import CEMConfig, DetectorConfig, ImageGeometry
from gpd_tpu_torch.ops import draws
from test_torch_detector import (ROD_KW, T, _interpret,
                                 assert_same_selection, frame_gap_ok,
                                 jax_noise, lattice_shell, port_cloud,
                                 rods_only)
from test_torch_threads import set_cpu_share

set_cpu_share()


def gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------- the draws

def test_sum_of_gaussians():
    rng = np.random.default_rng(0)
    centers = torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32))
    mask = torch.arange(20) < 12
    s = draws.sum_of_gaussians(gen(0), centers, mask, 0.02, 4000).numpy()
    assert s.shape == (4000, 3)
    d = np.linalg.norm(s[:, None] - centers.numpy()[None], axis=-1)
    near = d.argmin(1)
    # Within a few sigma of a VALID center, each valid center about equally
    # often, and the offsets N(0, sigma^2) per axis.
    assert (d.min(1) < 0.02 * 5).all() and (near < 12).all()
    freq = np.bincount(near, minlength=12) / len(s)
    assert np.abs(freq - 1 / 12).max() < 0.025
    off = s - centers.numpy()[near]
    np.testing.assert_allclose(off.std(0), 0.02, rtol=0.06)
    np.testing.assert_allclose(off.mean(0), 0.0, atol=0.002)


def oracle_max_of_gaussians(rng, centers, sigma, n):
    """drawSamplesFromMaxOfGaussians (sequential_importance_sampling.cpp:
    203-237) transcribed: loop until n draws are accepted; accept a draw
    from center idx iff no other center is strictly closer. Returns
    (samples, n_proposals)."""
    out = np.empty((n, 3))
    j = proposals = 0
    while j < n:
        idx = rng.integers(0, len(centers))
        x = centers[idx] + rng.normal(0, sigma, 3)
        proposals += 1
        d2 = np.sum((x[None, :] - centers) ** 2, axis=1)
        if d2[idx] <= d2.min() + 1e-12:
            out[j] = x
            j += 1
    return out, proposals


@pytest.mark.parametrize("spread,sigma", [(1.0, 0.05), (0.02, 0.5)])
def test_max_of_gaussians_matches_reference_distribution(spread, sigma):
    """A high-acceptance regime (separated centers) and a low one, where
    the fill engages: the distance-to-nearest-center histograms of the
    oracle and of the port agree (total variation < 0.1); in the high
    regime every draw is accepted, so the batched acceptance rate is the
    oracle's."""
    rng = np.random.default_rng(1)
    centers = rng.normal(0, spread, size=(16, 3)).astype(np.float32)
    n = 1000
    want, proposals = oracle_max_of_gaussians(
        rng, centers.astype(np.float64), sigma, 2 * n)
    c = torch.from_numpy(centers)
    mask = torch.ones(16, dtype=torch.bool)
    got = np.concatenate([draws.max_of_gaussians(gen(7 + i), c, mask, sigma,
                                                 n).numpy()
                          for i in range(4)])
    assert got.shape == (4 * n, 3)

    def nearest_d(s):
        d = np.linalg.norm(s[:, None] - centers[None], axis=-1)
        return d.min(1) / sigma
    bins = np.linspace(0, 4, 11)
    h_w, _ = np.histogram(nearest_d(want), bins=bins)
    h_g, _ = np.histogram(nearest_d(got), bins=bins)
    tv = 0.5 * np.abs(h_w / len(want) - h_g / len(got)).sum()
    assert tv < 0.1, f"TV distance {tv:.3f}"
    if spread == 1.0:
        assert 2 * n / proposals > 0.95
        assert len(np.unique(got.round(7), axis=0)) == len(got)


def test_max_of_gaussians_fill_resamples_accepted():
    """Fewer than n of the 4n proposals accepted: every output row obeys
    the accept rule for its nearest center, and the shortfall repeats
    accepted rows instead of keeping rejected ones."""
    centers = np.zeros((32, 3), np.float32)
    centers[:, 0] = np.linspace(0, 0.31, 32)
    mask = torch.ones(32, dtype=torch.bool)
    s = draws.max_of_gaussians(gen(0), torch.from_numpy(centers), mask, 1.0,
                               500).numpy()
    assert len(np.unique(s.round(7), axis=0)) < len(s)
    # Centers masked out never generate or reject a draw.
    half = torch.arange(32) < 16
    s = draws.max_of_gaussians(gen(1), torch.from_numpy(centers), half, 0.01,
                               200).numpy()
    d2 = np.sum((s[:, None] - centers[None, :16]) ** 2, axis=-1)
    assert np.sqrt(d2.min(1)).max() < 0.01 * 6


def test_uniform_cloud_samples_inclusive_workspace():
    """Uniform over pool points inside the workspace, bounds included."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    pts[0] = (0.2, -0.2, 0.2)                   # on three bounds
    pool = torch.ones(500, dtype=torch.bool)
    pool[1] = False
    pts[1] = 0.0                                # inside, out of the pool
    ws = (-0.2, 0.2, -0.2, 0.2, -0.2, 0.2)
    s = draws.uniform_cloud_samples(gen(0), torch.from_numpy(pts), pool, ws,
                                    20000).numpy()
    inside = np.all(np.abs(pts) <= 0.2, axis=1) & pool.numpy()
    assert (np.abs(s) <= 0.2).all()
    rows = [np.flatnonzero((pts == r).all(1))[0] for r in s]
    freq = np.bincount(rows, minlength=500)
    assert set(np.flatnonzero(freq)) == set(np.flatnonzero(inside))
    expect = 20000 / inside.sum()
    assert freq[0] > 0.5 * expect and freq.max() < 2 * expect


def test_cem_round_gaussian_then_uniform():
    """One round: n_gauss mixture draws, then n_rand cloud points; with no
    valid center every mixture draw starts at slot 0, as gpd_tpu's
    jax.random.choice on an all-zero p does."""
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32))
    pool = torch.ones(300, dtype=torch.bool)
    centers = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    for method in (draws.SUM_OF_GAUSSIANS, draws.MAX_OF_GAUSSIANS):
        s = draws.cem_round(gen(method), centers, torch.arange(40) < 30, pts,
                            pool, 0.001, (-1, 1, -1, 1, -1, 1), method, 35,
                            15).numpy()
        assert s.shape == (50, 3)
        d = np.linalg.norm(s[:35, None] - centers.numpy()[None, :30], axis=-1)
        assert d.min(1).max() < 0.006
        assert np.isin(s[35:], pts.numpy()).all(1).all()
        s = draws.cem_round(gen(9), centers, torch.zeros(40, dtype=torch.bool),
                            pts, pool, 0.001, (-1, 1, -1, 1, -1, 1), method,
                            35, 15).numpy()
        assert np.linalg.norm(s[:35] - centers.numpy()[0], axis=1).max() < 0.006


def test_cem_config_from_file(tmp_path):
    path = tmp_path / "cem.cfg"
    path.write_text("num_init_samples = 40  # initial\nnum_iterations = 3\n"
                    "num_samples_per_iteration = 30\nprob_rand_samples = 0.2\n"
                    "standard_deviation = 0.015\nsampling_method = 1\n"
                    "min_score = -0.5\n")
    cem = CEMConfig.from_file(str(path))
    assert cem == CEMConfig(40, 3, 30, 0.2, 0.015, 1, -0.5)
    assert vars(cem) == vars(JCEMConfig.from_file(str(path)))
    empty = tmp_path / "empty.cfg"
    empty.write_text("# nothing\n")
    assert CEMConfig.from_file(str(empty)) == CEMConfig()
    assert vars(CEMConfig()) == vars(JCEMConfig())


# ----------------------------------------------------- CEM against gpd_tpu

def cem_keys(key, n_iter):
    """gpd_tpu's key sequence (cem.py:256-319): round 0's subsample key k0
    and scoring key kk, then each round's draw key kg and scoring key kd."""
    k0, key = jax.random.split(key)
    kk, key = jax.random.split(key)
    kgs, kds = [], []
    for _ in range(n_iter):
        kg, kd, key = jax.random.split(key, 3)
        kgs.append(kg)
        kds.append(kd)
    return k0, kk, kgs, kds


def inject_cem(jc, key, n_init, n_iter, drawn):
    """Patches the port's draws with gpd_tpu's for a CEM run on ``jc``:
    round 0's subsample, each round's positions (appended to ``drawn``) and
    each scoring pass's shadow draws, in call order."""
    k0, kk, kgs, kds = cem_keys(key, n_iter)
    idx0 = T(jpp.subsample_uniform(k0, jc.mask, n_init)[0]).long()
    noise_keys = iter([kk] + kds)

    def cem_round(gen, centers, cmask, points, pmask, sigma, ws, method,
                  n_gauss, n_rand):
        s = np.asarray(jcem._draw_round(
            kgs[len(drawn)], jnp.asarray(centers.numpy()),
            jnp.asarray(cmask.numpy()), jnp.asarray(points.numpy()),
            jnp.asarray(pmask.numpy()), jnp.float32(sigma), tuple(ws),
            method, n_gauss, n_rand))
        drawn.append(s)
        return T(s)

    patches = [mock.patch.object(draws, "subsample",
                                 lambda gen, pool, n: idx0),
               mock.patch.object(draws, "cem_round", cem_round),
               mock.patch.object(draws, "shadow_noise",
                                 lambda gen, S, V, K, n_sp, v_cap, device:
                                 jax_noise(next(noise_keys), S, V, K, n_sp,
                                           v_cap))]
    return patches, np.asarray(jc.points)[np.asarray(idx0)]


def on_pallas_route():
    """gpd_tpu's bfloat16 image route with the Pallas rasters in interpret
    mode (as test_torch_detector.jax_detect runs it)."""
    return [mock.patch.object(jimg, "_use_pallas", lambda: True),
            mock.patch.object(jimg.pl, "pallas_call",
                              _interpret(jimg.pl.pallas_call))]


def run_patched(patches, fn):
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in reversed(patches):
            p.stop()


@pytest.mark.parametrize("channels,method", [
    (15, jcem.SUM_OF_GAUSSIANS), (3, jcem.MAX_OF_GAUSSIANS)])
def test_cem_selects_the_same_grasps(channels, method):
    p, cs, vp = rods_only(4)
    kw = dict(image_geometry=None, num_samples=16, image_neighbors_cap=256,
              num_selected=12, **ROD_KW)
    cem_kw = dict(num_init_samples=24, num_iterations=2,
                  num_samples_per_iteration=20, standard_deviation=0.004,
                  sampling_method=method, min_score=-1e9)
    jd = jdet.GraspDetector(JConfig(**{
        **kw, "image_geometry": JImageGeometry(num_channels=channels)}))
    td = tdet.GraspDetector(DetectorConfig(**{
        **kw, "image_geometry": ImageGeometry(num_channels=channels)}),
        device="cpu")
    jc = jd.preprocess_cloud(p, view_points=vp, cam_source=cs)
    tc = port_cloud(jc)
    key = jax.random.PRNGKey(21)

    jax.clear_caches()
    try:
        jsis = jcem.SequentialImportanceSampling(jd, JCEMConfig(**cem_kw))
        gj = run_patched(on_pallas_route(), lambda: jsis.detect(
            jc, key=key, verbose=False)).to_host()
    finally:
        jax.clear_caches()

    drawn = []
    patches, init_pos = inject_cem(jc, key, cem_kw["num_init_samples"],
                                   cem_kw["num_iterations"], drawn)
    tsis = tcem.SequentialImportanceSampling(td, CEMConfig(**cem_kw))
    gt = run_patched(patches, lambda: tsis.detect(tc, verbose=False)).to_host()

    assert len(drawn) == cem_kw["num_iterations"]
    positions = np.concatenate([init_pos, *drawn])
    assert frame_gap_ok(jc, positions, jd.cfg.nn_radius_frames).all()
    assert tsis.last_round_counts == list(jsis.last_round_counts)
    assert min(tsis.last_round_counts) > 0
    assert tsis.last_num_grasps == jsis.last_num_grasps
    assert_same_selection(gj, gt)


def test_cem_prints_the_four_kinds_of_line(capsys):
    """detect's report and its stats, on the port's own draws."""
    p, cs, vp = rods_only(5)
    det = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=3), num_selected=8,
        **ROD_KW), device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    sis = tcem.SequentialImportanceSampling(det, CEMConfig(
        num_init_samples=12, num_iterations=3, num_samples_per_iteration=10,
        sampling_method=draws.MAX_OF_GAUSSIANS))
    capsys.readouterr()             # the detector's weights NOTE
    out = sis.detect(cloud, generator=gen(0))
    lines = capsys.readouterr().out.splitlines()
    counts = sis.last_round_counts
    assert len(counts) == 4 and counts[0] > 0
    assert lines[0] == f"Initially detected grasp candidates: {counts[0]}"
    assert lines[1:4] == [f"Added {c} grasp candidates in round {i}."
                          for i, c in enumerate(counts[1:])]
    assert lines[4] == f"Final result: found {sis.last_num_grasps} grasps."
    assert lines[5].startswith("Total runtime: ") and sis.last_runtime_s > 0
    assert int(out.valid.sum()) == sis.last_num_grasps > 0


LATTICE_CFG = """
image_num_channels = 3
voxelize = 0
normals_radius = 0.008
num_selected = 8
min_inliers = 0
camera_position = {x} {y} {z}
num_init_samples = 16
num_iterations = 2
num_samples_per_iteration = 12
standard_deviation = 0.003
nn_radius = 0.02
"""


def test_cli_against_gpd_tpu(tmp_path, capsys):
    """cem_detect_grasps on a written PCD of the dyadic lattice tube, where
    both packages preprocess to the same normals (voxels off): gpd_tpu's
    app and the port's with gpd_tpu's draws print the same round counts and
    find the same number of grasps."""
    assert main([], device="cpu") == -1
    assert "Usage" in capsys.readouterr().out
    pts, _, vp = lattice_shell()
    pts = pts[pts[:, 0] > -0.01]                # what camera 0 sees
    path = str(tmp_path / "tube.pcd")
    with open(path, "w") as f:
        f.write("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                f"COUNT 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\n"
                "DATA ascii\n")
        f.writelines(f"{x!r} {y!r} {z!r}\n" for x, y, z in pts.tolist())
    cfg = tmp_path / "cem.cfg"
    cfg.write_text(LATTICE_CFG.format(x=vp[0, 0], y=vp[0, 1], z=vp[0, 2]))

    jax.clear_caches()
    try:
        assert run_patched(on_pallas_route(),
                           lambda: jmain([str(cfg), path])) == 0
    finally:
        jax.clear_caches()
    theirs = capsys.readouterr().out.splitlines()

    jd = jdet.GraspDetector(str(cfg))
    jc = jd.preprocess_cloud(pts, view_points=vp[:1], capacity="serve")
    drawn = []
    patches, _ = inject_cem(jc, jax.random.PRNGKey(0), 16, 2, drawn)
    assert run_patched(patches, lambda: main([str(cfg), path],
                                             device="cpu")) == 0
    ours = capsys.readouterr().out.splitlines()
    assert len(drawn) == 2
    assert ours[-5:-1] == theirs[-5:-1]
    assert ours[-5].startswith("Initially detected grasp candidates: ")
    assert ours[-1].startswith("Total runtime: ")
    assert ours[-2] != "Final result: found 0 grasps."
    assert os.path.getsize(path) > 0


def test_cem_phases_are_profiler_spans(tmp_path):
    """A CEM request under profiling.maybe_trace: its three phases are
    spans of the trace, inside the request's cem_detect."""
    p, cs, vp = rods_only(5)
    det = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=3), **ROD_KW), device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    sis = tcem.SequentialImportanceSampling(det, CEMConfig(
        num_init_samples=8, num_iterations=1, num_samples_per_iteration=8))
    sis._force_loop = True          # the loop's phases; the program's span
    with profiling.maybe_trace(str(tmp_path)):
        sis.detect(cloud, generator=gen(1), verbose=False)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert {"cem_detect", "cem_rounds", "cem_scoring",
            "select_and_cluster"} <= set(names)


def test_cem_traces_itself_under_gpd_tpu_profile(tmp_path, monkeypatch):
    """With GPD_TPU_PROFILE set, a CEM request writes its own trace."""
    p, cs, vp = rods_only(5)
    det = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=3), **ROD_KW), device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    sis = tcem.SequentialImportanceSampling(det, CEMConfig(
        num_init_samples=8, num_iterations=1, num_samples_per_iteration=8))
    sis._force_loop = True
    monkeypatch.setenv("GPD_TPU_PROFILE", str(tmp_path))
    sis.detect(cloud, generator=gen(1), verbose=False)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "cem_scoring" in names


# ------------------------------------- the fused program against the loop

def rods_sis(channels, method):
    """A CPU CEM detector on the rods at the sizes of
    test_cem_selects_the_same_grasps, and its cloud."""
    p, cs, vp = rods_only(4)
    det = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels), num_samples=16,
        image_neighbors_cap=256, num_selected=12, **ROD_KW), device="cpu")
    cloud = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    return tcem.SequentialImportanceSampling(det, CEMConfig(
        num_init_samples=24, num_iterations=2, num_samples_per_iteration=20,
        standard_deviation=0.004, sampling_method=method,
        min_score=-1e9)), cloud


@pytest.mark.parametrize("channels,method", [
    (15, draws.SUM_OF_GAUSSIANS), (3, draws.MAX_OF_GAUSSIANS)])
def test_fused_program_equals_the_loop(channels, method):
    """One generator seed through the default route (the fused program)
    and through the loop (_force_loop): the tolerances of gpd_tpu's own
    fused-vs-loop test (tests/test_cem.py:149-177), and the generator left
    at the same state."""
    sis, cloud = rods_sis(channels, method)
    g_fused, g_loop = gen(3), gen(3)
    with mock.patch.object(tcem, "_cem_rounds",
                           wraps=tcem._cem_rounds) as rounds, \
            mock.patch.object(tcem, "_cem_scoring",
                              wraps=tcem._cem_scoring) as scoring:
        fused = sis.detect(cloud, generator=g_fused, verbose=False)
    assert rounds.call_count == scoring.call_count == 1
    counts, n_fused = sis.last_round_counts, sis.last_num_grasps
    scored, slots, stats = sis.last_scored, sis.last_round_slots, \
        sis.last_counts
    sis._force_loop = True
    loop = sis.detect(cloud, generator=g_loop, verbose=False)
    assert counts == sis.last_round_counts and min(counts) > 0
    assert n_fused == sis.last_num_grasps > 0
    # The scored batch both routes return: the same slots, every round's
    # valid hands among them, and the counters read from it.
    assert slots == sis.last_round_slots
    assert stats == sis.last_counts == {
        "live_hands": sum(counts), "image_slots": scored.capacity}
    np.testing.assert_array_equal(scored.valid.numpy(),
                                  sis.last_scored.valid.numpy())
    assert [int(scored.valid[a:a + n].sum()) for a, n in slots] == counts
    live = scored.valid.numpy()
    np.testing.assert_allclose(scored.score.numpy()[live],
                               sis.last_scored.score.numpy()[live],
                               atol=1e-5)
    vf, vl = fused.valid.numpy(), loop.valid.numpy()
    np.testing.assert_array_equal(vf, vl)
    np.testing.assert_allclose(fused.position.numpy()[vf],
                               loop.position.numpy()[vl], atol=1e-6)
    np.testing.assert_allclose(fused.score.numpy()[vf],
                               loop.score.numpy()[vl], atol=1e-5)
    assert torch.equal(g_fused.get_state(), g_loop.get_state())


def _no_host_read(*args, **kwargs):
    raise AssertionError("the CEM program read a tensor back to the host")


HOST_READS = ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
              "__bool__", "__index__")


@pytest.mark.parametrize("channels,method", [
    (15, draws.SUM_OF_GAUSSIANS), (3, draws.MAX_OF_GAUSSIANS)])
def test_program_reads_nothing_back(channels, method):
    """_cem_program runs through with every way of reading a tensor back to
    the host patched to raise: its control flow and shapes follow from its
    arguments alone, as a CUDA graph needs. The loop, which reads the
    valid count of every scoring pass, trips the same guard. 3 channels
    with MAX_OF_GAUSSIANS also run the plane removal's RANSAC."""
    sis, cloud = rods_sis(channels, method)
    sis.detector.cfg = dataclasses.replace(
        sis.detector.cfg, remove_plane_before_image_calculation=channels == 3)
    args = sis.program_args(cloud)
    patches = [mock.patch.object(torch.Tensor, name, _no_host_read)
               for name in HOST_READS]
    out, counts, scored, slots = run_patched(
        patches, lambda: tcem._cem_program(cloud, sis.detector.net, gen(0),
                                           *args))
    assert counts.shape == (3,) and int(counts.min()) > 0
    assert out.valid.any()
    assert [n for _, n in slots] == [24 * 8, 20 * 8, 20 * 8]
    assert scored.capacity == slots[-1][0] + 256
    with pytest.raises(AssertionError, match="read a tensor back"):
        run_patched(patches, lambda: sis._detect_loop(cloud, gen(0)))


def test_fused_request_is_one_profiler_span(tmp_path):
    """The fused route on the CPU is traced as one span, cem_program, in
    the request's cem_detect, holding R's and S's runs (cem_rounds,
    cem_scoring) as on a card, and no selection span of the loop's."""
    sis, cloud = rods_sis(3, draws.SUM_OF_GAUSSIANS)
    with profiling.maybe_trace(str(tmp_path)):
        sis.detect(cloud, generator=gen(1), verbose=False)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"cem_detect", "cem_program", "cem_rounds", "cem_scoring"} <= names
    assert "select_and_cluster" not in names
