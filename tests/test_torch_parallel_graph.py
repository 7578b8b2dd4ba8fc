"""The sharded functions and CEM's mesh loop as the detector's programs
(gpd_tpu_torch/parallel/sharded.py with ``owner=``, gpd_tpu_torch/cem.py),
and the data-parallel steps through ``net.train.StepGraphs``.

gpd_tpu jits every sharded function, so each rank's part is device
programs that read nothing back to the host. Given an owner, the port runs
each rank's part as the owner's programs: on its card CUDA graphs per key,
on the CPU the same programs eagerly. On the CPU, at
tests/test_sharding.py's cylinder and small config, these hold each owner
route to its eager body and to gpd_tpu, and every program to reading
nothing back. The tests marked ``cuda`` need a card and skip without one;
the module imports no JAX at its top (the CPU tests import gpd_tpu and
tests/test_torch_parallel.py inside), so on a machine with a card:

    python -m pytest tests/test_torch_parallel_graph.py -m cuda --noconftest

The two-rank checks of the owner route run in tests/test_torch_parallel.py's
rank worker.
"""

import unittest.mock as mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gpd_tpu_torch import cem as tcem
from gpd_tpu_torch.config import CEMConfig, DetectorConfig
from gpd_tpu_torch.core.types import CloudArrays
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.detector import GraspDetector
from gpd_tpu_torch.net import lenet, train
from gpd_tpu_torch.ops import _build
from gpd_tpu_torch.parallel import multihost, sharded
from test_torch_threads import set_cpu_share

set_cpu_share()

# A world of one without a process group: no collective runs.
ONE = sharded.Mesh(None, 0, 1, None)


def tp():
    """tests/test_torch_parallel.py, whose pytest side imports JAX."""
    import test_torch_parallel
    return test_torch_parallel


def gen0():
    return torch.Generator().manual_seed(0)


def shard_setup():
    """test_sharding.py's cylinder and small config on the CPU: (detector,
    cloud, the 16 samples)."""
    pts, nrm = tp().cylinder_cloud()
    det = GraspDetector(DetectorConfig(**tp().SHARD_KW), device="cpu")
    cloud = CloudArrays.from_numpy(pts, normals=nrm, device="cpu")
    return (det, cloud, torch.from_numpy(pts[:16]),
            torch.ones(16, dtype=torch.bool))


def assert_same_batch(a, b, score_tol=1e-5):
    """Equal valid flags and sample ids, geometry within 1e-6, scores of
    the valid hands within ``score_tol``."""
    a, b = tp().host(a), tp().host(b)
    np.testing.assert_array_equal(a["valid"], b["valid"])
    np.testing.assert_array_equal(a["sample_id"], b["sample_id"])
    for k in tp().GEOM:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    v = a["valid"]
    np.testing.assert_allclose(a["score"][v], b["score"][v], atol=score_tol)


def calls(det, which):
    """Each sharded function on one generator seed, through ``det`` as
    owner (``which`` "owner") or by its eager body: {name: Grasps}."""
    _, cloud, spos, smask = shard_setup()
    owner = det if which == "owner" else None
    cfg, cap = det.cfg, det.image_cap(16)
    raw = sharded.detect_sharded_raw(cloud, spos, smask, det.net, gen0(),
                                     cfg, cap, ONE, owner=owner)
    sel = sharded.sharded_detect(cloud, spos, smask, det.net, gen0(), cfg,
                                 cap, ONE, owner=owner)
    cand = sharded.candidates_sharded_raw(cloud, spos, smask, cfg, ONE,
                                          owner=owner)
    scored = sharded.score_sharded_raw(cloud, cand, spos, smask, det.net,
                                       gen0(), cfg, cap, ONE, owner=owner)
    return dict(raw=raw, sel=sel, cand=cand, scored=scored)


def test_owner_routes_are_the_eager_bodies_and_gpd_tpu():
    """Through the owner each sharded function gives what its eager body
    gives on the same seed (valid flags, geometry 1e-6, scores 1e-5), and
    detect_sharded_raw holds the valid geometry of gpd_tpu's 8-device
    detect_sharded_raw on the same samples (1e-5)."""
    import jax
    import jax.numpy as jnp
    from gpd_tpu.config import DetectorConfig as JConfig
    from gpd_tpu.core.types import CloudArrays as JCloud
    from gpd_tpu.detector import GraspDetector as JDetector
    from gpd_tpu.parallel import sharded as jsharded
    det = shard_setup()[0]
    owner, eager = calls(det, "owner"), calls(det, "eager")
    for name in owner:
        assert_same_batch(owner[name], eager[name])
    assert int(owner["raw"].valid.sum()) > 0
    assert int(owner["sel"].valid.sum()) > 0

    pts, nrm = tp().cylinder_cloud()
    jdet = JDetector(JConfig(**tp().SHARD_KW))
    mesh = jsharded.default_mesh()
    spos, smask = jsharded.shard_samples(mesh, jnp.asarray(pts[:16]),
                                         jnp.ones(16, bool))
    j8 = tp().jax_host(jsharded.detect_sharded_raw(
        jsharded.replicate(mesh, JCloud.from_numpy(pts, normals=nrm)),
        spos, smask, jsharded.replicate(mesh, jdet.params),
        jax.random.PRNGKey(0), jdet.cfg, jdet.image_cap(2), mesh))
    ours = tp().valid_rows(tp().host(owner["raw"]))
    assert ours.shape == tp().valid_rows(j8).shape
    np.testing.assert_allclose(ours, tp().valid_rows(j8), atol=1e-5)


def _no_host_read(*args, **kwargs):
    raise AssertionError("a program read a tensor back to the host")


def guarded(det):
    """``det.programs.run`` with every way of reading a tensor back to the
    host patched to raise while a program runs; the names of the programs
    run go to the returned list."""
    from test_torch_cem import HOST_READS
    run, names = det.programs.run, []

    def guarded_run(key, program, inputs=(), generator=None, **kw):
        names.append(key[0])

        def no_reads(*args):
            with mock.patch.multiple(torch.Tensor, **{
                    name: _no_host_read for name in HOST_READS}):
                return program(*args)
        return run(key, no_reads, inputs, generator, **kw)
    return mock.patch.object(det.programs, "run", guarded_run), names


def test_programs_read_nothing_back():
    """Every program the owner runs for the sharded functions and CEM's mesh
    loop (A, B, the sharded candidates and scores, the round draw, the
    selection) runs with every host read patched to raise; the loop reads
    its counts once, after the selection."""
    det, cloud, spos, smask = shard_setup()
    patch, names = guarded(det)
    with patch:
        sharded.sharded_detect(cloud, spos, smask, det.net, gen0(), det.cfg,
                               det.image_cap(16), ONE, owner=det)
        sis = tcem.SequentialImportanceSampling(det, CEMConfig(
            **tp().CEM_KW), mesh=ONE)
        with mock.patch.object(tcem, "_read_counts",
                               wraps=tcem._read_counts) as read:
            sis.detect(cloud, generator=gen0(), verbose=False)
    assert read.call_count == 1 and min(sis.last_round_counts) > 0
    n = 1 + CEMConfig(**tp().CEM_KW).num_iterations
    assert sorted(set(names)) == ["candidates", "cem_round", "score",
                                  "sharded_candidates", "sharded_score",
                                  "sharded_select"]
    assert names.count("sharded_candidates") == names.count(
        "sharded_score") == n
    assert names.count("cem_round") == n - 1
    # The guard holds: without an owner the scoring pass reads its counts.
    from test_torch_cem import HOST_READS
    cand = sharded.candidates_sharded_raw(cloud, spos, smask, det.cfg, ONE)
    with pytest.raises(AssertionError, match="read a tensor back"), \
            mock.patch.object(sharded, "rank_generator", lambda m, g: g), \
            mock.patch.multiple(torch.Tensor, **{
                name: _no_host_read for name in HOST_READS}):
        sharded.score_sharded_raw(cloud, cand, spos, smask, det.net, gen0(),
                                  det.cfg, det.image_cap(16), ONE)


@pytest.mark.parametrize("call", ["detect_sharded_raw", "sharded_detect",
                                  "score_sharded_raw", "image_cap"])
def test_another_net_or_chunk_is_refused(call):
    """An owner's programs score with owner.net and owner.image_cap: a graph
    keyed by another net would keep it alive past the owner's net setter."""
    det, cloud, spos, smask = shard_setup()
    other = lenet.params_from_numpy(lenet.params_to_numpy(det.net), "cpu")
    cap = det.image_cap(16)
    with pytest.raises(ValueError, match="owner"):
        if call == "score_sharded_raw":
            cand = sharded.candidates_sharded_raw(cloud, spos, smask,
                                                  det.cfg, ONE, owner=det)
            sharded.score_sharded_raw(cloud, cand, spos, smask, other,
                                      gen0(), det.cfg, cap, ONE, owner=det)
        elif call == "image_cap":
            sharded.detect_sharded_raw(cloud, spos, smask, det.net, gen0(),
                                       det.cfg, 2 * cap, ONE, owner=det)
        else:
            getattr(sharded, call)(cloud, spos, smask, other, gen0(),
                                   det.cfg, cap, ONE, owner=det)


def test_cem_mesh_loop_through_the_owner(tmp_path):
    """CEM with mesh= in a one-process gloo group, gpd_tpu's draws
    replayed: through the detector's programs (the default) and by the
    eager bodies (``_force_eager``) the same round counts, round candidates
    and selection, and gpd_tpu's mesh=default_mesh(2) run's (geometry 1e-5,
    scores 1e-3: 3 channels, float32 images in both)."""
    t = tp()
    jout, jcounts, jrec, replay = t.gpd_tpu_cem()
    pts, nrm = t.cylinder_cloud()
    cloud = CloudArrays.from_numpy(pts, normals=nrm, device="cpu")

    def run(mesh, eager):
        det = t.cem_detector()
        det._force_eager = eager
        sis = tcem.SequentialImportanceSampling(det, CEMConfig(**t.CEM_KW),
                                                mesh=mesh)
        record = {}
        with mock.patch.object(det.programs, "run",
                               wraps=det.programs.run) as programs:
            patches = t.replayed_cem(replay, record)
            out = run_patched(patches, lambda: sis.detect(
                cloud, generator=gen0(), verbose=False))
        return (t.host(out), list(sis.last_round_counts), record,
                programs.call_count)

    from test_torch_cem import run_patched
    owner, eager = t.one_rank(tmp_path / "store", lambda m: (
        run(m, False), run(m, True)))
    # Rounds 0-2's candidates and scores, two draws, the selection.
    assert (owner[3], eager[3]) == (9, 0)
    assert owner[1] == eager[1] == jcounts and min(jcounts) > 0
    for i, jc in enumerate(jrec["candidates"]):
        want = t.valid_rows(jc)
        for route in (owner, eager):
            np.testing.assert_allclose(
                t.valid_rows(route[2]["candidates"][i]), want, atol=1e-5)
    for other in (eager[0], jout):
        ours = owner[0]
        vo, vt = other["valid"], ours["valid"]
        assert vo.sum() == vt.sum() > 0
        oo, ot = (np.lexsort(g["position"][v].T)
                  for g, v in ((other, vo), (ours, vt)))
        for k, tol in (("position", 1e-5), ("orientation", 1e-5),
                       ("score", 1e-3)):
            np.testing.assert_allclose(ours[k][vt][ot], other[k][vo][oo],
                                       atol=tol, err_msg=k)


def test_data_parallel_steps_go_through_step_graphs(tmp_path):
    """In a one-process gloo group, fit's DDP steps and evaluate's mesh
    steps go through StepGraphs (eager on the CPU) and give the numbers of
    the same calls without a group."""
    x, y = tp().training_data(192, 3)
    data, held = tp().Blocks(x[:128], y[:128]), tp().Blocks(x[128:],
                                                             y[128:])
    plain = train.fit(data, None, 3, epochs=1, batch_size=64, seed=0,
                      device="cpu")
    want = train.evaluate(lenet.params_from_numpy(plain, "cpu"), held,
                          batch_size=40)

    def counted(name):
        return mock.patch.object(train.StepGraphs, name, autospec=True,
                                 side_effect=getattr(train.StepGraphs, name))

    def grouped(mesh):
        with counted("train_step") as ts, counted("eval_step") as es:
            fitted = train.fit(data, None, 3, epochs=1, batch_size=64,
                               seed=0, device="cpu")
            got = train.evaluate(lenet.params_from_numpy(fitted, "cpu"),
                                 held, batch_size=40, mesh=mesh)
        return fitted, got, ts.call_count, es.call_count
    fitted, got, n_train, n_eval = tp().one_rank(tmp_path / "store", grouped)
    assert (n_train, n_eval) == (2, 2)
    for k in plain:
        np.testing.assert_array_equal(fitted[k], plain[k], err_msg=k)
    assert got == want


# ------------------------------------------------------------ on the card

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sharded programs and DDP's "
                    "step are captured as CUDA graphs only there "
                    "(chip_smoke.py runs them)")


@pytest.fixture
def nccl_one(tmp_path):
    """A world of one: an NCCL group over a file store on this card."""
    needs_card()
    multihost.initialize(f"file://{tmp_path}/store", 1, 0)
    try:
        yield sharded.default_mesh()
    finally:
        dist.destroy_process_group()


def seeded(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def card_scene():
    """A card detector at the default widths with 200 samples and a small
    table scene (2 objects, 2 cameras)."""
    rng = np.random.default_rng(3)
    pts, nrm = syn.make_scene(rng, n_objects=2, points_per_object=1500,
                              table_points=1500, table_halfsize=0.15)
    p, cs, vp = syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))
    det = GraspDetector(DetectorConfig(num_samples=200), device="cuda")
    return det, det.preprocess_cloud(p, view_points=vp, cam_source=cs)


@pytest.mark.cuda
def test_one_capture_per_key_on_the_card(nccl_one):
    """The sharded calls and CEM's mesh loop capture their keys at the
    first call and nothing later; a replay calls no kernel wrapper."""
    det, cloud = card_scene()
    sis = tcem.SequentialImportanceSampling(det, CEMConfig(
        num_init_samples=24, num_iterations=2, num_samples_per_iteration=20),
        mesh=nccl_one)

    def one_pass(seed):
        sharded.sharded_detect_host(det, cloud, generator=seeded(seed),
                                    mesh=nccl_one)
        sis.detect(cloud, generator=seeded(seed), verbose=False)
    one_pass(0)
    names = sorted({k[0] for k in det.graphs})
    n = len(det.graphs)
    before = _build.LAUNCHES.copy()
    one_pass(1)
    assert len(det.graphs) == n and _build.LAUNCHES == before
    assert {"candidates", "score", "sharded_select", "sharded_candidates",
            "sharded_score", "cem_round"} <= set(names)


@pytest.mark.cuda
def test_round_outputs_survive_the_next_replay(nccl_one):
    """A sharded candidates batch and a round's draw are copies: the next
    replay of their keys leaves them as they were."""
    det, cloud = card_scene()
    cfg = det.effective_config(cloud)
    spos, smask = det.sample_cloud(cloud, seeded(0))
    first = sharded.candidates_sharded_raw(cloud, spos, smask, cfg,
                                           nccl_one, owner=det)
    kept = first.valid.clone(), first.position.clone()
    spos2, smask2 = det.sample_cloud(cloud, seeded(1))
    sharded.candidates_sharded_raw(cloud, spos2, smask2, cfg, nccl_one,
                                   owner=det)
    assert torch.equal(first.valid, kept[0])
    assert torch.equal(first.position, kept[1])
    centers = torch.where(first.valid[:, None], first.sample, 0.0)
    draw = [tcem._draw_round(seeded(s), centers, first.valid, cloud, 0.01,
                             tuple(cfg.workspace), tcem.SUM_OF_GAUSSIANS, 16,
                             4, det) for s in (0, 1)]
    again = tcem._draw_round(seeded(0), centers, first.valid, cloud, 0.01,
                             tuple(cfg.workspace), tcem.SUM_OF_GAUSSIANS, 16,
                             4, det)
    assert not torch.equal(draw[0], draw[1])
    assert torch.equal(draw[0], again)


@pytest.mark.cuda
def test_graph_ddp_steps_equal_eager_ddp_steps(nccl_one):
    """fit's data-parallel step through StepGraphs (DDP_EAGER_STEPS eager
    steps, then the captured step with its all-reduce) against eager DDP
    steps, 16 steps from one start under deterministic cuDNN: losses and
    parameters within 1e-6 of each tensor's largest entry."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (16 * 16, 60, 60, 15),
                                      dtype=np.uint8)).cuda()
    y = torch.from_numpy(rng.integers(0, 2, 16 * 16)).cuda()
    params = lenet.init_params(torch.Generator().manual_seed(0), 15)
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for route in ("graph", "eager"):
            net = lenet.params_from_numpy(params, "cuda")
            model = train.data_parallel_model(net, nccl_one)
            opt = train.make_optimizer(net)
            steps = train.StepGraphs("cuda")
            step = steps.train_step if route == "graph" else train.train_step
            losses = [float(step(model, opt, x[i:i + 16], y[i:i + 16])[0])
                      for i in range(0, len(y), 16)]
            out[route] = losses, lenet.params_to_numpy(net), steps
    finally:
        torch.backends.cudnn.deterministic = False
    assert len(out["graph"][2].graphs) == 1
    assert max(abs(a - b) for a, b in zip(out["graph"][0],
                                          out["eager"][0])) <= 1e-6
    for k, p in out["eager"][1].items():
        gap = np.abs(out["graph"][1][k] - p).max() / np.abs(p).max()
        assert gap <= 1e-6, k
