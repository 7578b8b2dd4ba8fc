"""gpd_tpu_torch.parallel (sharded detection, CEM ``mesh=``, data-parallel
training, process sharding) against gpd_tpu on the CPU.

gpd_tpu shards over the 8 virtual CPU devices of one process (conftest);
the port runs one process per device. So two rank processes join a gloo
group over a file store: this file run as a script is the rank worker,
which imports torch, numpy and gpd_tpu_torch only (never JAX: a fresh
interpreter's JAX may pick another platform than the CPU that
tests/conftest.py forces). The pytest side
computes gpd_tpu's results and the port's one-process and one-rank runs,
while the two ranks run, and the tests hold them against each other:

  - sharded detection (the cylinder and small config of
    tests/test_sharding.py): the same valid geometry (position,
    orientation, width; 1e-5) as the port's detect_core and gpd_tpu's
    8-device detect_sharded_raw, the same merged batch on both ranks, and
    through the detector's programs (``owner=``) the eager route's;
  - sharded CEM (tests/test_cem.py's cylinder) with gpd_tpu's draws
    replayed through ops/draws.py: per-round counts and candidates equal to
    the one-rank port's and gpd_tpu's mesh=default_mesh(2) run, mixture
    centers in gpd_tpu's slot layout, and the same selection (positions
    1e-5, scores 1e-3: 3 channels, whose images are float32 in both);
  - one DDP step: gradients within 1e-6 of each tensor's largest entry of a
    one-process step on the whole batch, then the parameters; the loss
    within 1e-5 of gpd_tpu's sharded train_step;
  - tests/test_multihost.py's checks: initialize, process_info, shard_work,
    merged survivor counts, and two-shard data generation.

Usage (as the tests run it):
    python tests/test_torch_parallel.py STORE_DIR RANK WORLD REPLAY_NPZ OUT_DIR
"""

import json
import os
import subprocess
import sys
import unittest.mock as mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gpd_tpu_torch import cem as tcem
from gpd_tpu_torch.config import CEMConfig, DetectorConfig, ImageGeometry
from gpd_tpu_torch.core.types import CloudArrays
from gpd_tpu_torch.detector import GraspDetector, detect_core
from gpd_tpu_torch.net import lenet, train
from gpd_tpu_torch.ops import draws
from gpd_tpu_torch.parallel import multihost, sharded
from test_torch_threads import set_cpu_share, share_env

set_cpu_share()

if __name__ != "__main__":       # the pytest side; the rank workers import
    import jax                   # no JAX
    import jax.numpy as jnp
    import gpd_tpu.cem as jcem
    from gpd_tpu.config import CEMConfig as JCEMConfig
    from gpd_tpu.config import DetectorConfig as JConfig
    from gpd_tpu.config import ImageGeometry as JImageGeometry
    from gpd_tpu.core.types import CloudArrays as JCloud
    from gpd_tpu.detector import GraspDetector as JDetector
    from gpd_tpu.net import lenet as jlenet
    from gpd_tpu.net import train as jtrain
    from gpd_tpu.parallel import multihost as jmultihost
    from gpd_tpu.parallel import sharded as jsharded
    from jax.sharding import NamedSharding, PartitionSpec as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
# tests/test_sharding.py's small config, and tests/test_cem.py:232's (at 3
# channels, whose images are float32 in both packages).
SHARD_KW = dict(num_samples=16, search_neighbors_cap=256,
                frame_neighbors_cap=32, normals_neighbors_cap=32,
                shadow_voxel_cap=256, min_inliers=0, num_selected=10)
CEM_DET_KW = dict(search_neighbors_cap=256, frame_neighbors_cap=32,
                  normals_neighbors_cap=32, shadow_voxel_cap=256,
                  min_inliers=0, num_selected=20)
# Odd sample counts, so two ranks pad every round.
CEM_KW = dict(num_init_samples=7, num_iterations=2,
              num_samples_per_iteration=13, sampling_method=1,
              min_score=-1e9)
GEOM = ("position", "orientation", "width")


def cylinder_cloud(n=1500, seed=1234):
    """tests/test_sharding.py's cylinder (its ``rng`` fixture's seed), with
    exact normals."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([0.03 * np.cos(theta), 0.03 * np.sin(theta),
                    rng.uniform(-0.05, 0.05, n)], 1).astype(np.float32)
    nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)],
                   1).astype(np.float32)
    return pts, nrm


def cem_detector():
    return GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=3), **CEM_DET_KW),
        device="cpu")


def gen0():
    return torch.Generator().manual_seed(0)


def host(g):
    """A Grasps batch as a dict of numpy arrays."""
    return {k: v for k, v in vars(g.to_host()).items()}


def replayed_cem(replay, record):
    """Patches the port's CEM draws with gpd_tpu's (``replay``): round 0's
    subsample and each round's positions, in call order; each round's
    mixture centers and mask and each round's gathered candidates go to
    ``record``."""
    positions = iter(replay["rounds"])
    record.update(centers=[], cmask=[], candidates=[])
    orig = sharded.candidates_sharded_raw

    def cem_round(gen, centers, cmask, *args):
        record["centers"].append(centers.numpy().copy())
        record["cmask"].append(cmask.numpy().copy())
        return torch.tensor(next(positions))

    def candidates(*args, **kwargs):
        g = orig(*args, **kwargs)
        record["candidates"].append(host(g))
        return g

    return [mock.patch.object(draws, "subsample", lambda gen, pool, n:
                              torch.tensor(replay["idx0"]).long()),
            mock.patch.object(draws, "cem_round", cem_round),
            mock.patch.object(sharded, "candidates_sharded_raw", candidates)]


def run_cem(mesh, replay):
    """The port's CEM on the cylinder with gpd_tpu's draws replayed: (final
    grasps, round counts, record)."""
    pts, nrm = cylinder_cloud()
    cloud = CloudArrays.from_numpy(pts, normals=nrm, device="cpu")
    sis = tcem.SequentialImportanceSampling(cem_detector(),
                                            CEMConfig(**CEM_KW), mesh=mesh)
    record = {}
    patches = replayed_cem(replay, record)
    for p in patches:
        p.start()
    try:
        out = sis.detect(cloud, generator=gen0(), verbose=False)
    finally:
        for p in reversed(patches):
            p.stop()
    return host(out), list(sis.last_round_counts), record


def ddp_step(net, x, y, mesh):
    """One train_step of ``net`` (wrapped in DistributedDataParallel with a
    mesh, this rank's contiguous slice of the batch): (loss, gradients,
    parameters after the step)."""
    model = net
    if mesh is not None:
        model = torch.nn.parallel.DistributedDataParallel(
            net, process_group=mesh.group)
        per = len(y) // mesh.size
        x, y = (a[mesh.rank * per:(mesh.rank + 1) * per] for a in (x, y))
    loss, _ = train.train_step(model, train.make_optimizer(net),
                               torch.from_numpy(x), torch.from_numpy(y))
    after = lenet.params_to_numpy(net)      # in net.parameters()' order
    grads = {k: p.grad.numpy().copy()
             for k, p in zip(after, net.parameters())}
    return float(loss), grads, after


class Blocks:
    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def blocks(self):
        yield self.images, self.labels


def training_data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 60, 60, 3)).astype(np.uint8),
            rng.integers(0, 2, n).astype(np.int32))


# ------------------------------------------------------------ rank worker

def worker(store, rank, world, replay_path, out_dir):
    """One rank of the two-process group: every part below is SPMD."""
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    rank, world = int(rank), int(world)
    device = multihost.initialize(f"file://{store}", world, rank,
                                  device="cpu")
    mesh = sharded.default_mesh()
    replay = dict(np.load(replay_path))
    res = {"rank": rank, "device": str(device),
           "process_info": list(multihost.process_info()),
           "backend": dist.get_backend()}
    arrays = {}
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    res["psum"] = float(t)

    # (a) Sharded detection: this rank's shard of the 16 samples.
    pts, nrm = cylinder_cloud()
    cloud = CloudArrays.from_numpy(pts, normals=nrm, device="cpu")
    det = GraspDetector(DetectorConfig(**SHARD_KW), device="cpu")
    spos, smask = torch.from_numpy(pts[:16]), torch.ones(16, dtype=torch.bool)
    s_l, m_l = sharded.shard_samples(mesh, spos, smask)
    g = sharded.detect_sharded_raw(
        sharded.replicate(mesh, cloud), s_l, m_l,
        sharded.replicate(mesh, det.net), gen0(), det.cfg,
        det.image_cap(s_l.shape[0]), mesh)
    arrays.update({"raw_" + k: v for k, v in host(g).items()})
    g = sharded.detect_sharded_raw(
        sharded.replicate(mesh, cloud), s_l, m_l, det.net, gen0(), det.cfg,
        det.image_cap(s_l.shape[0]), mesh, owner=det)
    arrays.update({"own_raw_" + k: v for k, v in host(g).items()})
    g = sharded.sharded_detect_host(det, cloud, spos, smask, gen0())
    arrays.update({"host_" + k: v for k, v in host(g).items()})
    det._force_eager = True
    g = sharded.sharded_detect_host(det, cloud, spos, smask, gen0())
    det._force_eager = False
    arrays.update({"eager_host_" + k: v for k, v in host(g).items()})
    # Rank 1 holds another cloud, of another capacity: rank 0's wins.
    mine_pts = pts if rank == 0 else pts[:700] + 1.0
    rep = sharded.replicate(mesh, CloudArrays.from_numpy(
        mine_pts, normals=nrm[:len(mine_pts)], device="cpu"))
    arrays.update({"rep_" + k: getattr(rep, k).numpy()
                   for k in ("points", "normals", "mask", "cam_source")})

    # (b) Survivors of each rank's shard_work slice, merged.
    mine = multihost.shard_work(list(range(16)))
    res["my_items"] = mine
    g, _ = detect_core(cloud, spos[mine], smask[mine], det.net, gen0(),
                       det.cfg, det.image_cap(len(mine)), scores_only=True)
    res["local_valid"] = int(g.valid.sum())
    res["merged_counts"] = sharded._gather(
        mesh, g.valid.sum()[None]).tolist()

    # (c) CEM over the group, gpd_tpu's draws replayed.
    out, counts, record = run_cem(mesh, {"idx0": replay["idx0"], "rounds": [
        replay[f"round{i}"] for i in range(CEM_KW["num_iterations"])]})
    res["cem_counts"] = counts
    arrays.update({"cem_" + k: v for k, v in out.items()})
    for i, (c, m) in enumerate(zip(record["centers"], record["cmask"])):
        arrays[f"cem_centers{i}"], arrays[f"cem_cmask{i}"] = c, m
    for i, cand in enumerate(record["candidates"]):
        arrays.update({f"cem_round{i}_{k}": cand[k] for k in
                       (*GEOM, "valid")})

    # (d) One DDP step from gpd_tpu's parameters, then fit and evaluate.
    params = {k[2:]: v for k, v in replay.items() if k.startswith("p_")}
    x, y = replay["x"], replay["y"].astype(np.int64)
    per = len(y) // world
    _, local, _ = ddp_step(lenet.params_from_numpy(params, "cpu"),
                           x[rank * per:(rank + 1) * per],
                           y[rank * per:(rank + 1) * per], None)
    arrays.update({"local_grad_" + k: v for k, v in local.items()})
    loss, grads, after = ddp_step(lenet.params_from_numpy(params, "cpu"), x,
                                  y, mesh)
    res["ddp_loss"] = loss
    arrays.update({"grad_" + k: v for k, v in grads.items()})
    arrays.update({"after_" + k: v for k, v in after.items()})
    x, y = training_data(256, 3)
    fitted = train.fit(Blocks(x[:192], y[:192]), None, 3, epochs=1,
                       batch_size=64, seed=0, device="cpu")
    arrays.update({"fit_" + k: v for k, v in fitted.items()})
    res["eval"] = list(train.evaluate(lenet.params_from_numpy(fitted, "cpu"),
                                      Blocks(x[192:], y[192:]), batch_size=40,
                                      mesh=mesh))

    # (e) Two-shard data generation: each rank passes its process_info.
    from gpd_tpu_torch import datagen
    pi, pc, _ = multihost.process_info()
    items = []
    for i, seed in enumerate((3, 4)):
        p, n = cylinder_cloud(1200, seed)
        view = CloudArrays.from_numpy(p[p[:, 0] > -0.01],
                                      normals=n[p[:, 0] > -0.01],
                                      device="cpu")
        items.append((f"obj_{i}", 0, view,
                      CloudArrays.from_numpy(p, normals=n, device="cpu")))
    gen = datagen.DataGenerator(
        GraspDetector(DetectorConfig(**SHARD_KW), device="cpu"),
        datagen.DataGenConfig(min_grasps_per_view=1, max_grasps_per_view=20,
                              test_views=()))
    shards = os.path.join(out_dir, "dgen")
    os.makedirs(shards, exist_ok=True)
    wtr = datagen.HDF5ShardWriter(os.path.join(shards, f"train_{pi}.h5"),
                                  60, 15)
    gen.generate(items, wtr, seed=5, process_index=pi, process_count=pc)
    res["dgen_rows"] = int(wtr.h5["labels"].shape[0])
    res["dgen_items"] = sorted(list(t) for t in wtr.done)
    wtr.close()
    res["dgen_merged_rows"] = sharded._gather(
        mesh, torch.tensor([res["dgen_rows"]])).tolist()

    res["foreign_modules"] = sorted(m for m in sys.modules if m.split(".")[0]
                                    in ("jax", "jaxlib", "gpd_tpu"))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


# ----------------------------------------------------------- pytest side

def valid_rows(g, prefix=""):
    """The valid (position, orientation, width) rows, sorted."""
    v = np.asarray(g[prefix + "valid"]).astype(bool)
    rows = np.concatenate([np.asarray(g[prefix + "position"])[v],
                           np.asarray(g[prefix + "orientation"])[v].reshape(
                               -1, 9),
                           np.asarray(g[prefix + "width"])[v, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def jax_host(g):
    return {k: np.asarray(v) for k, v in vars(g.to_host()).items()}


def gpd_tpu_cem():
    """gpd_tpu's CEM over mesh=default_mesh(2) on the cylinder, recording
    its draws (round 0's subsample, each round's positions and the mixture
    centers it drew them from) and each round's gathered candidates."""
    pts, nrm = cylinder_cloud()
    cloud = JCloud.from_numpy(pts, normals=nrm)
    det = JDetector(JConfig(image_geometry=JImageGeometry(num_channels=3),
                            **CEM_DET_KW))
    sis = jcem.SequentialImportanceSampling(
        det, JCEMConfig(**CEM_KW), mesh=jsharded.default_mesh(WORLD))
    key = jax.random.PRNGKey(0)
    k0, _ = jax.random.split(key)
    idx0 = np.asarray(jcem.pp.subsample_uniform(
        k0, cloud.mask, CEM_KW["num_init_samples"])[0])
    rec = {"centers": [], "cmask": [], "rounds": [], "candidates": []}
    draw, cands = jcem._draw_round, jsharded.candidates_sharded_raw

    def draw_round(*a):
        out = draw(*a)
        rec["centers"].append(np.asarray(a[1]))
        rec["cmask"].append(np.asarray(a[2]))
        rec["rounds"].append(np.asarray(out))
        return out

    def candidates(*a):
        g = cands(*a)
        rec["candidates"].append(jax_host(g))
        return g

    with mock.patch.object(jcem, "_draw_round", draw_round), \
            mock.patch.object(jsharded, "candidates_sharded_raw", candidates):
        out = sis.detect(cloud, key=key, verbose=False)
    return (jax_host(out), list(sis.last_round_counts), rec,
            {"idx0": idx0, "rounds": rec["rounds"]})


def one_rank(store, fn):
    """fn(mesh) in a one-process gloo group of this process."""
    multihost.initialize(f"file://{store}", 1, 0, device="cpu")
    try:
        return fn(sharded.default_mesh())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """gpd_tpu's side and the port's one-process side, computed while the
    two rank processes run; then the ranks' outputs."""
    tmp = tmp_path_factory.mktemp("parallel")
    out = {}
    out["jcem"], out["jcem_counts"], out["jcem_rec"], cem_replay = \
        gpd_tpu_cem()
    x = np.random.default_rng(5).integers(0, 256, (64, 60, 60, 15)).astype(
        np.uint8)
    y = np.random.default_rng(6).integers(0, 2, 64).astype(np.int32)
    params = {k: np.asarray(v) for k, v in jlenet.init_params(
        jax.random.PRNGKey(0), 15).items()}
    replay = str(tmp / "replay.npz")
    np.savez(replay, idx0=cem_replay["idx0"], x=x, y=y,
             **{f"round{i}": r for i, r in enumerate(cem_replay["rounds"])},
             **{"p_" + k: v for k, v in params.items()})
    env = share_env(dict(os.environ, OMP_NUM_THREADS="2",
                         PYTHONPATH=REPO + os.pathsep
                         + os.environ.get("PYTHONPATH", "")))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp / "store"),
         str(r), str(WORLD), replay, str(tmp)], env=env, cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        # gpd_tpu's 8-device sharded detection and the port's detect_core.
        pts, nrm = cylinder_cloud()
        jdet = JDetector(JConfig(**SHARD_KW))
        mesh = jsharded.default_mesh()
        spos, smask = jsharded.shard_samples(mesh, jnp.asarray(pts[:16]),
                                             jnp.ones(16, bool))
        out["j8"] = jax_host(jsharded.detect_sharded_raw(
            jsharded.replicate(mesh, JCloud.from_numpy(pts, normals=nrm)),
            spos, smask, jsharded.replicate(mesh, jdet.params),
            jax.random.PRNGKey(0), jdet.cfg, jdet.image_cap(2), mesh))
        det = GraspDetector(DetectorConfig(**SHARD_KW), device="cpu")
        g, _ = detect_core(CloudArrays.from_numpy(pts, normals=nrm,
                                                  device="cpu"),
                           torch.from_numpy(pts[:16]),
                           torch.ones(16, dtype=torch.bool), det.net, gen0(),
                           det.cfg, det.image_cap(16), scores_only=True)
        out["core"] = host(g)
        # The port's CEM on a one-rank group, the same draws replayed.
        out["cem1"], out["cem1_counts"], out["cem1_rec"] = one_rank(
            tmp / "store1", lambda m: run_cem(m, cem_replay))
        # One step on the whole batch: the port in one process, gpd_tpu's
        # sharded train_step over two devices.
        out["params"] = params
        out["step1"] = ddp_step(lenet.params_from_numpy(params, "cpu"), x,
                                y.astype(np.int64), None)
        jm = jsharded.default_mesh(WORLD)
        tx = jtrain.make_optimizer()
        jp = jax.device_put({k: jnp.asarray(v) for k, v in params.items()},
                            NamedSharding(jm, P()))
        sh = NamedSharding(jm, P("dp"))
        _, _, jloss, _ = jtrain.train_step(
            jp, jax.device_put(tx.init(jp), NamedSharding(jm, P())),
            jax.device_put(jnp.asarray(x), sh),
            jax.device_put(jnp.asarray(y), sh), tx)
        out["jloss"] = float(jloss)
        xf, yf = training_data(256, 3)
        out["fit1"] = train.fit(Blocks(xf[:192], yf[:192]), None, 3,
                                epochs=1, batch_size=64, seed=0, device="cpu")
        out["eval1"] = train.evaluate(
            lenet.params_from_numpy(out["fit1"], "cpu"),
            Blocks(xf[192:], yf[192:]), batch_size=40)
        logs = [p.communicate(timeout=300)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    out["ranks"] = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            res = json.load(f)
        res["arrays"] = dict(np.load(tmp / f"rank{r}.npz"))
        out["ranks"].append(res)
    return out


@pytest.mark.parametrize("n,pc", [(16, 2), (17, 3), (5, 8), (0, 2)])
def test_shard_work_matches_gpd_tpu(n, pc):
    items = list(range(n))
    for pi in range(pc):
        assert multihost.shard_work(items, pi, pc) == \
            jmultihost.shard_work(items, pi, pc)


@pytest.mark.parametrize("world,s", [(1, 16), (2, 16), (3, 16), (8, 13)])
def test_shard_samples_matches_gpd_tpu(world, s):
    """Rank r's rows are block r of gpd_tpu's padded, sharded sample axis:
    positions padded at 1e6, mask False."""
    pos = np.random.default_rng(s).normal(size=(s, 3)).astype(np.float32)
    mask = np.arange(s) % 5 != 1
    jpos, jmask = jsharded.shard_samples(jsharded.default_mesh(world),
                                         jnp.asarray(pos), jnp.asarray(mask))
    jpos, jmask = np.asarray(jpos), np.asarray(jmask)
    per = -(-s // world)
    for r in range(world):
        mesh = sharded.Mesh(None, r, world, None)
        tp, tm = sharded.shard_samples(mesh, torch.from_numpy(pos),
                                       torch.from_numpy(mask))
        assert tp.shape == (per, 3) and tm.dtype == torch.bool
        np.testing.assert_array_equal(tp.numpy(), jpos[r * per:(r + 1) * per])
        np.testing.assert_array_equal(tm.numpy(), jmask[r * per:(r + 1) * per])


def test_default_mesh_without_a_group_is_a_world_of_one():
    assert not dist.is_initialized()
    mesh = sharded.default_mesh()
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert multihost.process_info() == (0, 1, 1)
    with pytest.raises(ValueError, match="whole process group"):
        sharded.default_mesh(2)


def test_one_rank_detection_is_detect_core(tmp_path):
    """A one-process gloo group: the gathered batch is detect_core's own,
    field for field but the scores (a rank scores with its own generator,
    drawn from the caller's), and sharded_detect_host selects."""
    pts, nrm = cylinder_cloud()
    cloud = CloudArrays.from_numpy(pts, normals=nrm, device="cpu")
    det = GraspDetector(DetectorConfig(**SHARD_KW), device="cpu")
    spos, smask = torch.from_numpy(pts[:16]), torch.ones(16, dtype=torch.bool)

    def run(mesh):
        g = sharded.detect_sharded_raw(cloud, *sharded.shard_samples(
            mesh, spos, smask), det.net, gen0(), det.cfg, det.image_cap(16),
            mesh)
        return host(g), host(sharded.sharded_detect_host(det, cloud))
    raw, sel = one_rank(tmp_path / "store", run)
    core, _ = detect_core(cloud, spos, smask, det.net, gen0(), det.cfg,
                          det.image_cap(16), scores_only=True)
    for k, v in host(core).items():
        if k != "score":
            np.testing.assert_array_equal(raw[k], v, err_msg=k)
    assert raw["valid"].sum() > 0 and sel["valid"].sum() > 0
    assert np.isfinite(sel["score"][sel["valid"]]).all()


def test_fit_without_a_group_is_the_plain_loop():
    """data_parallel=True changes nothing without a process group."""
    x, y = training_data(128, 4)
    a = train.fit(Blocks(x, y), None, 3, epochs=1, batch_size=64, seed=1,
                  device="cpu")
    b = train.fit(Blocks(x, y), None, 3, epochs=1, batch_size=64, seed=1,
                  device="cpu", data_parallel=False)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_ranks_start_and_report(runs):
    """Each rank joined the gloo group on the CPU, reports one local device,
    saw both ranks in an all-reduce, and imported neither JAX nor
    gpd_tpu."""
    for r, res in enumerate(runs["ranks"]):
        assert res["foreign_modules"] == []
        assert res["process_info"] == [r, WORLD, 1]
        assert res["backend"] == "gloo" and res["device"] == "cpu"
        assert res["psum"] == pytest.approx(3.0)


def test_two_ranks_shard_work_disjoint_and_complete(runs):
    a, b = (set(res["my_items"]) for res in runs["ranks"])
    assert a.isdisjoint(b) and a | b == set(range(16))


def test_two_ranks_merged_survivor_counts(runs):
    r0, r1 = runs["ranks"]
    assert r0["merged_counts"] == r1["merged_counts"] == [
        r0["local_valid"], r1["local_valid"]]
    assert sum(r0["merged_counts"]) > 0


def test_two_ranks_detection_geometry(runs):
    """The merged batch holds detect_core's valid geometry and gpd_tpu's
    8-device detect_sharded_raw's (1e-5), in gpd_tpu's layout: rank-major
    blocks of the local hand search, sample_id local to the shard."""
    a = runs["ranks"][0]["arrays"]
    got = valid_rows(a, "raw_")
    assert got.shape == valid_rows(runs["core"]).shape and len(got) > 0
    np.testing.assert_allclose(got, valid_rows(runs["core"]), atol=1e-5)
    np.testing.assert_allclose(got, valid_rows(runs["j8"]), atol=1e-5)
    per = len(a["raw_valid"]) // WORLD
    assert a["raw_sample_id"][a["raw_valid"]].max() < 16 // WORLD
    sid = np.concatenate([a["raw_sample_id"][:per][a["raw_valid"][:per]],
                          a["raw_sample_id"][per:][a["raw_valid"][per:]]
                          + 16 // WORLD])
    np.testing.assert_allclose(
        a["raw_sample"][a["raw_valid"]], cylinder_cloud()[0][sid], atol=0)


def test_two_ranks_owner_route_is_the_eager_route(runs):
    """On both ranks, detect_sharded_raw through the detector's programs
    (owner=) and sharded_detect_host by them (its default) give the eager
    routes' merged batches: valid flags and sample ids equal, geometry
    1e-6, scores 1e-5."""
    for res in runs["ranks"]:
        a = res["arrays"]
        for ours, eager in (("own_raw_", "raw_"), ("host_", "eager_host_")):
            np.testing.assert_array_equal(a[ours + "valid"],
                                          a[eager + "valid"])
            np.testing.assert_array_equal(a[ours + "sample_id"],
                                          a[eager + "sample_id"])
            for k in GEOM:
                np.testing.assert_allclose(a[ours + k], a[eager + k],
                                           atol=1e-6, err_msg=ours + k)
            v = a[ours + "valid"]
            assert v.sum() > 0
            np.testing.assert_allclose(a[ours + "score"][v],
                                       a[eager + "score"][v], atol=1e-5)


def test_two_ranks_replicate_rank_0s_cloud(runs):
    """replicate hands every rank rank 0's cloud, shapes included, though
    rank 1 passed a smaller one."""
    pts, nrm = cylinder_cloud()
    want = CloudArrays.from_numpy(pts, normals=nrm, device="cpu")
    for res in runs["ranks"]:
        a = res["arrays"]
        for k in ("points", "normals", "mask", "cam_source"):
            np.testing.assert_array_equal(a["rep_" + k],
                                          getattr(want, k).numpy())
        assert a["rep_mask"].dtype == bool


def test_two_ranks_hold_the_same_results(runs):
    """Every rank gets the same merged batch, selection and CEM grasps."""
    a, b = (res["arrays"] for res in runs["ranks"])
    assert a.keys() == b.keys()
    for k in a:
        if k.startswith(("raw_", "host_", "cem_")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    v = a["host_valid"]
    assert v.sum() > 0 and np.isfinite(a["host_score"][v]).all()


def test_two_ranks_cem_rounds(runs):
    """Per-round candidate counts and geometry: the two-rank port, the
    one-rank port and gpd_tpu's mesh=default_mesh(2) run, on the same
    replayed draws."""
    r0 = runs["ranks"][0]
    assert r0["cem_counts"] == runs["cem1_counts"] == runs["jcem_counts"]
    assert min(r0["cem_counts"]) > 0
    a = r0["arrays"]
    for i, jc in enumerate(runs["jcem_rec"]["candidates"]):
        ours = valid_rows(a, f"cem_round{i}_")
        np.testing.assert_allclose(ours, valid_rows(jc), atol=1e-5)
        np.testing.assert_allclose(
            ours, valid_rows(runs["cem1_rec"]["candidates"][i]), atol=1e-5)


def test_two_ranks_cem_centers_in_gpd_tpu_layout(runs):
    """The mixture centers each round draws from, slot for slot: every
    round's slots padded to a multiple of the mesh (7 -> 8 and 13 -> 14
    samples), rank-major, as gpd_tpu's buffer (MAX_OF_GAUSSIANS picks
    centers by slot)."""
    a = runs["ranks"][0]["arrays"]
    jrec = runs["jcem_rec"]
    cfg = DetectorConfig()
    M = cfg.num_orientations * len(cfg.hand_axes)
    assert len(jrec["cmask"][0]) == (8 + 2 * 14) * M
    for i, (jc, jm) in enumerate(zip(jrec["centers"], jrec["cmask"])):
        np.testing.assert_array_equal(a[f"cem_cmask{i}"], jm)
        np.testing.assert_allclose(a[f"cem_centers{i}"][jm], jc[jm],
                                   atol=1e-5)
    # The one-rank buffer has no padded slots: the same valid centers.
    one = runs["cem1_rec"]
    assert len(one["cmask"][0]) == (7 + 2 * 13) * M
    for i in range(len(jrec["cmask"])):
        np.testing.assert_allclose(
            np.sort(one["centers"][i][one["cmask"][i]], axis=0),
            np.sort(a[f"cem_centers{i}"][a[f"cem_cmask{i}"]], axis=0),
            atol=1e-5)


def test_two_ranks_cem_selection(runs):
    """The final grasps: the same set as gpd_tpu's and the one-rank port's
    (positions and orientations 1e-5, scores 1e-3), orthonormal, near the
    cylinder."""
    ours = runs["ranks"][0]["arrays"]
    ours = {k[4:]: v for k, v in ours.items() if k.startswith("cem_")}
    for other in (runs["jcem"], runs["cem1"]):
        vo, vt = other["valid"], ours["valid"]
        assert vo.sum() == vt.sum() > 0
        oo, ot = (np.lexsort(g["position"][v].T)
                  for g, v in ((other, vo), (ours, vt)))
        for k, tol in (("position", 1e-5), ("orientation", 1e-5),
                       ("score", 1e-3)):
            np.testing.assert_allclose(ours[k][vt][ot], other[k][vo][oo],
                                       atol=tol, err_msg=k)
    R = ours["orientation"][ours["valid"]]
    assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() < 1e-3
    assert (np.linalg.norm(ours["position"][ours["valid"]], axis=1)
            < 0.3).all()


def test_two_ranks_ddp_gradients(runs):
    """A two-rank DDP step's gradients are the mean of the ranks' own
    gradients on their halves, within 1e-6 of each tensor's largest entry,
    and the same on both ranks. Against the one-process step on the whole
    batch they agree within 1e-4 of the largest entry (the level of
    tests/test_torch_train.py against gpd_tpu): float32 sums over other
    batch splits and thread counts, and a ReLU or max-pool decision at
    rounding level moves one entry by up to 1.1e-4 of conv1's largest
    (measured)."""
    ranks = [res["arrays"] for res in runs["ranks"]]
    _, whole, _ = runs["step1"]
    for k, g in whole.items():
        ours = ranks[0]["grad_" + k]
        mean = (ranks[0]["local_grad_" + k] + ranks[1]["local_grad_" + k]) / 2
        scale = np.abs(mean).max()
        np.testing.assert_allclose(ours, mean, rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
        np.testing.assert_array_equal(ours, ranks[1]["grad_" + k])
        np.testing.assert_allclose(ours, g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


def test_two_ranks_ddp_parameters(runs):
    """The step is Adam's on the averaged gradients: the parameters equal
    one process's optimizer fed the DDP gradients (1e-6), on both ranks.
    Against the whole-batch step, Adam's first update lr * g / (|g| + eps)
    is lr * sign(g): equal wherever the gradient stands above the 1e-4 the
    two may differ by, and within 2 lr elsewhere."""
    a = runs["ranks"][0]["arrays"]
    _, grads, after = runs["step1"]
    net = lenet.params_from_numpy(runs["params"], "cpu")
    for k, p in zip(after, net.parameters()):
        p.grad = torch.from_numpy(a["grad_" + k])
    train.make_optimizer(net).step()
    fed = lenet.params_to_numpy(net)
    for k, p in after.items():
        ours = a["after_" + k]
        np.testing.assert_allclose(ours, fed[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_array_equal(
            ours, runs["ranks"][1]["arrays"]["after_" + k])
        sure = np.abs(grads[k]) > 2e-4 * np.abs(grads[k]).max()
        assert sure.any(), k
        np.testing.assert_allclose(ours[sure], p[sure], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert np.abs(ours - p).max() <= 2e-3 + 1e-6, k


def test_two_ranks_ddp_loss_matches_gpd_tpu(runs):
    """The mean of the ranks' losses (equal halves) is the whole batch's:
    the one-process step's and gpd_tpu's sharded train_step's (1e-5)."""
    loss = np.mean([res["ddp_loss"] for res in runs["ranks"]])
    assert abs(loss - runs["step1"][0]) < 1e-5
    assert abs(loss - runs["jloss"]) < 1e-5


def test_two_ranks_fit_and_evaluate(runs):
    """fit over the group (three steps of 64, 32 rows a rank) lands where
    the one-process fit lands, up to Adam's sign flips at rounding noise;
    evaluate's all-reduced sums over 64 held-out rows in batches of 40 (20 a
    rank, the tail padded) equal one process's."""
    a = runs["ranks"][0]["arrays"]
    for k, p in runs["fit1"].items():
        ours = a["fit_" + k]
        close = np.abs(ours - p) <= 1e-6 + 1e-6 * np.abs(p)
        assert close.mean() > 0.99, k
        assert np.abs(ours - p).max() <= 3 * 2e-3, k
    for res in runs["ranks"]:
        loss, acc = res["eval"]
        loss1, acc1 = train.evaluate(
            lenet.params_from_numpy({k[4:]: v for k, v in
                                     res["arrays"].items()
                                     if k.startswith("fit_")}, "cpu"),
            Blocks(*[d[192:] for d in training_data(256, 3)]), batch_size=40)
        assert round(acc * 64) == round(acc1 * 64)
        assert abs(loss - loss1) < 1e-5


def test_two_ranks_datagen_shards(runs):
    """Each process generates its round-robin share of the work list into
    its own shard; the shards are disjoint and cover both items."""
    r0, r1 = runs["ranks"]
    a, b = ({tuple(t) for t in res["dgen_items"]} for res in runs["ranks"])
    assert a.isdisjoint(b) and a | b == {("obj_0", 0), ("obj_1", 0)}
    assert r0["dgen_merged_rows"] == r1["dgen_merged_rows"] == [
        r0["dgen_rows"], r1["dgen_rows"]]
    assert min(r0["dgen_merged_rows"]) > 0


if __name__ == "__main__":
    worker(*sys.argv[1:])
