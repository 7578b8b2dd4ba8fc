"""gpd_tpu_torch's data generation (datagen.py, apps/generate_data.py,
apps/label_grasps.py) against gpd_tpu's on the CPU.

generate_view runs both packages on the same clouds (a half-cylinder view,
the full cylinder as mesh, exact normals), with gpd_tpu's draws injected
through gpd_tpu_torch.ops.draws attempt by attempt (each attempt's key is
fold_in(key, attempt), as gpd_tpu/datagen.py:226 folds it); gpd_tpu's
Pallas raster runs in interpret mode. Labels must be equal, images within
the repo's gate. Small sizes throughout (16 samples, caps 256), as
tests/test_datagen.py keeps them.
"""

import json
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

import gpd_tpu.datagen as jgen  # noqa: E402
import gpd_tpu.detector as jdet  # noqa: E402
import gpd_tpu.ops.images as jimg  # noqa: E402
import gpd_tpu.ops.preprocess as jpp  # noqa: E402
from gpd_tpu.config import DetectorConfig as JConfig  # noqa: E402
from gpd_tpu.config import ImageGeometry as JImageGeometry  # noqa: E402
from gpd_tpu.core.types import CloudArrays as JCloud  # noqa: E402
from gpd_tpu.io.pcd import save_pcd  # noqa: E402
from gpd_tpu_torch import datagen  # noqa: E402
from gpd_tpu_torch import detector as tdet  # noqa: E402
from gpd_tpu_torch.apps import generate_data, label_grasps  # noqa: E402
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry  # noqa: E402
from gpd_tpu_torch.core.types import CloudArrays  # noqa: E402
from gpd_tpu_torch.io.pcd import load_cloud_file  # noqa: E402
from gpd_tpu_torch.ops import draws  # noqa: E402
from test_torch_detector import (  # noqa: E402
    _interpret, image_gate, jax_noise, p0_params)
from test_torch_threads import set_cpu_share  # noqa: E402

set_cpu_share()

SMALL = dict(num_samples=16, search_neighbors_cap=256, frame_neighbors_cap=32,
             normals_neighbors_cap=32, shadow_voxel_cap=256)


@pytest.mark.parametrize("max_count,n_pos,n_neg", [(500, 100, 30),
                                                   (40, 100, 100),
                                                   (10, 0, 7)])
def test_balance_instances_matches_gpd_tpu(max_count, n_pos, n_neg):
    pos, neg = np.arange(n_pos), np.arange(n_pos, n_pos + n_neg)
    ours = datagen.balance_instances(max_count, pos, neg,
                                     np.random.default_rng(3))
    theirs = jgen.balance_instances(max_count, pos, neg,
                                    np.random.default_rng(3))
    np.testing.assert_array_equal(ours, theirs)
    assert len(ours) == 2 * min(n_pos, n_neg, max_count)


def read_shard(path):
    with h5py.File(path, "r") as f:
        data = {k: (f[k][:], f[k].chunks, f[k].maxshape) for k in f}
    with open(path + ".journal") as f:
        return data, [json.loads(line) for line in f]


def writer_session(module, path, rng_seed):
    """Append, resume after a write past the journal, append, shuffle,
    append once more: the same steps through either package's writer."""
    rng = np.random.default_rng(rng_seed)
    imgs = rng.integers(0, 256, (12, 60, 60, 3)).astype(np.uint8)
    lbls = rng.integers(0, 2, 12).astype(np.uint8)
    w = module.HDF5ShardWriter(path, 60, 3, chunk_size=8)
    w.append("obj1", 0, imgs[:5], lbls[:5])
    w.append("obj1", 1, imgs[5:9], lbls[5:9])
    # A crash after the rows, before the journal line.
    w.h5["images"].resize(11, axis=0)
    w.h5["labels"].resize(11, axis=0)
    w.close()
    w = module.HDF5ShardWriter(path, 60, 3, chunk_size=8)
    done = [w.is_done("obj1", v) for v in range(3)]
    assert w.h5["labels"].shape[0] == 9
    w.append("obj2", 0, imgs[9:], lbls[9:])
    w.shuffle_in_place(seed=4, block=5)
    w.append("obj2", 1, imgs[:2], lbls[:2])
    w.close()
    return done


def test_shard_writer_files_match_gpd_tpu(tmp_path):
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    assert writer_session(datagen, ours, 1) == [True, True, False]
    assert writer_session(jgen, theirs, 1) == [True, True, False]
    (od, oj), (td, tj) = read_shard(ours), read_shard(theirs)
    assert oj == tj and len(oj) == 4
    assert set(od) == set(td) == {"images", "labels"}
    for k in od:
        assert od[k][1:] == td[k][1:]
        np.testing.assert_array_equal(od[k][0], td[k][0])
    assert len(od["labels"][0]) == 14


def test_shard_writer_recovers_an_unreadable_file(tmp_path):
    """A file cut before its HDF5 superblock is dropped with its journal,
    as gpd_tpu does, and the writer starts empty."""
    for module, name in ((datagen, "ours.h5"), (jgen, "theirs.h5")):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(b"\x89HDF\r\n")
        with open(path + ".journal", "w") as f:
            f.write(json.dumps({"obj": "o", "view": 0, "start": 0,
                                "end": 3}) + "\n")
        w = module.HDF5ShardWriter(path, 60, 3)
        assert not w.is_done("o", 0) and w.h5["labels"].shape[0] == 0
        w.close()


def cylinder_clouds(seed=1234):
    """A half-cylinder view and the full cylinder as mesh (r = 3 cm,
    exact normals), as host arrays."""
    rng = np.random.default_rng(seed)
    n = 2000

    def cyl(theta):
        pts = np.stack([0.03 * np.cos(theta), 0.03 * np.sin(theta),
                        rng.uniform(-0.05, 0.05, n)], 1).astype(np.float32)
        nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)],
                       1).astype(np.float32)
        return pts, nrm
    view = cyl(rng.uniform(-np.pi / 2, np.pi / 2, n))
    mesh = cyl(rng.uniform(0, 2 * np.pi, n))
    return view, mesh


def jax_draws(key):
    """The port's draws patched with gpd_tpu's for each attempt in call
    order: the subsample (fold_in(attempt key, 4)) and the shadow draws of
    attempt key fold_in(key, attempt)."""
    attempt = [0]

    def attempt_key():
        return jax.random.fold_in(key, attempt[0])

    def subsample(gen, pool, n):
        idx = jpp.subsample_uniform(jax.random.fold_in(attempt_key(), 4),
                                    jnp.asarray(pool.numpy()), n)[0]
        return torch.from_numpy(np.array(idx)).long()

    def shadow(gen, S, V, K, n_sp, v_cap, device):
        noise = jax_noise(attempt_key(), S, V, K, n_sp, v_cap)
        attempt[0] += 1
        return noise
    return (mock.patch.object(draws, "subsample", subsample),
            mock.patch.object(draws, "shadow_noise", shadow))


@pytest.mark.parametrize("min_pos,channels", [
    pytest.param(1, 15, id="1"), pytest.param(150, 15, id="150"),
    pytest.param(1, 12, id="1-12ch")])
def test_generate_view_matches_gpd_tpu(min_pos, channels):
    """One attempt (min 1 positive) and two (min 150, about 100 positives an
    attempt): the same labels in the same balanced, permuted order, images
    within the gate. At 12 channels (no shadows, so no shadow draws; one
    attempt) both packages take gpd_tpu's random-init weights."""
    (vp, vn), (mp, mn) = cylinder_clouds()
    gen_cfg = dict(min_grasps_per_view=min_pos, max_grasps_per_view=50)
    params = None if channels == 15 else p0_params(channels)
    jd = jdet.GraspDetector(JConfig(
        image_geometry=JImageGeometry(num_channels=channels), **SMALL),
        params=params)
    key = jax.random.PRNGKey(0)
    jax.clear_caches()
    try:
        with mock.patch.object(jimg, "_use_pallas", lambda: True), \
                mock.patch.object(jimg.pl, "pallas_call",
                                  _interpret(jimg.pl.pallas_call)):
            ji, jl = jgen.DataGenerator(jd, jgen.DataGenConfig(
                **gen_cfg)).generate_view(
                JCloud.from_numpy(vp, normals=vn),
                JCloud.from_numpy(mp, normals=mn), key,
                np.random.default_rng(5))
    finally:
        jax.clear_caches()
    td = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=channels), **SMALL),
        params=params, device="cpu")
    gen = datagen.DataGenerator(td, datagen.DataGenConfig(**gen_cfg))
    sub, shadow = jax_draws(key)
    with sub, shadow:
        ti, tl = gen.generate_view(
            CloudArrays.from_numpy(vp, normals=vn, device="cpu"),
            CloudArrays.from_numpy(mp, normals=mn, device="cpu"),
            torch.Generator(), np.random.default_rng(5))
    assert gen.last_counts["attempts"] == (1 if min_pos == 1 else 2)
    assert len(tl) > 0 and 2 * tl.sum() == len(tl)
    assert tl.dtype == jl.dtype and ti.shape[-1] == channels
    np.testing.assert_array_equal(tl, jl)
    image_gate(ji, ti)


def small_items(device="cpu"):
    (vp, vn), (mp, mn) = cylinder_clouds(6)
    view = CloudArrays.from_numpy(vp, normals=vn, device=device)
    mesh = CloudArrays.from_numpy(mp, normals=mn, device=device)
    return [("obj_a", 0, view, mesh), ("obj_a", 1, view, mesh)]


def test_two_generate_runs_are_bit_identical(tmp_path):
    """Per-(object, view) generators seeded from the crc32 salt: two runs
    over the same work list and seed write the same rows; another seed
    draws other samples."""
    det = tdet.GraspDetector(DetectorConfig(**SMALL), device="cpu")
    gen = datagen.DataGenerator(det, datagen.DataGenConfig(
        min_grasps_per_view=1, max_grasps_per_view=50, test_views=(1,)))
    outs = []
    for run, seed in enumerate((3, 3, 4)):
        tr, te = (str(tmp_path / f"{s}{run}.h5") for s in ("train", "test"))
        wtr, wte = (datagen.HDF5ShardWriter(p, 60, 15) for p in (tr, te))
        gen.generate(small_items(), wtr, wte, seed=seed)
        wtr.close()
        wte.close()
        outs.append([read_shard(p)[0] for p in (tr, te)])
    for split in range(2):
        for k in ("images", "labels"):
            np.testing.assert_array_equal(outs[0][split][k][0],
                                          outs[1][split][k][0])
        assert len(outs[0][split]["labels"][0]) > 0
    assert not np.array_equal(outs[0][0]["images"][0],
                              outs[2][0]["images"][0])
    a = datagen.view_generator(3, "obj_a", 0, "cpu")
    b = datagen.view_generator(3, "obj_a", 0, "cpu")
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


def test_generate_shards_the_work_list(tmp_path, capsys):
    """process_index / process_count take every other item, and a rerun
    resumes past the journaled items."""
    det = tdet.GraspDetector(DetectorConfig(**SMALL), device="cpu")
    gen = datagen.DataGenerator(det, datagen.DataGenConfig(
        min_grasps_per_view=1, max_grasps_per_view=20, test_views=()))
    path = str(tmp_path / "shard.h5")
    w = datagen.HDF5ShardWriter(path, 60, 15)
    gen.generate(small_items(), w, process_index=1, process_count=2,
                 total_items=2)
    assert w.is_done("obj_a", 1) and not w.is_done("obj_a", 0)
    gen.generate(small_items(), w, process_index=1, process_count=2)
    w.close()
    out = capsys.readouterr().out
    assert out.count("[obj_a:1]") == 1 and "ETA" in out


def rot(axis, deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])


def test_bigbird_roundtrip_matches_gpd_tpu(tmp_path):
    """A BigBIRD object directory written here (camera-frame view PCDs,
    poses and calibration HDF5s): the port's readers recover the table-frame
    cloud, and equal gpd_tpu's (transforms, points, camera sources and
    positions)."""
    obj, camera, ref = "mug_01", 1, 5
    angles = [0, 120]
    d = tmp_path / obj
    (d / "clouds").mkdir(parents=True)
    (d / "poses").mkdir()
    gt = np.random.default_rng(1).uniform(-0.05, 0.05, (200, 3)).astype(
        np.float32)
    T_cam_from_ref = np.eye(4, dtype=np.float32)
    T_cam_from_ref[:3, :3] = rot("x", 30)
    T_cam_from_ref[:3, 3] = [0.1, -0.2, 0.05]
    with h5py.File(d / "calibration.h5", "w") as f:
        f[f"H_NP{camera}_from_NP{ref}"] = T_cam_from_ref
    for angle in angles:
        T_table_from_ref = np.eye(4, dtype=np.float32)
        T_table_from_ref[:3, :3] = rot("z", angle)
        T_table_from_ref[:3, 3] = [0, 0, 0.7]
        with h5py.File(d / "poses" / f"NP{ref}_{angle}_pose.h5", "w") as f:
            f["H_table_from_reference_camera"] = T_table_from_ref
        Tinv = np.linalg.inv(T_table_from_ref @ np.linalg.inv(T_cam_from_ref))
        save_pcd(str(d / "clouds" / f"NP{camera}_{angle}.pcd"),
                 (gt @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32))
        np.testing.assert_array_equal(
            datagen.calculate_transform(str(tmp_path), obj, camera, angle,
                                        ref),
            jgen.calculate_transform(str(tmp_path), obj, camera, angle, ref))
    cloud = datagen.create_multiview_cloud(str(tmp_path), obj, camera, angles,
                                           ref, device="cpu")
    jc = jgen.create_multiview_cloud(str(tmp_path), obj, camera, angles, ref)
    m = cloud.mask.numpy()
    pts = cloud.points.numpy()[m]
    assert pts.shape == (400, 3)
    np.testing.assert_allclose(pts[:200], gt, atol=1e-4)
    np.testing.assert_allclose(pts[200:], gt, atol=1e-4)
    np.testing.assert_array_equal(cloud.points.numpy(), np.asarray(jc.points))
    np.testing.assert_array_equal(m, np.asarray(jc.mask))
    np.testing.assert_array_equal(cloud.cam_source.numpy(),
                                  np.asarray(jc.cam_source).astype(np.int64))
    np.testing.assert_array_equal(cloud.view_points.numpy(),
                                  np.asarray(jc.view_points))
    with pytest.raises(ValueError, match="expected"):
        with h5py.File(d / "bad.h5", "w") as f:
            f["m"] = np.eye(3)
        datagen.read_pose_hdf5(str(d / "bad.h5"), "m")


def test_fuse_views_matches_gpd_tpu():
    rng = np.random.default_rng(2)
    clouds = [rng.normal(size=(n, 3)).astype(np.float32) for n in (50, 30)]
    T2 = np.eye(4)
    T2[:3, :3] = rot("z", 90)
    T2[:3, 3] = [1, 0, 0]
    for ours, theirs in zip(datagen.fuse_views(clouds, [np.eye(4), T2]),
                            jgen.fuse_views(clouds, [np.eye(4), T2])):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


GEN_CFG = """\
data_root = {root}
objects_file_location = {root}/objects.txt
output_root = {root}/out
num_views_per_object = 3
min_grasps_per_view = 1
max_grasps_per_view = 20
test_views = 1
num_samples = 16
search_neighbors_cap = 256
frame_neighbors_cap = 32
normals_neighbors_cap = 32
shadow_voxel_cap = 256
camera_position = 0 0 0
"""


def test_generate_data_and_label_grasps_clis(tmp_path, capsys):
    """generate_data over an object directory written here (views 0 and 1
    of one cylinder 40 cm from the camera at the origin, its seen half
    facing it; view 2 absent): train.h5 (shuffled) and test.h5 in the
    reference's layout, balanced. label_grasps on view 0 against the mesh
    prints the counts of the same computation run directly."""
    (vp, _), (mp, _) = cylinder_clouds(8)
    vp = vp * np.float32([-1, 1, 1]) + np.float32([0.4, 0, 0])
    mp = mp + np.float32([0.4, 0, 0])
    d = tmp_path / "cyl"
    d.mkdir()
    save_pcd(str(d / "gt_cloud.pcd"), mp)
    save_pcd(str(d / "view_00.pcd"), vp)
    save_pcd(str(d / "view_01.pcd"), vp[::2])
    (tmp_path / "objects.txt").write_text("cyl\n")
    cfg = tmp_path / "gen.cfg"
    cfg.write_text(GEN_CFG.format(root=tmp_path))
    assert generate_data.main([]) == -1
    assert generate_data.main([str(cfg)], device="cpu") == 0
    out = capsys.readouterr().out
    assert "Generating data for 1 objects, 3 views each." in out
    assert "[cyl:0]" in out and "[cyl:1]" in out
    for name, view in (("train.h5", 0), ("test.h5", 1)):
        data, journal = read_shard(str(tmp_path / "out" / name))
        assert [(r["obj"], r["view"]) for r in journal] == [("cyl", view)]
        images, labels = data["images"][0], data["labels"][0]
        assert images.shape[1:] == (60, 60, 15) and labels.shape[1] == 1
        assert 0 < len(labels) and 2 * labels.sum() == len(labels)

    assert label_grasps.main([str(cfg)]) == -1
    assert label_grasps.main([str(cfg), str(d / "view_00.pcd"),
                              str(d / "gt_cloud.pcd")], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    det = tdet.GraspDetector(str(cfg), device="cpu")
    cam = np.zeros((1, 3), np.float32)
    view = det.preprocess_cloud(load_cloud_file(str(d / "view_00.pcd")),
                                view_points=cam)
    mesh = det.preprocess_cloud(load_cloud_file(str(d / "gt_cloud.pcd")),
                                view_points=cam)
    gen = torch.Generator().manual_seed(0)
    spos, smask = det.sample_cloud(view, gen)
    grasps, _ = tdet.detect_core(view, spos, smask, det.net, gen, det.cfg,
                                 det.image_cap(spos.shape[0]))
    labels, _ = datagen.cand.reevaluate_hypotheses(mesh, grasps, det.cfg)
    n = int(grasps.valid.sum())
    assert n > 0
    assert f"Created {n} grasp candidates with images." in lines
    assert f"Ground-truth antipodal grasps: {int(labels.sum())}/{n}" in lines


LATTICE_CFG = """
image_num_channels = 3
voxelize = 0
normals_radius = 0.008
num_samples = 64
camera_position = {x} {y} {z}
"""


def write_pcd(path, pts):
    with open(path, "w") as f:
        f.write("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                f"COUNT 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\n"
                "DATA ascii\n")
        f.writelines(f"{x!r} {y!r} {z!r}\n" for x, y, z in pts.tolist())


def test_label_grasps_cli_matches_gpd_tpu(tmp_path, capsys):
    """label_grasps on the dyadic lattice tube, where both packages
    preprocess to the same normals (voxels off): the half camera 0 sees
    against the whole tube. With gpd_tpu's subsample injected, both apps
    print the same candidate and ground-truth counts. (No hand is
    antipodal here: one camera turns the far side's normals inward.)"""
    from gpd_tpu.apps import label_grasps as jlabel
    from test_torch_detector import lattice_shell
    pts, _, vp = lattice_shell()
    view, mesh = str(tmp_path / "view.pcd"), str(tmp_path / "mesh.pcd")
    write_pcd(view, pts[pts[:, 0] > -0.01])
    write_pcd(mesh, pts)
    cfg = tmp_path / "label.cfg"
    cfg.write_text(LATTICE_CFG.format(x=vp[0, 0], y=vp[0, 1], z=vp[0, 2]))
    assert jlabel.main([str(cfg), view, mesh]) == 0
    theirs = capsys.readouterr().out.splitlines()[-2:]
    sub, _ = jax_draws(jax.random.PRNGKey(0))
    with sub:
        assert label_grasps.main([str(cfg), view, mesh], device="cpu") == 0
    ours = capsys.readouterr().out.splitlines()[-2:]
    assert ours == theirs
    assert ours[0].startswith("Created ") and ours[0] != (
        "Created 0 grasp candidates with images.")
