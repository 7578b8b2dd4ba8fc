"""gpd_tpu_torch's file entry points against gpd_tpu on the CPU: point-cloud
and normals files read by both packages (ascii PCD bodies by the port's
native parser and by NumPy), the grasp CSV written by both,
GraspDetector.detect_file, the detect_grasps CLI (with --staged) and the
generate_candidates CLI."""

import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpd_tpu.detector as jdet
import gpd_tpu.ops.preprocess as jpp
from gpd_tpu.apps.detect_grasps import main as jmain
from gpd_tpu.apps.generate_candidates import main as jgen
from gpd_tpu.core.types import Grasps as JGrasps
from gpd_tpu.core.types import write_grasps_csv as jwrite_grasps_csv
from gpd_tpu.io import pcd as jpcd
from gpd_tpu_torch.apps.detect_grasps import main
from gpd_tpu_torch.apps.generate_candidates import main as gen
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.core.types import Grasps, write_grasps_csv
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.detector import GraspDetector
from gpd_tpu_torch.io import pcd
from gpd_tpu_torch.ops import draws
from test_torch_detector import frame_gap_ok, lattice_shell
from test_torch_threads import set_cpu_share

set_cpu_share()


def cloud(seed, n=500):
    """Random points with one NaN row."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)
    pts[3] = np.nan
    return pts


def lzf_compress(data: bytes) -> bytes:
    """A small valid LZF encoder: literal runs, and runs of one repeated
    byte as back references at distance 1."""
    out, lit, i = bytearray(), bytearray(), 0

    def flush():
        for j in range(0, len(lit), 32):
            chunk = lit[j:j + 32]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        lit.clear()

    while i < len(data):
        run = 1
        while i + run < len(data) and data[i + run] == data[i] and run < 265:
            run += 1
        if run >= 4:
            lit.append(data[i])
            flush()
            n = run - 1                       # copies of the previous byte
            if n >= 9:
                out += bytes([7 << 5, n - 9, 0])
            else:
                out += bytes([(n - 2) << 5, 0])
            i += run
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def write_pcd(path, pts, mode):
    """A PCD with fields x y z rgb (rgb all zero), in ``mode``."""
    n = len(pts)
    rgb = np.zeros(n, np.uint32)
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\n"
              "TYPE F F F U\nCOUNT 1 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
              f"DATA {mode}\n").encode()
    if mode == "ascii":
        body = "".join(f"{x!r} {y!r} {z!r} {c}\n" for (x, y, z), c in
                       zip(pts.tolist(), rgb.tolist())).encode()
    elif mode == "binary":
        rec = np.zeros(n, np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                                    ("rgb", "u4")]))
        rec["x"], rec["y"], rec["z"], rec["rgb"] = *pts.T, rgb
        body = rec.tobytes()
    else:
        raw = b"".join(a.tobytes() for a in (*np.ascontiguousarray(pts.T),
                                             rgb))
        comp = lzf_compress(raw)
        assert len(comp) < len(raw) * 0.8               # back references
        assert jpcd._lzf_decompress(comp, len(raw)) == raw
        body = np.array([len(comp), len(raw)], "<u4").tobytes() + comp
    with open(path, "wb") as f:
        f.write(header + body)


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_pcd_loads_as_in_gpd_tpu(tmp_path, mode):
    pts = cloud(1)
    path = str(tmp_path / f"c_{mode}.pcd")
    write_pcd(path, pts, mode)
    ours, theirs = pcd.load_pcd(path), jpcd.load_pcd(path)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, pts)        # NaN rows kept


def test_save_pcd_round_trip(tmp_path):
    pts = cloud(2)[4:]
    ours, theirs = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    pcd.save_pcd(ours, pts)
    jpcd.save_pcd(theirs, pts)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_allclose(pcd.load_cloud_file(ours), pts, atol=1e-6)


@pytest.mark.parametrize("mode", ["ascii", "binary_little_endian"])
def test_ply_loads_as_in_gpd_tpu(tmp_path, mode):
    pts = cloud(3)[4:]
    n = len(pts)
    header = (f"ply\nformat {mode} 1.0\nelement vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nend_header\n").encode()
    if mode == "ascii":
        body = "".join(f"{x!r} {y!r} {z!r} 7\n"
                       for x, y, z in pts.tolist()).encode()
    else:
        rec = np.zeros(n, np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                                    ("red", "u1")]))
        rec["x"], rec["y"], rec["z"], rec["red"] = *pts.T, 7
        body = rec.tobytes()
    path = str(tmp_path / "c.ply")
    with open(path, "wb") as f:
        f.write(header + body)
    ours = pcd.load_cloud_file(path)
    np.testing.assert_array_equal(ours, jpcd.load_cloud_file(path))
    np.testing.assert_array_equal(ours, pts)
    with pytest.raises(ValueError):
        pcd.load_cloud_file(str(tmp_path / "c.xyz"))


def test_normals_csv_loads_as_in_gpd_tpu(tmp_path):
    nrm = np.random.default_rng(4).normal(size=(50, 3))
    path = str(tmp_path / "n.csv")
    np.savetxt(path, nrm, delimiter=",")
    ours = pcd.load_normals_csv(path)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jpcd.load_normals_csv(path))


def host_grasps(seed=0, G=24):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(G, 3, 3)))
    f32 = np.float32
    return dict(position=rng.normal(size=(G, 3)).astype(f32),
                orientation=q.astype(f32), sample=rng.normal(size=(G, 3)).astype(f32),
                width=rng.uniform(0, 0.08, G).astype(f32),
                score=rng.normal(size=G).astype(f32),
                bottom=rng.normal(size=G).astype(f32),
                top=rng.normal(size=G).astype(f32),
                center=rng.normal(size=G).astype(f32),
                finger_placement=rng.integers(0, 10, G),
                full_antipodal=rng.random(G) < 0.5,
                half_antipodal=rng.random(G) < 0.5,
                valid=rng.random(G) < 0.7, sample_id=np.arange(G))


def test_grasps_csv_is_byte_identical(tmp_path):
    h = host_grasps()
    ours, theirs = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    write_grasps_csv(ours, Grasps(**{k: torch.from_numpy(np.asarray(v))
                                     for k, v in h.items()}))
    jwrite_grasps_csv(theirs, JGrasps(**{k: jnp.asarray(v)
                                         for k, v in h.items()}))
    text = open(ours, "rb").read()
    assert text == open(theirs, "rb").read()
    assert text.count(b"\n") == h["valid"].sum() > 0
    assert len(text.split(b"\n")[0].split(b",")) == 13


def scene_pcd(path, seed=0):
    """A single-camera synthetic table scene as an ascii PCD; returns the
    camera position."""
    rng = np.random.default_rng(seed)
    pts, nrm = syn.make_scene(rng, n_objects=2, points_per_object=1500,
                              table_points=1500, table_halfsize=0.15)
    cams = syn.view_cameras(rng, 1)
    p, _, _ = syn.render_fused_views(rng, pts, nrm, cams)
    pcd.save_pcd(path, p)
    return cams[0]


def test_detect_file_is_detect_on_the_loaded_cloud(tmp_path):
    path = str(tmp_path / "scene.pcd")
    cam = scene_pcd(path)
    cfg = DetectorConfig(image_geometry=ImageGeometry(num_channels=3),
                         num_samples=24, camera_position=tuple(cam.tolist()))
    det = GraspDetector(cfg, device="cpu")
    out = det.detect_file(path, generator=torch.Generator().manual_seed(2),
                          verbose=False).to_host()
    counts = det.last_counts
    cloud = det.preprocess_cloud(pcd.load_cloud_file(path),
                                 view_points=np.float32(cam)[None],
                                 capacity="serve")
    assert cloud.capacity == 2048
    ref = det.detect(cloud, generator=torch.Generator().manual_seed(2),
                     verbose=False).to_host()
    assert counts == det.last_counts and counts["selected"] > 0
    for name in ("position", "orientation", "score", "valid"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name))


CFG = """
image_num_channels = 3
num_samples = 12
num_selected = 5
min_inliers = 0
camera_position = {x} {y} {z}
"""


def test_cli_on_the_cpu(tmp_path, capsys):
    assert main([], device="cpu") == -1
    assert "Usage" in capsys.readouterr().out
    path = str(tmp_path / "scene.pcd")
    cam = scene_pcd(path, seed=1)
    cfg = tmp_path / "three.cfg"
    cfg.write_text(CFG.format(x=cam[0], y=cam[1], z=cam[2]))
    missing = str(tmp_path / "none.pcd")
    assert main([str(cfg), missing], device="cpu") == -1
    assert f"File {missing} could not be found!" in capsys.readouterr().out
    out_csv = str(tmp_path / "grasps.csv")
    normals_csv = str(tmp_path / "normals.csv")
    pts = pcd.load_cloud_file(path)
    nrm = cam[None, :] - pts
    np.savetxt(normals_csv, nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
               delimiter=",")
    assert main([str(cfg), path, normals_csv, out_csv, "--staged"],
                device="cpu") == 0
    text = capsys.readouterr().out
    assert "Processed cloud" in text and "Classification" in text
    assert f"Loaded surface normals from file: {normals_csv}" in text
    rows = open(out_csv).read().splitlines()
    assert 1 <= len(rows) <= 5 and all(len(r.split(",")) == 13 for r in rows)
    assert os.path.getsize(out_csv) > 0


def test_cli_empty_normals_argument_is_a_missing_file(tmp_path, capsys):
    """NORMALS_CSV "" is a file that does not exist, in both packages: the
    message and -1, and no CSV written."""
    path = str(tmp_path / "scene.pcd")
    cam = scene_pcd(path, seed=1)
    cfg = tmp_path / "three.cfg"
    cfg.write_text(CFG.format(x=cam[0], y=cam[1], z=cam[2]))
    out_csv = str(tmp_path / "grasps.csv")
    argv = [str(cfg), path, "", out_csv]
    assert main(argv, device="cpu") == -1
    ours = capsys.readouterr().out
    assert jmain(argv) == -1
    assert ours == capsys.readouterr().out == "File  could not be found!\n"
    assert not os.path.exists(out_csv)


def ascii_pcd(path, pts, fmt, extra=0, npts=None):
    """An ascii PCD of ``pts`` with ``fmt`` per value; ``extra`` adds a
    COUNT-3 normal field and an rgb field after xyz; ``npts`` overrides the
    POINTS count."""
    n = len(pts)
    fields, sizes, types, counts = "x y z", "4 4 4", "F F F", "1 1 1"
    if extra:
        fields += " normal rgb"
        sizes += " 4 4"
        types += " F U"
        counts += " 3 1"
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        f.write(f"# .PCD v0.7\nVERSION 0.7\nFIELDS {fields}\nSIZE {sizes}\n"
                f"TYPE {types}\nCOUNT {counts}\nWIDTH {n}\nHEIGHT 1\n"
                f"POINTS {npts or n}\nDATA ascii\n")
        for row in pts.tolist():
            vals = [fmt(v) for v in row]
            if extra:
                vals += [fmt(v) for v in rng.normal(size=3).tolist()]
                vals.append(str(int(rng.integers(0, 1 << 24))))
            f.write(" ".join(vals) + "\n")


@pytest.mark.parametrize("case", ["repr", "exponents", "fixed", "extra"])
def test_ascii_pcd_native_route(tmp_path, case):
    """The port's native ascii parser against its NumPy route and against
    gpd_tpu's load_pcd: identical arrays, NaN rows kept."""
    pts = cloud(5, n=2000)
    pts[10] = (np.nan, 1.0, np.nan)
    fmt = {"repr": repr, "exponents": lambda v: f"{v:.8E}",
           "fixed": lambda v: f"{v:.6f}", "extra": repr}[case]
    path = str(tmp_path / f"{case}.pcd")
    ascii_pcd(path, pts, fmt, extra=case == "extra")
    assert pcd.ascii_route() == "native"
    native = pcd.load_pcd(path)
    with mock.patch.object(pcd, "_native_parser", lambda: None):
        assert pcd.ascii_route() == "numpy"
        numpy_route = pcd.load_pcd(path)
    np.testing.assert_array_equal(native, numpy_route)
    np.testing.assert_array_equal(native, jpcd.load_pcd(path))
    assert native.shape == (2000, 3) and np.isnan(native[[3, 10]]).sum() == 5
    if case in ("repr", "extra"):
        np.testing.assert_array_equal(native, pts)


def test_ascii_pcd_short_body_falls_back(tmp_path):
    """A body with fewer numbers than POINTS promises: the native parse
    comes up short, NumPy parses instead and the file fails as malformed,
    as in gpd_tpu."""
    path = str(tmp_path / "short.pcd")
    ascii_pcd(path, cloud(6, n=50), repr, npts=60)
    calls = []
    native = pcd._native_parser()

    def counting(*args):
        calls.append(native(*args))
        return calls[-1]
    with mock.patch.object(pcd, "_native_parser", lambda: counting):
        with pytest.raises(ValueError):
            pcd.load_pcd(path)
    assert calls == [150]
    with pytest.raises(ValueError):
        jpcd.load_pcd(path)


def test_cli_staged_route(tmp_path, capsys):
    """--staged takes detect(staged=True): the four-line report, and the
    same grasps (CSV) as the default route on the same draws."""
    path = str(tmp_path / "scene.pcd")
    cam = scene_pcd(path, seed=2)
    cfg = tmp_path / "three.cfg"
    cfg.write_text(CFG.format(x=cam[0], y=cam[1], z=cam[2]))
    csvs = [str(tmp_path / "default.csv"), str(tmp_path / "staged.csv")]
    assert main([str(cfg), path, csvs[0]], device="cpu") == -1    # no file
    normals_csv = str(tmp_path / "normals.csv")
    np.savetxt(normals_csv, np.tile([0.0, 0.0, 1.0],
                                    (len(pcd.load_cloud_file(path)), 1)),
               delimiter=",")
    capsys.readouterr()
    with mock.patch.object(GraspDetector, "_detect_staged",
                           side_effect=GraspDetector._detect_staged,
                           autospec=True) as staged:
        assert main([str(cfg), path, normals_csv, csvs[0]], device="cpu") == 0
        assert staged.call_count == 0
        default = capsys.readouterr().out
        assert main([str(cfg), path, normals_csv, csvs[1], "--staged"],
                    device="cpu") == 0
        assert staged.call_count == 1
    text = capsys.readouterr().out
    assert " 1. Candidate generation + descriptors + classification" in default
    report = text[text.index("Selected the"):].splitlines()
    assert [r.split(":")[0] for r in report[1:]] == [
        "======== RUNTIMES ========", " 1. Candidate generation",
        " 2. Descriptors/images", " 3. Classification", "==========",
        " TOTAL"]
    rows = open(csvs[1]).read()
    assert rows == open(csvs[0]).read() and rows.count("\n") >= 1


LATTICE_CFG = """
voxelize = 0
normals_radius = 0.008
nn_radius = 0.015
num_samples = 24
camera_position = {x} {y} {z}
"""


def test_generate_candidates_against_gpd_tpu(tmp_path, capsys):
    """generate_candidates on a written PCD of the dyadic lattice tube
    (both packages preprocess it to the same cloud), the port with
    gpd_tpu's subsample: the same count line and the same CSV within
    1e-5."""
    assert gen([], device="cpu") == -1
    assert "Usage" in capsys.readouterr().out
    pts, _, vp = lattice_shell()
    path = str(tmp_path / "tube.pcd")
    ascii_pcd(path, pts, repr)
    cfg = tmp_path / "gen.cfg"
    cfg.write_text(LATTICE_CFG.format(x=vp[0, 0], y=vp[0, 1], z=vp[0, 2]))
    out = [str(tmp_path / "theirs.csv"), str(tmp_path / "ours.csv")]
    assert jgen([str(cfg), path, out[0]]) == 0
    theirs = capsys.readouterr().out.splitlines()[-1]

    jd = jdet.GraspDetector(str(cfg), params={})
    jc = jd.preprocess_cloud(pts, view_points=vp[:1], capacity="serve")
    idx = jpp.subsample_uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), 4), jc.mask, 24)[0]
    assert frame_gap_ok(jc, np.asarray(jc.points)[np.asarray(idx)],
                        jd.cfg.nn_radius_frames).all()
    idx = torch.from_numpy(np.array(idx)).long()
    with mock.patch.object(draws, "subsample", lambda g, pool, n: idx):
        assert gen([str(cfg), path, out[1]], device="cpu") == 0
    ours = capsys.readouterr().out.splitlines()[-1]
    assert ours == theirs and ours.startswith("Generated ")
    assert int(ours.split()[1]) > 0
    a, b = np.loadtxt(out[0], delimiter=","), np.loadtxt(out[1], delimiter=",")
    assert a.shape == b.shape == (int(ours.split()[1]), 13)
    np.testing.assert_allclose(a, b, atol=1e-5)
    with mock.patch.object(draws, "subsample", lambda g, pool, n: idx):
        assert gen([str(cfg), path], device="cpu") == 0    # no CSV asked for
    assert capsys.readouterr().out.splitlines()[-1] == ours
