"""gpd_tpu_torch.viz and apps/test_grasp_image.py against gpd_tpu's on the
CPU.

viz's geometry (hand segments, the hand's four cuboids, the image-volume
cube) must equal gpd_tpu.viz's, its PLY dump byte for byte, and every plot
renders headless to a PNG where matplotlib imports (viz imports it only
inside the plotting functions, so the geometry runs without it).

test_grasp_image: both apps on a PCD of a dyadic lattice tube with 1/256 m
spacing, so 3 mm voxels keep every point and both packages estimate the
same normals (tests/test_torch_detector.py's lattice argument). The
printed poses must agree at samples where gpd_tpu's local frame is well
conditioned (ROADMAP.md C): the same count and antipodal flags, and widths
within 2e-4 (the 4-decimal print of widths whose frames agree to ~1e-6
still moves one last digit now and then; measured up to 1e-4).
"""

import os

import numpy as np
import pytest
import torch

import gpd_tpu.viz as jviz
from gpd_tpu.apps.test_grasp_image import main as jmain
from gpd_tpu.config import DetectorConfig as JConfig
from gpd_tpu.detector import GraspDetector as JDetector
from gpd_tpu_torch import viz
from gpd_tpu_torch.apps.test_grasp_image import hand_poses, main
from gpd_tpu_torch.config import DetectorConfig
from gpd_tpu_torch.core.types import Grasps
from gpd_tpu_torch.io.pcd import save_pcd
from test_torch_detector import frame_gap_ok
from test_torch_threads import set_cpu_share

set_cpu_share()

pytest.importorskip("matplotlib")


def frames(seed, n=4):
    """Random proper rotations and positions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        out.append((rng.normal(scale=0.1, size=3), q))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_equals_gpd_tpu(seed):
    """hand_segments, hand_volume_boxes and volume_box at default and other
    dimensions, from host arrays and from tensors."""
    dims = dict(outer_diameter=0.1, depth=0.05, finger_width=0.012)
    for p, R in frames(seed):
        for kw in ({}, dims):
            np.testing.assert_array_equal(viz.hand_segments(p, R, **kw),
                                          jviz.hand_segments(p, R, **kw))
            np.testing.assert_array_equal(
                viz.hand_volume_boxes(p, R, **kw, height=0.03),
                jviz.hand_volume_boxes(p, R, **kw, height=0.03))
        np.testing.assert_array_equal(
            viz.volume_box(p, R, 0.06, 0.1, 0.04),
            jviz.volume_box(p, R, 0.06, 0.1, 0.04))
        np.testing.assert_array_equal(
            viz.hand_volume_boxes(torch.from_numpy(p), torch.from_numpy(R)),
            jviz.hand_volume_boxes(p, R))


def test_save_cloud_ply_is_gpd_tpu_byte_for_byte(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    col = rng.integers(0, 256, (50, 3))
    viz.save_cloud_ply(str(tmp_path / "a.ply"), torch.from_numpy(pts),
                       normals=torch.from_numpy(nrm), colors=col)
    jviz.save_cloud_ply(str(tmp_path / "b.ply"), pts, normals=nrm,
                        colors=col)
    assert ((tmp_path / "a.ply").read_bytes()
            == (tmp_path / "b.ply").read_bytes())


def grasp_batch():
    """A Grasps batch of three hands, the middle one invalid."""
    (p0, r0), (p1, r1), (p2, r2) = frames(7, 3)
    z = torch.zeros(3)
    return Grasps(
        position=torch.tensor(np.stack([p0, p1, p2]), dtype=torch.float32),
        orientation=torch.tensor(np.stack([r0, r1, r2]), dtype=torch.float32),
        sample=torch.zeros(3, 3), width=z + 0.05,
        score=torch.tensor([1.0, 0.5, -0.2]), bottom=z, top=z, center=z,
        finger_placement=torch.zeros(3, dtype=torch.int64),
        full_antipodal=torch.tensor([True, False, False]),
        half_antipodal=torch.tensor([True, True, False]),
        valid=torch.tensor([True, False, True]),
        sample_id=torch.zeros(3, dtype=torch.int64))


def test_grasps_batch_is_its_valid_rows():
    g = grasp_batch()
    rows = viz._grasp_list(g)
    assert len(rows) == 2
    np.testing.assert_array_equal(rows[1]["position"], g.position[2].numpy())


@pytest.mark.parametrize("plot", ["grasps", "hands_score", "hands_antipodal",
                                  "hands_fixed", "volumes", "hand_geometry",
                                  "normals", "image_grid", "loss_stats"])
def test_renders_headless(plot, tmp_path):
    """Every plot writes a PNG from the port's own types (a Grasps batch,
    tensors), as gpd_tpu's does from host arrays."""
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.normal(scale=0.03, size=(300, 3)))
    g = grasp_batch()
    out = str(tmp_path / f"{plot}.png")
    if plot == "grasps":
        viz.plot_grasps(pts, g, path=out)
    elif plot.startswith("hands_"):
        viz.plot_hands_3d(pts, g, path=out, color_by=plot[6:])
    elif plot == "volumes":
        viz.plot_volumes_3d(pts, g, path=out)
    elif plot == "hand_geometry":
        viz.plot_hand_geometry(g.to_host_list()[0], pts, path=out)
    elif plot == "normals":
        viz.plot_normals(pts, pts / pts.norm(dim=1, keepdim=True), path=out)
    elif plot == "image_grid":
        viz.grasp_image_grid(torch.from_numpy(rng.integers(
            0, 255, (60, 60, 15)).astype(np.uint8)), path=out)
    else:
        log = tmp_path / "loss.csv"
        log.write_text("100,0.69,0.5\n200,0.41,0.8\n")
        viz.plot_loss_stats(str(log), path=out)
    assert os.path.getsize(out) > 10000


def lattice_pcd(tmp_path):
    """A skewed elliptic tube of dyadic lattice points 1/256 m apart."""
    g = np.arange(-16, 17)
    x, y, z = np.meshgrid(g, g, np.arange(-15, 16), indexing="ij")
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    q = pts[:, 0] ** 2 + pts[:, 0] * pts[:, 1] + 2 * pts[:, 1] ** 2
    pts = (pts[(q > 60) & (q <= 80)] / 256.0).astype(np.float32)
    path = str(tmp_path / "tube.pcd")
    save_pcd(path, pts)
    return path, pts


def parse(lines):
    """(header, [(full, half, width)], tail) of the app's printed poses."""
    poses = [(ln.split("full_antipodal=")[1].split()[0],
              ln.split("half=")[1].split()[0],
              float(ln.split("width=")[1]))
             for ln in lines if ln.startswith("  orientation")]
    return lines[0], poses, lines[-1]


def test_test_grasp_image_matches_gpd_tpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main([], device="cpu") == -1
    assert "Usage" in capsys.readouterr().out
    path, pts = lattice_pcd(tmp_path)
    jd = JDetector(JConfig(num_samples=1))
    jc = jd.preprocess_cloud(pts, view_points=np.zeros((1, 3), np.float32))
    cloud = np.asarray(jc.points)[np.asarray(jc.mask)]
    good = np.nonzero(frame_gap_ok(jc, cloud, jd.cfg.nn_radius_frames))[0]
    assert len(good) >= 100
    for idx in good[::len(good) // 4][:4]:
        argv = [path, str(idx), str(tmp_path / f"g{idx}.png")]
        capsys.readouterr()
        assert jmain(argv) == 0
        theirs = [ln for ln in capsys.readouterr().out.splitlines()
                  if not ln.startswith("NOTE")]
        assert main(argv, device="cpu") == 0
        ours = [ln for ln in capsys.readouterr().out.splitlines()
                if not ln.startswith("NOTE")]
        (h0, p0, t0), (h1, p1, t1) = parse(theirs), parse(ours)
        assert (h0, t0) == (h1, t1) and h1.startswith(f"sample {idx}: ")
        assert len(p0) == len(p1) > 0
        for a, b in zip(p0, p1):
            assert a[:2] == b[:2]
            assert abs(a[2] - b[2]) <= 2e-4
        assert os.path.getsize(tmp_path / f"g{idx}.png") > 10000


def test_hand_poses_feed_viz(tmp_path):
    """The app's poses at one sample go through viz's geometry: four
    cuboids per valid hand, fingers at the hand's outer diameter."""
    path, _ = lattice_pcd(tmp_path)
    _, grasps, images = hand_poses(path, 40, device="cpu")
    cfg = DetectorConfig()
    hg = cfg.hand_geometry
    assert images.shape[1:] == (60, 60, 15) and images.dtype == torch.uint8
    rows = grasps.to_host_list()
    assert rows
    for g in rows:
        boxes = viz.hand_volume_boxes(g["position"], g["orientation"],
                                      hg.outer_diameter, hg.depth,
                                      hg.finger_width, hg.height)
        assert boxes.shape == (4, 8, 3)
        left, right = boxes[0].mean(0), boxes[1].mean(0)
        assert abs(np.linalg.norm(left - right)
                   - (hg.outer_diameter - hg.finger_width)) < 1e-6
