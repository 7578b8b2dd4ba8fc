"""gpd_tpu_torch.capi and the port's C ABI (gpd_tpu_torch/csrc/gpd_c_api.cpp)
against gpd_tpu.capi on the CPU.

The marshaling layer: the port's rows against gpd_tpu.capi's on the dyadic
lattice tube of test_torch_detector (both packages preprocess it to the
same cloud), the port with gpd_tpu's sample draws for the same seed
injected, at 3 channels, whose images are float32 in both packages and
draw nothing: the same row layout, the same rows (geometry 1e-5, scores
1e-3, flags exact), images within the repo's gate (a hand point on a cell
edge may land in either cell, ROADMAP.md C; such hands' scores move).

The C ABI: built by ops/_build.py with the host compiler against this
Python's headers, loaded into this process with ctypes (the interpreter
exists, so the library only takes the GIL), ``gpd_init("cpu")``; every
entry point returns what the Python layer returns (the same process, the
same seed: equal), and a bad config comes back as handle 0 with an error
(tests/test_capi.py's error path).
"""

import ctypes
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

import gpd_tpu.capi as jcapi
import gpd_tpu.detector as jdet
import gpd_tpu.ops.preprocess as jpp
from gpd_tpu.config import load_config as jload_config
from gpd_tpu_torch import capi
from gpd_tpu_torch.ops import _build, draws
from test_torch_detector import frame_gap_ok, lattice_shell
from test_torch_io import ascii_pcd
from test_torch_threads import set_cpu_share

set_cpu_share()

CFG = """\
image_num_channels = 3
num_samples = 32
voxelize = 0
normals_radius = 0.008
nn_radius = 0.015
num_selected = 12
min_inliers = 0
camera_position = 0.3 0.2 0.1
"""


class GpdGrasp(ctypes.Structure):
    _fields_ = [
        ("position", ctypes.c_double * 3),
        ("orientation", ctypes.c_double * 9),
        ("sample", ctypes.c_double * 3),
        ("width", ctypes.c_double),
        ("score", ctypes.c_double),
        ("full_antipodal", ctypes.c_int),
        ("half_antipodal", ctypes.c_int),
    ]


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("capi") / "capi.cfg"
    p.write_text(CFG)
    return str(p)


@pytest.fixture
def on_cpu():
    capi.set_device("cpu")
    yield
    capi.set_device(None)


def tube():
    """The lattice tube, its two view points and uint32 camera bitmasks."""
    pts, cam, vp = lattice_shell()
    bits = (cam[0] | (cam[1] << 1)).astype(np.uint32)
    return np.ascontiguousarray(pts), vp, bits


def gpd_tpu_draws(cfg_path, pts, vp, bits, seed, capacity=None):
    """The port's sample draw patched with gpd_tpu's for ``seed`` (its key
    folded with 4); asserts every drawn sample's frame is well
    conditioned."""
    jd = jdet.GraspDetector(cfg_path)
    jc = jd.preprocess_cloud(pts, view_points=vp, cam_source=bits,
                             capacity=capacity)
    idx = np.array(jpp.subsample_uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), 4), jc.mask,
        jd.cfg.num_samples)[0])
    assert frame_gap_ok(jc, np.asarray(jc.points)[idx],
                        jd.cfg.nn_radius_frames).all()
    return mock.patch.object(draws, "subsample", lambda g, pool, n:
                             torch.from_numpy(idx).long())


def assert_same_rows(theirs, ours, ordered=False):
    """The same set of grasp rows (the same order with ``ordered``):
    geometry within 1e-5, score within 1e-3, flags exact."""
    assert theirs.shape == ours.shape and ours.shape[1] == capi.GRASP_FLOATS
    assert len(ours) > 0 and ours.dtype == np.float64
    if not ordered:
        # Each row's nearest by geometry; positions tie across hands of a
        # sample only to rounding, so no sort order is safe.
        near = np.abs(ours[:, None, :16] - theirs[None, :, :16]).max(-1)
        match = near.argmin(1)
        assert len(set(match)) == len(ours)
        theirs = theirs[match]
    np.testing.assert_allclose(ours[:, :16], theirs[:, :16], atol=1e-5)
    np.testing.assert_allclose(ours[:, 16], theirs[:, 16], atol=1e-3)
    np.testing.assert_array_equal(ours[:, 17:], theirs[:, 17:])


def test_row_layout_is_gpd_tpus():
    assert capi.GRASP_FLOATS == jcapi.GRASP_FLOATS == 19


@pytest.mark.parametrize("seed", [0, 2])
def test_detect_in_cloud_matches_gpd_tpu(cfg_path, on_cpu, seed):
    pts, vp, bits = tube()
    theirs = jcapi.detect_in_cloud(jcapi.create_detector(cfg_path), pts, vp,
                                   bits, seed=seed)
    h = capi.create_detector(cfg_path)
    try:
        with gpd_tpu_draws(cfg_path, pts, vp, bits, seed):
            ours = capi.detect_in_cloud(h, pts, vp, bits, seed=seed)
    finally:
        capi.destroy_detector(h)
    assert_same_rows(theirs, ours)


def test_calc_descriptors_matches_gpd_tpu(cfg_path, on_cpu):
    """Every valid candidate in valid-first order with its image: images
    within the repo's gate, and every hand whose image is within one step
    everywhere scores within 1e-3 (the cell-edge divergence of ROADMAP.md
    C moves the others)."""
    pts, vp, _ = tube()
    theirs, jimages = jcapi.calc_descriptors(jcapi.create_detector(cfg_path),
                                             pts, vp, seed=1)
    h = capi.create_detector(cfg_path)
    with gpd_tpu_draws(cfg_path, pts, vp, None, 1):
        ours, images = capi.calc_descriptors(h, pts, vp, seed=1)
    assert images.dtype == np.uint8 and images.flags["C_CONTIGUOUS"]
    assert images.shape == jimages.shape == (len(ours), 60, 60, 3)
    diff = np.abs(images.astype(int) - jimages.astype(int))
    assert (diff > 1).mean() < 5e-3
    same = (diff <= 1).all(axis=(1, 2, 3))
    assert same.mean() > 0.9
    assert_same_rows(theirs[same], ours[same], ordered=True)
    np.testing.assert_allclose(ours[:, :16], theirs[:, :16], atol=1e-5)


def test_detect_in_file_matches_gpd_tpu(cfg_path, on_cpu, tmp_path):
    pts, vp, _ = tube()
    path = str(tmp_path / "tube.pcd")
    ascii_pcd(path, pts, repr)
    theirs = jcapi.detect_in_file(jcapi.create_detector(cfg_path), path,
                                  seed=2)
    h = capi.create_detector(cfg_path)
    cam = np.asarray(jload_config(cfg_path).camera_position,
                     np.float32).reshape(1, 3)
    with gpd_tpu_draws(cfg_path, pts, cam, None, 2, capacity="serve"):
        ours = capi.detect_in_file(h, path, seed=2)
    assert_same_rows(theirs, ours)


def test_detectors_default_to_cuda(cfg_path):
    capi.set_device("")
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="CUDA"):
            capi.create_detector(cfg_path)


# ----------------------------------------------------------------- C ABI

@pytest.fixture(scope="module")
def lib():
    lib = _build.load("gpd_c_api")
    lib.gpd_last_error.restype = ctypes.c_char_p
    lib.gpd_init.argtypes = [ctypes.c_char_p]
    lib.gpd_init.restype = ctypes.c_int
    lib.gpd_detector_create.restype = ctypes.c_int64
    lib.gpd_detector_create.argtypes = [ctypes.c_char_p]
    lib.gpd_detector_destroy.argtypes = [ctypes.c_int64]
    lib.gpd_detect_grasps_in_file.restype = ctypes.c_int
    lib.gpd_detect_grasps_in_file.argtypes = [
        ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(GpdGrasp)),
        ctypes.POINTER(ctypes.c_int)]
    lib.gpd_detect_grasps_in_cloud.restype = ctypes.c_int
    lib.gpd_detect_grasps_in_cloud.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.POINTER(GpdGrasp)),
        ctypes.POINTER(ctypes.c_int)]
    lib.gpd_calc_grasp_descriptors.restype = ctypes.c_int
    lib.gpd_calc_grasp_descriptors.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(GpdGrasp)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.gpd_free.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture
def c_cpu(lib):
    assert lib.gpd_init(b"cpu") == 0, lib.gpd_last_error()
    yield lib
    capi.set_device(None)


def rows_of(out, n):
    """GpdGrasp structs as capi's float64 rows."""
    return np.array([list(g.position) + list(g.orientation) + list(g.sample)
                     + [g.width, g.score, g.full_antipodal, g.half_antipodal]
                     for g in out[:n]])


def fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def test_create_error(lib):
    assert lib.gpd_detector_create(b"/no/such/file.cfg") == 0
    assert b"create_detector" in lib.gpd_last_error()


def test_gpd_init_sets_the_device(lib, cfg_path):
    """gpd_init("") leaves detectors on CUDA (none here: create fails and
    says why); gpd_init("cpu") puts them on the CPU."""
    assert lib.gpd_init(b"") == 0
    assert capi._device is None
    assert lib.gpd_detector_create(cfg_path.encode()) == 0
    assert b"CUDA" in lib.gpd_last_error()
    assert lib.gpd_init(b"cpu") == 0 and capi._device == "cpu"
    h = lib.gpd_detector_create(cfg_path.encode())
    assert h > 0, lib.gpd_last_error()
    lib.gpd_detector_destroy(h)
    capi.set_device(None)


def test_c_detect_in_cloud_is_capis(c_cpu, cfg_path):
    lib = c_cpu
    pts, vp, bits = tube()
    h = lib.gpd_detector_create(cfg_path.encode())
    assert h > 0, lib.gpd_last_error()
    try:
        out = ctypes.POINTER(GpdGrasp)()
        n = ctypes.c_int(-1)
        rc = lib.gpd_detect_grasps_in_cloud(
            h, fptr(pts), len(pts), fptr(vp), len(vp),
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.byref(out), ctypes.byref(n))
        assert rc == 0, lib.gpd_last_error()
        ours = rows_of(out, n.value)
        lib.gpd_free(out)
    finally:
        lib.gpd_detector_destroy(h)
    h = capi.create_detector(cfg_path)
    expect = capi.detect_in_cloud(h, pts, vp, bits, seed=0)
    assert n.value == len(expect) > 0
    np.testing.assert_array_equal(ours, expect)
    R = ours[:, 3:12].reshape(-1, 3, 3)
    assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max() < 1e-4


def test_c_calc_descriptors_is_capis(c_cpu, cfg_path):
    lib = c_cpu
    pts, vp, _ = tube()
    h = lib.gpd_detector_create(cfg_path.encode())
    assert h > 0, lib.gpd_last_error()
    out = ctypes.POINTER(GpdGrasp)()
    imgs = ctypes.POINTER(ctypes.c_uint8)()
    n, size, chans = ctypes.c_int(-1), ctypes.c_int(-1), ctypes.c_int(-1)
    rc = lib.gpd_calc_grasp_descriptors(
        h, fptr(pts), len(pts), None, 0, ctypes.byref(out),
        ctypes.byref(imgs), ctypes.byref(n), ctypes.byref(size),
        ctypes.byref(chans))
    assert rc == 0, lib.gpd_last_error()
    assert (size.value, chans.value) == (60, 3)
    images = np.ctypeslib.as_array(imgs, shape=(n.value, 60, 60, 3)).copy()
    ours = rows_of(out, n.value)
    lib.gpd_free(out)
    lib.gpd_free(imgs)
    lib.gpd_detector_destroy(h)
    expect, expect_images = capi.calc_descriptors(
        capi.create_detector(cfg_path), pts, None, seed=0)
    assert n.value == len(expect) > 0
    np.testing.assert_array_equal(ours, expect)
    np.testing.assert_array_equal(images, expect_images)
    assert images.max() > 0


def test_c_detect_in_file_is_capis(c_cpu, cfg_path, tmp_path):
    lib = c_cpu
    pts, _, _ = tube()
    path = str(tmp_path / "tube.pcd")
    ascii_pcd(path, pts, repr)
    h = lib.gpd_detector_create(cfg_path.encode())
    out = ctypes.POINTER(GpdGrasp)()
    n = ctypes.c_int(-1)
    rc = lib.gpd_detect_grasps_in_file(h, path.encode(), ctypes.byref(out),
                                       ctypes.byref(n))
    assert rc == 0, lib.gpd_last_error()
    ours = rows_of(out, n.value)
    lib.gpd_free(out)
    lib.gpd_detector_destroy(h)
    expect = capi.detect_in_file(capi.create_detector(cfg_path), path)
    assert n.value == len(expect) > 0
    np.testing.assert_array_equal(ours, expect)
