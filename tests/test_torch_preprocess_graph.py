"""gpd_tpu's preprocess programs in the port (gpd_tpu_torch/detector.py
``_prep_filter_voxel``, ``_prep_outliers``, ``_prep_normals``, and
ops/normals.py ``refine_normals`` with its loop on the device): on the CPU
against gpd_tpu and against the early-exit loop the port ran before, and
on the card as CUDA graphs.

The inputs are the dyadic lattice tube of tests/test_torch_detector.py,
where the moment sums are exact in float32, so both packages estimate the
same normals. Voxels there are 1/512 m, the lattice spacing: every point
is its own cell, so voxelize runs (sorts, sums, snapping) and keeps the
lattice. The CPU tests import gpd_tpu inside their bodies and the tests
marked ``cuda`` need a card and skip without one; the module imports no
JAX, so they run where there is none:

    python -m pytest tests/test_torch_preprocess_graph.py -m cuda --noconftest
"""

import dataclasses
import unittest.mock as mock

import numpy as np
import pytest
import torch

from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.core.types import CloudArrays
from gpd_tpu_torch.ops import normals as tnormals
from gpd_tpu_torch.ops.neighbors import radius_neighbors
from test_torch_threads import set_cpu_share

set_cpu_share()

LATTICE_VOXEL = 1.0 / 512

# 15 channels: the defaults but for the lattice's voxel size and a normals
# radius the tube's curvature keeps well conditioned; 3 channels: the
# options of chip_smoke's 3-channel config that preprocess reads.
CONFIGS = {
    "15-channel defaults": dict(voxel_size=LATTICE_VOXEL,
                                normals_radius=0.008),
    "3-channel options": dict(image_geometry=ImageGeometry(num_channels=3),
                              voxel_size=LATTICE_VOXEL, remove_outliers=True,
                              refine_normals_k=10, centered_at_origin=True),
}


def lattice():
    from test_torch_detector import lattice_shell
    return lattice_shell()


def lattice_cloud():
    """The lattice tube as a CPU CloudArrays with its estimated, reversed
    normals (radius 8 mm)."""
    p, cs, vp = lattice()
    c = CloudArrays.from_numpy(p, view_points=vp, cam_source=cs, device="cpu")
    return tnormals.reverse_normals_cloud(tnormals.estimate_normals(c, 0.008))


def early_exit_refine(points, normals, mask, k=10, max_iterations=15,
                      convergence_rms=1e-4):
    """The port's refine_normals before its loop moved onto the device: it
    read the RMS change back to the host every iteration and stopped after
    the first below ``convergence_rms``. Returns (normals, iterations)."""
    idx, valid = radius_neighbors(points, mask, points, mask, radius=1e5, k=k)
    vmaskf = valid[..., None].to(normals.dtype)
    n_pts = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    cur = normals
    for it in range(max_iterations):
        avg = torch.sum(cur[idx] * vmaskf, dim=1)
        nrm = torch.sqrt(torch.sum(avg * avg, dim=1, keepdim=True))
        new = torch.where(nrm > 0.0, avg / torch.clamp(nrm, min=1e-20), cur)
        new = torch.where(mask[:, None], new, cur)
        diff = new - cur
        rms = torch.sqrt(torch.sum(diff * diff) / n_pts)
        cur = new
        if float(rms) < convergence_rms:
            return cur, it + 1
    return cur, max_iterations


@pytest.mark.parametrize("convergence_rms,converges", [(0.05, True),
                                                       (1e-4, False)])
def test_refine_loop_on_the_device(convergence_rms, converges):
    """refine_normals with its trip count and stop flag on the device: equal
    to the early-exit loop bit for bit, and to gpd_tpu's while_loop within
    1e-6. At an RMS bound of 0.05 the loop converges after 7 of 15
    iterations, so the frozen ones must leave the normals alone; at 1e-4
    it runs all 15."""
    import jax.numpy as jnp
    from gpd_tpu.ops import normals as jnormals
    c = lattice_cloud()
    args = (c.points, c.normals, c.mask)
    ref, iterations = early_exit_refine(*args, k=10,
                                        convergence_rms=convergence_rms)
    assert (iterations < 15) == converges
    out = tnormals.refine_normals(*args, k=10,
                                  convergence_rms=convergence_rms)
    assert torch.equal(out, ref)
    theirs = jnormals.refine_normals(
        *(jnp.asarray(t.numpy()) for t in args), k=10,
        convergence_rms=convergence_rms)
    np.testing.assert_allclose(out.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-6)


def _no_host_read(*args, **kwargs):
    raise AssertionError("a preprocess program read a tensor back to the host")


@pytest.mark.parametrize("program", ["filter_voxel", "outliers", "normals"])
def test_programs_read_nothing_back(program):
    """Each preprocess program, at the options that run all of it (voxels;
    estimate, refine and flip), runs with every host read patched to raise,
    as a CUDA graph needs; the early-exit refinement trips the same
    guard."""
    from test_torch_cem import HOST_READS, run_patched
    patches = [mock.patch.object(torch.Tensor, name, _no_host_read)
               for name in HOST_READS]
    c = lattice_cloud()
    fn = {"filter_voxel": lambda: tdet._prep_filter_voxel(
              c, (-1, 1, -1, 1, -1, 1), LATTICE_VOXEL, True),
          "outliers": lambda: tdet._prep_outliers(c, 50, 1.0),
          "normals": lambda: tdet._prep_normals(c, 0.008, True, 10, True)}
    out = run_patched(patches, fn[program])
    assert out.capacity == c.capacity and 0 < int(out.mask.sum())
    if program == "normals":
        assert (out.normals.norm(dim=1)[out.mask] > 0.99).all()
        with pytest.raises(AssertionError, match="read a tensor back"):
            run_patched(patches, lambda: early_exit_refine(
                c.points, c.normals, c.mask))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_program_route_matches_gpd_tpu(config):
    """preprocess_cloud by its programs (each called once, in gpd_tpu's
    order, the compactions between them) against gpd_tpu's on the lattice
    tube: the same capacity, masks and points, normals within 1e-5."""
    import gpd_tpu.detector as jdet
    from gpd_tpu.config import DetectorConfig as JConfig
    from gpd_tpu.config import ImageGeometry as JImageGeometry
    kw = CONFIGS[config]
    jkw = dict(kw, image_geometry=JImageGeometry(
        num_channels=kw.get("image_geometry", ImageGeometry()).num_channels))
    p, cs, vp = lattice()
    jc = jdet.GraspDetector(JConfig(**jkw), params={}).preprocess_cloud(
        p, view_points=vp, cam_source=cs)
    det = tdet.GraspDetector(DetectorConfig(**kw), device="cpu")
    calls = []

    def spy(name):
        real = getattr(tdet, name)

        def program(*args):
            calls.append(name)
            return real(*args)
        return mock.patch.object(tdet, name, program)
    with spy("_prep_filter_voxel"), spy("_prep_outliers"), \
            spy("_prep_normals"):
        tc = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    outliers = "remove_outliers" in kw
    assert calls == ["_prep_filter_voxel"] + ["_prep_outliers"] * outliers + [
        "_prep_normals"]
    assert tc.capacity == jc.points.shape[0]
    np.testing.assert_array_equal(np.asarray(jc.mask), tc.mask.numpy())
    np.testing.assert_array_equal(np.asarray(jc.points), tc.points.numpy())
    np.testing.assert_allclose(np.asarray(jc.normals), tc.normals.numpy(),
                               rtol=0, atol=1e-5)
    n = int(tc.mask.sum())
    assert (n < len(p)) == outliers and n > len(p) * 0.8


# ------------------------------------------------------------- on the card

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the preprocess programs are "
                    "captured as CUDA graphs only there (chip_smoke.py runs "
                    "them)")


def table(seed, n_objects=2):
    """A small two-camera table scene (raw points, camera bits, cameras)."""
    from gpd_tpu_torch.datasets import synthetic as syn
    rng = np.random.default_rng(seed)
    pts, nrm = syn.make_scene(rng, n_objects=n_objects,
                              points_per_object=1500, table_points=1500,
                              table_halfsize=0.15)
    return syn.render_fused_views(rng, pts, nrm, syn.view_cameras(rng, 2))


def card_detector(**kw):
    return tdet.GraspDetector(DetectorConfig(**kw), device="cuda")


def prep_keys(det):
    return [k for k in det.graphs if k[0].startswith("prep_")]


@pytest.mark.cuda
@pytest.mark.parametrize("outliers", [False, True])
def test_one_capture_per_program_and_key(outliers):
    """A request captures each of its programs once (with outliers on,
    three); the same request again captures nothing; a pinned larger
    capacity captures each program anew, once."""
    needs_card()
    det = card_detector(remove_outliers=outliers)
    p, cs, vp = table(0)
    det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    assert [k[0] for k in det.last_graphs] == (
        ["prep_filter_voxel"] + ["prep_outliers"] * outliers +
        ["prep_normals"])
    keys = prep_keys(det)
    assert keys == det.last_graphs
    det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    assert prep_keys(det) == keys == det.last_graphs
    for _ in range(2):
        det.preprocess_cloud(p, view_points=vp, cam_source=cs,
                             capacity=32768)
        assert len(prep_keys(det)) == 2 * len(keys)


@pytest.mark.cuda
def test_returned_cloud_survives_the_next_request():
    """Scene A, then scene B in the same keys (capacity pinned), then A's
    cloud is as it was (the graphs' outputs are copied out), and detect
    runs on it."""
    needs_card()
    det = card_detector(num_samples=100)
    a, b = table(0), table(1)
    cloud_a = det.preprocess_cloud(a[0], view_points=a[2], cam_source=a[1],
                                   capacity=8192)
    kept = {f.name: getattr(cloud_a, f.name).cpu().clone()
            for f in dataclasses.fields(cloud_a)}
    n = len(det.graphs)
    cloud_b = det.preprocess_cloud(b[0], view_points=b[2], cam_source=b[1],
                                   capacity=8192)
    assert len(det.graphs) == n and len(det.last_graphs) == 2
    for name, t in kept.items():
        assert torch.equal(getattr(cloud_a, name).cpu(), t), name
    assert not torch.equal(cloud_b.points.cpu(), kept["points"])
    out = det.detect(cloud_a, verbose=False,
                     generator=torch.Generator(device="cuda").manual_seed(0))
    assert out.valid.any()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(remove_outliers=True,
                                         refine_normals_k=10,
                                         centered_at_origin=True)])
def test_graph_route_equals_the_eager_route(kw):
    """The graph route (after its capture) and the eager route
    (_force_eager) on one scene: masks and points equal, normals within
    1e-5."""
    needs_card()
    det = card_detector(**kw)
    p, cs, vp = table(2)
    det.preprocess_cloud(p, view_points=vp, cam_source=cs)      # captures
    graph = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    det._force_eager = True
    eager = det.preprocess_cloud(p, view_points=vp, cam_source=cs)
    assert det.last_graphs == []
    assert torch.equal(graph.mask, eager.mask)
    assert torch.equal(graph.points, eager.points)
    assert float((graph.normals - eager.normals).abs().max()) <= 1e-5
