"""The port's span tree (gpd_tpu_torch/profiling.py): the spans a grasp
request, a file read and a training epoch open, each nested where its work
happens, read from the Chrome trace ``profiling.maybe_trace`` writes on the
CPU; and ``profiling.span`` with no profiler running: the shared null
context, no call into torch. No timing is asserted."""

import glob
import json
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from gpd_tpu_torch import profiling
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.datasets import synthetic as syn
from gpd_tpu_torch.detector import GraspDetector
from gpd_tpu_torch.io import pcd
from gpd_tpu_torch.net import train
from test_torch_threads import set_cpu_share

set_cpu_share()


def traced_spans(trace_dir):
    """The (name, start, end) of every span in the one Chrome trace in
    ``trace_dir``, by start."""
    (path,) = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in evs
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda s: s[1])


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def scene(n_objects=2):
    """A one-camera table scene of ``n_objects`` objects: points and the
    camera's position."""
    rng = np.random.default_rng(3)
    pts, nrm = syn.make_scene(rng, n_objects=n_objects)
    cams = syn.view_cameras(rng, 1)
    p, _, _ = syn.render_fused_views(rng, pts, nrm, cams)
    return p.astype(np.float32), np.asarray(cams, np.float32).reshape(1, 3)


def detector(**kw):
    return GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(num_channels=3), num_samples=24,
        num_selected=5, **kw), device="cpu")


@pytest.mark.parametrize("capacity", [None, "serve"])
def test_preprocess_holds_its_programs(tmp_path, capacity):
    det = detector(remove_outliers=True)
    points, cam = scene()
    with profiling.maybe_trace(str(tmp_path)):
        det.preprocess_cloud(points, view_points=cam, capacity=capacity)
    spans = traced_spans(tmp_path)
    (pre,) = named(spans, "preprocess")
    order = ["preprocess_upload", "prep_filter_voxel", "preprocess_compact",
             "prep_outliers", "preprocess_compact", "prep_normals"]
    inner = [s for s in spans if s[0] in order]
    assert [s[0] for s in inner] == order
    assert all(inside(s, pre) for s in inner)
    # Each one ends before the next opens.
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def write_ply(path, points):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(points)}\nproperty float x\n"
                "property float y\nproperty float z\nend_header\n")
        np.savetxt(f, points, fmt="%.6f")


@pytest.mark.parametrize("ext", [".pcd", ".ply"])
def test_file_read_is_one_span(tmp_path, ext):
    points = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    path = str(tmp_path / f"cloud{ext}")
    (pcd.save_pcd if ext == ".pcd" else write_ply)(path, points)
    out = tmp_path / "trace"
    with profiling.maybe_trace(str(out)):
        got = pcd.load_cloud_file(path)
    np.testing.assert_allclose(got, points, atol=1e-6)
    assert [s[0] for s in traced_spans(out)] == ["read_file"]


@pytest.mark.parametrize("how", ["outer trace", "GPD_TPU_PROFILE"])
def test_detect_holds_its_parts(tmp_path, monkeypatch, how):
    """``detect`` holds A, the read and B in ``detect_core``, then C and
    the result's read, whether a caller's trace or the operator's
    GPD_TPU_PROFILE (detect's own ``maybe_trace``) records it."""
    det = detector()
    points, cam = scene()
    cloud = det.preprocess_cloud(points, view_points=cam)
    gen = torch.Generator().manual_seed(0)
    if how == "outer trace":
        with profiling.maybe_trace(str(tmp_path)):
            det.detect(cloud, generator=gen, verbose=False)
    else:
        monkeypatch.setenv("GPD_TPU_PROFILE", str(tmp_path))
        det.detect(cloud, generator=gen, verbose=False)
    spans = traced_spans(tmp_path)
    (top,) = named(spans, "detect")
    (core,) = named(spans, "detect_core")
    parts = [s for s in spans if s[0] in ("candidates", "candidates_read",
                                           "score")]
    assert [s[0] for s in parts] == ["candidates", "candidates_read",
                                     "score"]
    assert all(inside(s, core) for s in parts)
    after = [s for s in spans if s[0] in ("select_and_cluster",
                                           "detect_result")]
    assert [s[0] for s in after] == ["select_and_cluster", "detect_result"]
    assert core[2] <= after[0][1] and after[0][2] <= after[1][1]
    assert all(inside(s, top) for s in [core] + parts + after)
    assert det.last_counts["selected"] >= 0


class Rows:
    def __init__(self, n, block, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 255, (n, 60, 60, 3), dtype=np.uint8)
        self.labels = rng.integers(0, 2, n)
        self.block = block

    def blocks(self):
        for a in range(0, len(self.labels), self.block):
            yield (self.images[a:a + self.block],
                   self.labels[a:a + self.block])


@pytest.mark.parametrize("eval_every", [1, 2])
def test_fit_spans_each_block(tmp_path, eval_every, capsys):
    """Two blocks of two steps: one upload and one loop of steps a block,
    one ``train_eval`` an evaluation, around each evaluation's work."""
    with profiling.maybe_trace(str(tmp_path)):
        train.fit(Rows(16, 8, 0), Rows(6, 8, 1), 3, epochs=1, batch_size=4,
                  eval_every_blocks=eval_every, device="cpu")
    capsys.readouterr()
    spans = traced_spans(tmp_path)
    seq = [s[0] for s in spans if s[0] in ("train_upload", "train_steps",
                                            "train_eval")]
    block = ["train_upload", "train_steps"]
    if eval_every == 1:
        assert seq == (block + ["train_eval"]) * 2
    else:
        assert seq == block * 2 + ["train_eval"]
    ups, loops = named(spans, "train_upload"), named(spans, "train_steps")
    assert all(u[2] <= s[1] for u, s in zip(ups, loops))


@pytest.mark.parametrize("profiler_on", [False, True])
def test_span_is_free_without_a_profiler(tmp_path, profiler_on):
    """With no profiler, every span is the one shared null context and
    calls nothing of torch's; under a profiler it is torch's span."""
    calls = []
    real = torch.profiler.record_function

    def recorded(name):
        calls.append(name)
        return real(name)

    with mock.patch.object(torch.profiler, "record_function", recorded):
        if not profiler_on:
            first, second = profiling.span("a"), profiling.span("b")
            assert first is second is profiling._OFF
            with profiling.span("c"):
                pass
            assert calls == []
        else:
            with profiling.maybe_trace(str(tmp_path)):
                with profiling.span("c"):
                    pass
            assert calls == ["c"]
            assert [s[0] for s in traced_spans(tmp_path)] == ["c"]
