"""The benchmark's one traffic generator. A traffic mix is a data file,
``traffic/<mix>.json``; its ``kind`` says which inputs it asks for and its
other keys their parameters:

- ``fused_table``: table scenes of ``make_scene`` (``objects`` objects, 0
  for its own draw of 2-4), each captured by ``cameras`` cameras and fused;
  one scene per entry of ``scene_seeds``.
- ``single_camera_table``: the same scenes seen by the one camera of
  ``view_cameras(default_rng(camera_seed), 1)``, as ascii PCD files.
- ``train_blocks``: a training set of ``train_instances`` and a test set
  of ``test_instances`` images (size x size x channels uint8) with 0/1
  labels, made on the device from the run's seed.

The scenes, objects and the detector's draws come from the fixed seeds in
the mix, so every run seed sends the same work; the run's seed orders the
requests, picks the checked ones and draws the training data.
"""

from __future__ import annotations

import os
from typing import Iterator, List

import numpy as np

from h100_bench.inputs import synthetic as syn


def table_scenes(mix: dict) -> List[dict]:
    """``fused_table``: per scene seed {points, cam_source, view_points}."""
    out = []
    for s in mix["scene_seeds"]:
        rng = np.random.default_rng(s)
        pts, nrm = syn.make_scene(rng, n_objects=mix["objects"])
        cams = syn.view_cameras(rng, mix["cameras"])
        p, cs, vp = syn.render_fused_views(rng, pts, nrm, cams)
        out.append(dict(points=p, cam_source=cs, view_points=vp))
    return out


def single_camera_scenes(mix: dict) -> List[np.ndarray]:
    """``single_camera_table``: per scene seed the points one camera sees."""
    cam = syn.view_cameras(np.random.default_rng(mix["camera_seed"]), 1)
    out = []
    for s in mix["scene_seeds"]:
        rng = np.random.default_rng(s)
        pts, nrm = syn.make_scene(rng, n_objects=mix["objects"])
        out.append(syn.render_fused_views(rng, pts, nrm, cam)[0])
    return out


def write_pcd(path: str, points: np.ndarray) -> None:
    """An ascii PCD of xyz points (PCD v0.7, the reference's tools' files)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "w") as f:
        f.write("# .PCD v.7 - Point Cloud Data file format\nVERSION .7\n"
                "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {n}\nDATA ascii\n")
        np.savetxt(f, points, fmt="%.6f")


def read_pcd(path: str) -> np.ndarray:
    """The xyz points of an ascii PCD file written by ``write_pcd``."""
    with open(path) as f:
        for line in f:
            if line.startswith("DATA"):
                break
        return np.loadtxt(f, dtype=np.float32, ndmin=2)[:, :3]


def pcd_files(mix: dict, directory: str) -> List[str]:
    paths = []
    for i, p in enumerate(single_camera_scenes(mix)):
        paths.append(os.path.join(directory, f"scene_{i:02d}.pcd"))
        write_pcd(paths[-1], p)
    return paths


def order(seed: int, n: int) -> Iterator[int]:
    """Indices into a pool of ``n``, without end: seeded permutations of
    the pool, one after another, so every entry is sent as often as the
    others."""
    rng = np.random.default_rng(seed)
    while True:
        yield from (int(i) for i in rng.permutation(n))


def stream_seed(seed: int, index: int) -> int:
    """The draws' seed of pool entry ``index`` under ``seed`` (a traffic
    mix's ``draw_seed``; the run's seed for training data): a request for
    the same entry draws the same samples, as the port's default generator
    does for the same cloud, and every run seed sends the same work."""
    return (seed * 1_000_003 + index * 7919 + 1) % (1 << 62)


def train_data(mix: dict, seed: int, device):
    """``train_blocks``: (train images, train labels, test images, test
    labels) as host numpy arrays, drawn on ``device`` from ``seed`` in a
    few large calls."""
    import torch
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 0))
    shape = (mix["size"], mix["size"], mix["channels"])

    def draw(n, chunk=8192):
        # Sparse images like grasp images: most cells empty.
        img = np.empty((n, *shape), np.uint8)
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            v = torch.randint(0, 256, (b - a, *shape), generator=g,
                              device=device, dtype=torch.uint8)
            keep = torch.rand((b - a, *shape), generator=g,
                              device=device) < mix["occupancy"]
            img[a:b] = (v * keep).cpu().numpy()
        lab = (torch.rand(n, generator=g, device=device)
               < mix["positive_share"]).to(torch.int32).cpu().numpy()
        return img, lab
    return (*draw(mix["train_instances"]), *draw(mix["test_instances"]))
