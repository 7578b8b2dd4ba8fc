"""Stable functional API (port of gpd_tpu/api.py).

The reference's C-ABI binding surface (src/detect_grasps_python.cpp:
detectGraspsInCloud :431, detectGraspsInFile :468, calcGraspDescriptors
:579) as plain functions returning NumPy structures, one per extern-C entry
point. Each takes a config (a ``DetectorConfig``, a cfg path, or a
``GraspDetector`` to reuse), a ``seed`` for a ``torch.Generator`` on the
detector's device, and ``device`` (CUDA unless named; ignored when a
detector is passed).

A device keeps one detector per process, as gpd_tpu's module-level jitted
programs serve every call: calls with an equal config on the same device
reuse its captured graphs. Another config, or a changed weights file,
replaces it (new weights load as they do in gpd_tpu), so the card holds
one detector's graphs, not one per config a caller has used.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gpd_tpu_torch import resolve_device
from gpd_tpu_torch.config import load_config
from gpd_tpu_torch.detector import GraspDetector
from gpd_tpu_torch.io.pcd import load_cloud_file

# The process's detector on each device: device -> (config, weights stamp,
# detector).
_DETECTORS = {}


def _weights_stamp(cfg) -> Optional[tuple]:
    """The configured weights file's (path, st_mtime_ns, size), or None
    where there is no such file."""
    try:
        st = os.stat(cfg.weights_file)
    except OSError:
        return None
    return cfg.weights_file, st.st_mtime_ns, st.st_size


def _device_key(device) -> torch.device:
    """The resolved device, with the current card's index where CUDA is
    named without one: 'cuda' and 'cuda:0' are one card."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _as_detector(config, device) -> GraspDetector:
    """The caller's detector, or the process's detector on the resolved
    device, made anew (from the config, loaded if a path) where there is
    none, its config differs or its weights file has changed since."""
    if isinstance(config, GraspDetector):
        return config
    cfg = load_config(config) if isinstance(config, str) else config
    device = _device_key(device)
    stamp = _weights_stamp(cfg)
    entry = _DETECTORS.get(device)
    if entry is None or entry[:2] != (cfg, stamp):
        # The old detector, and its graphs, go first.
        _DETECTORS.pop(device, None)
        entry = _DETECTORS[device] = (cfg, stamp,
                                      GraspDetector(cfg, device=device))
    return entry[2]


def _generator(det: GraspDetector, seed: int) -> torch.Generator:
    return torch.Generator(device=det.device).manual_seed(seed)


def _view_points(det: GraspDetector, view_points) -> np.ndarray:
    if view_points is None:
        return np.asarray(det.cfg.camera_position, np.float32).reshape(-1, 3)
    return view_points


def detect_grasps_in_cloud(config, points: np.ndarray,
                           view_points: Optional[np.ndarray] = None,
                           normals: Optional[np.ndarray] = None,
                           cam_source: Optional[np.ndarray] = None,
                           seed: int = 0, device=None) -> List[Dict]:
    """Cloud (N, 3) -> list of grasp dicts (detectGraspsInCloud :431), at
    the serving capacity buckets."""
    det = _as_detector(config, device)
    cloud = det.preprocess_cloud(points, view_points=_view_points(
        det, view_points), normals=normals, cam_source=cam_source,
        capacity="serve")
    grasps = det.detect(cloud, generator=_generator(det, seed), verbose=False)
    return grasps.to_host_list()


def detect_grasps_in_file(config, pcd_path: str, seed: int = 0,
                          device=None) -> List[Dict]:
    """PCD or PLY path -> grasps (detectGraspsInFile :468)."""
    det = _as_detector(config, device)
    return detect_grasps_in_cloud(det, load_cloud_file(pcd_path), seed=seed)


def calc_grasp_descriptors(config, points: np.ndarray,
                           view_points: Optional[np.ndarray] = None,
                           seed: int = 0, device=None
                           ) -> Tuple[List[Dict], np.ndarray]:
    """Cloud -> (grasps, images (G, size, size, C) uint8)
    (calcGraspDescriptors :579): the scored candidates and their grasp
    images, without selection. As gpd_tpu's: snug capacities and the
    configured neighbor caps (``det.cfg``, not ``effective_config``), by
    the detector's programs (``candidates_with_images``)."""
    det = _as_detector(config, device)
    cloud = det.preprocess_cloud(points, view_points=_view_points(
        det, view_points))
    grasps, images, n_valid = det.candidates_with_images(
        cloud, _generator(det, seed), det.cfg)
    return grasps.to_host_list(), images[:n_valid].cpu().numpy()
