"""Stable functional API (port of gpd_tpu/api.py).

The reference's C-ABI binding surface (src/detect_grasps_python.cpp:
detectGraspsInCloud :431, detectGraspsInFile :468, calcGraspDescriptors
:579) as plain functions returning NumPy structures, one per extern-C entry
point. Each takes a config (a ``DetectorConfig``, a cfg path, or a
``GraspDetector`` to reuse), a ``seed`` for a ``torch.Generator`` on the
detector's device, and ``device`` (CUDA unless named; ignored when a
detector is passed).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gpd_tpu_torch.detector import GraspDetector, detect_core
from gpd_tpu_torch.io.pcd import load_cloud_file


def _as_detector(config, device) -> GraspDetector:
    if isinstance(config, GraspDetector):
        return config
    return GraspDetector(config, device=device)


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
    configured neighbor caps (``det.cfg``, not ``effective_config``)."""
    det = _as_detector(config, device)
    cloud = det.preprocess_cloud(points, view_points=_view_points(
        det, view_points))
    gen = _generator(det, seed)
    spos, smask = det.sample_cloud(cloud, gen)
    cap = det.image_cap(spos.shape[0])
    grasps, images = detect_core(cloud, spos, smask, det.net, gen, det.cfg,
                                 cap)
    valid = grasps.valid.cpu().numpy()
    return grasps.to_host_list(), images.cpu().numpy()[valid]
