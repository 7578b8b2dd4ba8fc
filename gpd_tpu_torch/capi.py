"""Flat-array marshaling layer for the port's C ABI (port of
gpd_tpu/capi.py; the C side is gpd_tpu_torch/csrc/gpd_c_api.cpp).

The reference exposes grasp detection to C callers through an ``extern "C"``
binding (reference: src/detect_grasps_python.cpp: detectGraspsInCloud :431,
detectGraspsInFile :468, calcGraspDescriptors :579). The port's binding, as
gpd_tpu's, embeds CPython and calls the functions here; every return value
is one contiguous float64/uint8 NumPy array, which the C side reads through
the buffer protocol without the NumPy C API.

Detectors run on the module's device: CUDA unless ``set_device`` (the C
ABI's ``gpd_init``) names another. Each call seeds a ``torch.Generator`` on
the detector's device with ``seed``.

Grasp row layout (GRASP_FLOATS columns, float64):
  [0:3]   position (hand bottom-center, world frame)
  [3:12]  orientation, row-major 3x3 (columns approach/binormal/axis)
  [12:15] sample
  [15]    width
  [16]    score
  [17]    full_antipodal (0/1)
  [18]    half_antipodal (0/1)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpd_tpu_torch.detector import GraspDetector, detect_core

GRASP_FLOATS = 19

_device = None
_detectors = {}
_next_handle = 1


def set_device(device=None) -> None:
    """The device of detectors created from now on: "cuda" (the default,
    also for None or "") or "cpu"."""
    global _device
    _device = device or None


def _grasps_to_flat(grasps) -> np.ndarray:
    h = grasps.to_host()
    keep = np.nonzero(h.valid)[0]
    out = np.empty((len(keep), GRASP_FLOATS), np.float64)
    out[:, 0:3] = h.position[keep]
    out[:, 3:12] = h.orientation[keep].reshape(len(keep), 9)
    out[:, 12:15] = h.sample[keep]
    out[:, 15] = h.width[keep]
    out[:, 16] = h.score[keep]
    out[:, 17] = h.full_antipodal[keep]
    out[:, 18] = h.half_antipodal[keep]
    return out


def _generator(det: GraspDetector, seed: int) -> torch.Generator:
    return torch.Generator(device=det.device).manual_seed(seed)


def create_detector(cfg_path: str) -> int:
    """Build a GraspDetector from a .cfg file; returns an opaque handle."""
    global _next_handle
    det = GraspDetector(cfg_path, device=_device)
    handle = _next_handle
    _next_handle += 1
    _detectors[handle] = det
    return handle


def destroy_detector(handle: int) -> None:
    _detectors.pop(handle, None)


def detect_in_file(handle: int, pcd_path: str, seed: int = 0) -> np.ndarray:
    """detectGraspsInFile equivalent: -> (G, GRASP_FLOATS) float64."""
    det = _detectors[handle]
    grasps = det.detect_file(pcd_path, generator=_generator(det, seed),
                             verbose=False)
    return _grasps_to_flat(grasps)


def _cloud_from_flat(det: GraspDetector, points: np.ndarray,
                     view_points: Optional[np.ndarray],
                     cam_source: Optional[np.ndarray]):
    if view_points is None or view_points.size == 0:
        view_points = np.asarray(det.cfg.camera_position,
                                 np.float32).reshape(-1, 3)
    if cam_source is not None:
        # uint32 bitmasks from C; the port holds them as int64.
        cam_source = np.asarray(cam_source).astype(np.int64)
    return det.preprocess_cloud(points, view_points=view_points,
                                cam_source=cam_source)


def detect_in_cloud(handle: int, points: np.ndarray,
                    view_points: Optional[np.ndarray] = None,
                    cam_source: Optional[np.ndarray] = None,
                    seed: int = 0) -> np.ndarray:
    """detectGraspsInCloud equivalent: points (N,3) float32 ->
    (G, GRASP_FLOATS) float64."""
    det = _detectors[handle]
    cloud = _cloud_from_flat(det, points, view_points, cam_source)
    grasps = det.detect(cloud, generator=_generator(det, seed),
                        verbose=False)
    return _grasps_to_flat(grasps)


def calc_descriptors(handle: int, points: np.ndarray,
                     view_points: Optional[np.ndarray] = None,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """calcGraspDescriptors equivalent: -> (grasp rows (G, GRASP_FLOATS),
    images (G, s, s, C) uint8, C-contiguous)."""
    det = _detectors[handle]
    cloud = _cloud_from_flat(det, points, view_points, None)
    gen = _generator(det, seed)
    spos, smask = det.sample_cloud(cloud, gen)
    grasps, images = detect_core(cloud, spos, smask, det.net, gen,
                                 det.effective_config(cloud),
                                 det.image_cap(spos.shape[0]))
    rows = _grasps_to_flat(grasps)
    valid = grasps.valid.cpu().numpy()
    return rows, np.ascontiguousarray(images.cpu().numpy()[valid])
