"""Padded point-cloud and grasp containers (port of gpd_tpu/core/types.py).

Dataclasses of tensors with validity masks, so every stage works on fixed
shapes:

  - ``points``/``normals`` are (N, 3) float32 rows;
  - ``cam_source`` is an (N,) int64 bitmask (bit k = seen by camera k). The
    JAX package holds it as uint32; int64 keeps the bit tests (``>>``, ``&``)
    available on every torch build and holds the same values;
  - padded slots have ``mask == False`` and coordinates at ``PAD_COORD`` so
    they never enter a radius neighborhood.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpd_tpu_torch import resolve_device

# Far-away coordinate for padded points: outside any plausible workspace,
# keeps distance math finite.
PAD_COORD = 1.0e6


def _next_size(n: int, minimum: int = 256) -> int:
    """Round up to a padded size: pow2 x {1.25, 1.5, 1.75, 2} multiples of
    128 (at most ~12.5% waste)."""
    s = minimum
    while s < n:
        s *= 2
    if s == minimum:
        return s
    half = s // 2
    for c in (half + half // 4, half + half // 2, half + 3 * half // 4):
        if c >= n and c % 128 == 0:
            return c
    return s


@dataclasses.dataclass
class CloudArrays:
    """Padded point cloud = the reference's processed Cloud."""

    points: torch.Tensor        # (N, 3) f32
    normals: torch.Tensor       # (N, 3) f32 (zeros until estimated)
    cam_source: torch.Tensor    # (N,) int64 bitmask
    mask: torch.Tensor          # (N,) bool
    view_points: torch.Tensor   # (V, 3) f32 camera positions

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def num_cameras(self) -> int:
        return self.view_points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        return self.mask.sum()

    @staticmethod
    def from_numpy(points: np.ndarray,
                   view_points: Optional[np.ndarray] = None,
                   cam_source: Optional[np.ndarray] = None,
                   normals: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None,
                   device=None) -> "CloudArrays":
        """Padded CloudArrays from host arrays on ``device`` (CUDA unless
        named). ``view_points`` is (V, 3); ``cam_source`` is None (one
        camera: every point bit 0), an (N,) bitmask or a (V, N) 0/1 matrix
        (reference: src/gpd/util/cloud.cpp:11-152)."""
        device = resolve_device(device)
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        n = points.shape[0]
        cap = capacity or _next_size(n)
        if view_points is None:
            view_points = np.zeros((1, 3), np.float32)
        view_points = np.asarray(view_points, dtype=np.float32).reshape(-1, 3)

        if cam_source is None:
            cs = np.ones(n, dtype=np.int64)
        else:
            cam_source = np.asarray(cam_source)
            if cam_source.ndim == 2:
                bits = (cam_source != 0).astype(np.int64)
                cs = np.zeros(n, dtype=np.int64)
                for k in range(bits.shape[0]):
                    cs |= bits[k] << k
            else:
                cs = cam_source.astype(np.int64)

        pts = np.full((cap, 3), PAD_COORD, dtype=np.float32)
        pts[:n] = points
        nrm = np.zeros((cap, 3), dtype=np.float32)
        if normals is not None:
            nrm[:n] = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        cs_pad = np.zeros(cap, dtype=np.int64)
        cs_pad[:n] = cs
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True

        def t(a):
            return torch.from_numpy(a).to(device)

        return CloudArrays(points=t(pts), normals=t(nrm), cam_source=t(cs_pad),
                           mask=t(mask), view_points=t(view_points))

    def compact_host(self, capacity: Optional[int] = None) -> "CloudArrays":
        """Drop padded slots (one host copy) and re-pad to a snug bucket, or
        to a caller-fixed ``capacity``."""
        mask = self.mask.cpu().numpy()
        idx = np.nonzero(mask)[0]
        return CloudArrays.from_numpy(
            self.points.cpu().numpy()[idx],
            view_points=self.view_points.cpu().numpy(),
            cam_source=self.cam_source.cpu().numpy()[idx],
            normals=self.normals.cpu().numpy()[idx],
            capacity=capacity, device=self.device)


@dataclasses.dataclass
class Samples:
    """Padded sample set: xyz positions and a validity mask
    (gpd_tpu/core/types.py:139-156)."""

    positions: torch.Tensor     # (S, 3) f32
    mask: torch.Tensor          # (S,) bool

    @staticmethod
    def from_numpy(positions: np.ndarray, capacity: Optional[int] = None,
                   device=None) -> "Samples":
        """Positions padded with PAD_COORD to ``capacity`` rows (by default
        ``_next_size`` with a minimum of 8) on ``device`` (CUDA unless
        named)."""
        device = resolve_device(device)
        positions = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
        s = positions.shape[0]
        cap = capacity or _next_size(s, minimum=8)
        pos = np.full((cap, 3), PAD_COORD, dtype=np.float32)
        pos[:s] = positions
        mask = np.zeros(cap, dtype=bool)
        mask[:s] = True
        return Samples(positions=torch.from_numpy(pos).to(device),
                       mask=torch.from_numpy(mask).to(device))


@dataclasses.dataclass
class Grasps:
    """Struct-of-arrays grasp batch = the reference's vector<Hand>
    (include/gpd/candidate/hand.h). Flat over (sample x axis x orientation)."""

    position: torch.Tensor       # (G, 3) f32: hand bottom-center in world
    orientation: torch.Tensor    # (G, 3, 3) f32: columns approach/binormal/axis
    sample: torch.Tensor         # (G, 3) f32
    width: torch.Tensor          # (G,) f32 grasp aperture
    score: torch.Tensor          # (G,) f32 classifier score
    bottom: torch.Tensor         # (G,) f32 closing-box bottom (hand frame x)
    top: torch.Tensor            # (G,) f32 closing-box top
    center: torch.Tensor         # (G,) f32 closing-box lateral center
    finger_placement: torch.Tensor  # (G,) int64
    full_antipodal: torch.Tensor    # (G,) bool
    half_antipodal: torch.Tensor    # (G,) bool
    valid: torch.Tensor             # (G,) bool
    sample_id: torch.Tensor         # (G,) int64: originating sample index

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    @property
    def approach(self) -> torch.Tensor:
        return self.orientation[..., :, 0]

    @property
    def binormal(self) -> torch.Tensor:
        return self.orientation[..., :, 1]

    @property
    def axis(self) -> torch.Tensor:
        return self.orientation[..., :, 2]

    def take(self, idx) -> "Grasps":
        return Grasps(**{f.name: getattr(self, f.name)[idx]
                         for f in dataclasses.fields(self)})

    def to_host(self) -> "Grasps":
        """Every field as a numpy array (one copy per field, no per-grasp
        fetches)."""
        return Grasps(**{f.name: getattr(self, f.name).cpu().numpy()
                         for f in dataclasses.fields(self)})

    def to_host_list(self):
        """The valid grasps as a list of dicts of host values (for printing
        and CSV)."""
        h = self.to_host()
        return [dict(position=h.position[i], orientation=h.orientation[i],
                     sample=h.sample[i], width=float(h.width[i]),
                     score=float(h.score[i]), bottom=float(h.bottom[i]),
                     top=float(h.top[i]), center=float(h.center[i]),
                     finger_placement=int(h.finger_placement[i]),
                     full_antipodal=bool(h.full_antipodal[i]),
                     half_antipodal=bool(h.half_antipodal[i]))
                for i in np.nonzero(h.valid)[0]]


def write_grasps_csv(path: str, grasps: Grasps) -> None:
    """CSV export with Hand::writeHandsToFile's columns
    (src/gpd/candidate/hand.cpp:48-68): position, axis, approach, binormal,
    grasp width, one valid grasp a row."""
    rows = []
    for g in grasps.to_host_list():
        R = g["orientation"]
        vals = list(g["position"]) + list(R[:, 2]) + list(R[:, 0]) + \
            list(R[:, 1]) + [g["width"]]
        rows.append(",".join(f"{v:.6f}" for v in vals))
    with open(path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
