"""Configuration system for gpd_tpu_torch (a copy of gpd_tpu/config.py:21-369,
kept here so the port never imports the JAX package).

Parses the same ``key = value`` / ``#``-comment grammar as the reference's
``util::ConfigFile`` (reference: src/gpd/util/config_file.cpp:6-110), so the
reference's shipped ``cfg/*.cfg`` files run unchanged, and maps the keys onto
typed dataclasses consumed by the detector.

Composition follows the reference (src/gpd/grasp_detector.cpp:13-17,121-125):
``hand_geometry_filename`` / ``image_geometry_filename`` point at sub-config
files; the literal value ``0`` means "inline in the same file".
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence


class ConfigFile:
    """``key = value`` parser, grammar-compatible with the reference.

    Reference behavior replicated (src/gpd/util/config_file.cpp):
      - ``#`` starts a comment (rest of line dropped),
      - blank / whitespace-only lines skipped,
      - key = text before first ``=`` truncated at first whitespace,
      - value = text after first ``=``, trimmed of tabs/spaces,
      - first occurrence of a duplicate key wins.
    """

    def __init__(self, path: Optional[str] = None, text: Optional[str] = None):
        self.contents: Dict[str, str] = {}
        if path is not None:
            with open(path, "r") as f:
                text = f.read()
        if text is not None:
            self._parse(text)

    def _parse(self, text: str) -> None:
        for raw in text.splitlines():
            line = raw.split("#", 1)[0]
            if not line.strip():
                continue
            if "=" not in line:
                continue
            line = line.lstrip("\t ")
            key, _, value = line.partition("=")
            key = key.split()[0] if key.split() else ""
            value = value.strip("\t ")
            if not key or not value:
                continue
            if key not in self.contents:
                self.contents[key] = value

    # Typed getters mirroring getValueOfKey<T> (config_file.h:81-82).
    def get_str(self, key: str, default: str = "") -> str:
        return self.contents.get(key, default)

    def get_bool(self, key: str, default: bool = False) -> bool:
        if key not in self.contents:
            return default
        v = self.contents[key].strip()
        # C++ stringstream >> bool accepts 0/1; anything else -> false-ish.
        try:
            return bool(int(v.split()[0]))
        except ValueError:
            return v.lower() in ("true",)

    def get_int(self, key: str, default: int = 0) -> int:
        if key not in self.contents:
            return default
        try:
            return int(float(self.contents[key].split()[0]))
        except (ValueError, IndexError):
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        if key not in self.contents:
            return default
        try:
            return float(self.contents[key].split()[0])
        except (ValueError, IndexError):
            return default

    def get_float_list(self, key: str, default: str = "") -> List[float]:
        v = self.contents.get(key, default)
        return [float(x) for x in v.split()]

    def get_int_list(self, key: str, default: str = "") -> List[int]:
        v = self.contents.get(key, default)
        return [int(x) for x in v.split()]


@dataclasses.dataclass(frozen=True)
class HandGeometry:
    """Robot hand geometry (reference: include/gpd/candidate/hand_geometry.h).

    Defaults match hand_geometry.cpp:23-32 / cfg/hand_geometry.cfg.
    """

    finger_width: float = 0.01
    outer_diameter: float = 0.12
    depth: float = 0.06          # finger length
    height: float = 0.02
    init_bite: float = 0.01

    @staticmethod
    def from_config(cfg: ConfigFile) -> "HandGeometry":
        return HandGeometry(
            finger_width=cfg.get_float("finger_width", 0.01),
            outer_diameter=cfg.get_float("hand_outer_diameter", 0.12),
            depth=cfg.get_float("hand_depth", 0.06),
            height=cfg.get_float("hand_height", 0.02),
            init_bite=cfg.get_float("init_bite", 0.01),
        )

    @property
    def max_grasp_width(self) -> float:
        return self.outer_diameter - 2.0 * self.finger_width

    def deepen_depths(self, step: float = 0.005) -> List[float]:
        """The exact sequence of depths tried by FingerHand::deepenHand
        (reference: src/gpd/candidate/finger_hand.cpp:107-139), including its
        float-accumulation loop semantics."""
        depths = []
        d = self.init_bite + step
        while d <= self.depth:
            depths.append(d)
            d += step
        return depths


@dataclasses.dataclass(frozen=True)
class ImageGeometry:
    """Grasp-image volume/raster geometry (include/gpd/descriptor/image_geometry.h)."""

    outer_diameter: float = 0.10  # volume_width
    depth: float = 0.06           # volume_depth
    height: float = 0.02          # volume_height
    size: int = 60
    num_channels: int = 15

    @staticmethod
    def from_config(cfg: ConfigFile) -> "ImageGeometry":
        return ImageGeometry(
            outer_diameter=cfg.get_float("volume_width", 0.10),
            depth=cfg.get_float("volume_depth", 0.06),
            height=cfg.get_float("volume_height", 0.02),
            size=cfg.get_int("image_size", 60),
            num_channels=cfg.get_int("image_num_channels", 15),
        )


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """All detector parameters (reference: src/gpd/grasp_detector.cpp:5-190)."""

    hand_geometry: HandGeometry = HandGeometry()
    image_geometry: ImageGeometry = ImageGeometry()

    # Preprocessing (CandidatesGenerator::Parameters).
    num_samples: int = 1000
    num_threads: int = 1
    remove_outliers: bool = False
    sample_above_plane: bool = False
    voxelize: bool = True
    voxel_size: float = 0.003
    normals_radius: float = 0.03
    refine_normals_k: int = 0
    workspace: Sequence[float] = (-1, 1, -1, 1, -1, 1)
    camera_position: Sequence[float] = (0.0, 0.0, 0.0)

    # Hand search (HandSearch::Parameters).
    nn_radius_frames: float = 0.01
    num_orientations: int = 8
    num_finger_placements: int = 10
    deepen_hand: bool = True
    hand_axes: Sequence[int] = (2,)
    friction_coeff: float = 20.0
    min_viable: int = 6

    # Classifier.
    model_file: str = ""
    weights_file: str = ""
    batch_size: int = 1
    min_score: float = 0.0

    # Descriptor.
    remove_plane_before_image_calculation: bool = False

    # Candidate filtering.
    workspace_grasps: Sequence[float] = (-1, 1, -1, 1, -1, 1)
    min_aperture: float = 0.0
    max_aperture: float = 0.085
    filter_approach_direction: bool = False
    direction: Sequence[float] = (1.0, 0.0, 0.0)
    thresh_rad: float = 2.3

    # Clustering + selection.
    min_inliers: int = 1
    num_selected: int = 100

    centered_at_origin: bool = False

    # Padded neighborhood caps (no reference equivalent).
    max_cloud_points: int = 0        # 0 = auto (next pow2 of the cloud)
    frame_neighbors_cap: int = 64    # K for local-frame estimation
    search_neighbors_cap: int = 4096  # K for hand search neighborhoods
                                      # (auto-clamped to the cloud size)
    search_identity_max: int = 131072  # clouds up to this size run the hand
                                      # search on IDENTITY neighborhoods
                                      # (whole cloud + in-radius mask): sort-
                                      # free and uncapped, the reference's
                                      # kd-tree semantics
    image_neighbors_cap: int = 2048   # K for descriptor neighborhoods (the
                                      # image volume is far smaller than the
                                      # search ball; nearest-K covers it)
    normals_neighbors_cap: int = 128  # K for normal estimation
    shadow_voxel_cap: int = 2048     # max unique shadow voxels per sample
    shadow_source_cap: int = 184     # max neighborhood points casting
                                     # shadows: 184 sources x 33 ray points
                                     # still fill the 2048-voxel cap

    @property
    def hand_search_radius(self) -> float:
        """nn radius for candidate search (hand_search.cpp:13-17)."""
        hg = self.hand_geometry
        return max(hg.outer_diameter - hg.finger_width, hg.depth, hg.height / 2.0)

    @property
    def image_radius(self) -> float:
        """nn radius for descriptor extraction (image_generator.cpp:43-46)."""
        ig = self.image_geometry
        return max(ig.depth, ig.height / 2.0, ig.outer_diameter)

    @property
    def angles(self) -> List[float]:
        """Orientation angles: linspace(-pi/2, pi/2, O+1)[:O]
        (hand_search.cpp:151-155)."""
        n = self.num_orientations
        return [-math.pi / 2.0 + math.pi * i / n for i in range(n)]


def _resolve_subconfig(path_value: str, config_path: str) -> Optional[str]:
    """hand_geometry_filename == "0" means inline (grasp_detector.cpp:13-17)."""
    if path_value == "0":
        return config_path
    if not path_value:
        return None
    if not os.path.isabs(path_value) and config_path:
        # Reference resolves relative to the process CWD; we additionally try
        # relative to the config file so configs work from anywhere.
        cand = os.path.join(os.path.dirname(os.path.abspath(config_path)), path_value)
        if os.path.exists(cand) and not os.path.exists(path_value):
            return cand
    return path_value


def load_config(path: str) -> DetectorConfig:
    """Load a DetectorConfig from a reference-compatible .cfg file."""
    cfg = ConfigFile(path)

    hand_file = _resolve_subconfig(cfg.get_str("hand_geometry_filename", ""), path)
    if hand_file and hand_file != path and os.path.exists(hand_file):
        hand_cfg = ConfigFile(hand_file)
    else:
        hand_cfg = cfg
    hand_geom = HandGeometry.from_config(hand_cfg)

    image_file = _resolve_subconfig(cfg.get_str("image_geometry_filename", ""), path)
    if image_file and image_file != path and os.path.exists(image_file):
        image_cfg = ConfigFile(image_file)
    else:
        image_cfg = cfg
    image_geom = ImageGeometry.from_config(image_cfg)

    weights = cfg.get_str("weights_file", "")
    if weights and not os.path.isabs(weights):
        cand = os.path.join(os.path.dirname(os.path.abspath(path)), weights)
        if os.path.exists(cand) and not os.path.exists(weights):
            weights = cand

    return DetectorConfig(
        hand_geometry=hand_geom,
        image_geometry=image_geom,
        num_samples=cfg.get_int("num_samples", 1000),
        num_threads=cfg.get_int("num_threads", 1),
        remove_outliers=cfg.get_bool("remove_outliers", False),
        sample_above_plane=cfg.get_bool("sample_above_plane", False),
        voxelize=cfg.get_bool("voxelize", True),
        voxel_size=cfg.get_float("voxel_size", 0.003),
        normals_radius=cfg.get_float("normals_radius", 0.03),
        refine_normals_k=cfg.get_int("refine_normals_k", 0),
        workspace=tuple(cfg.get_float_list("workspace", "-1 1 -1 1 -1 1")),
        camera_position=tuple(cfg.get_float_list("camera_position", "0.0 0.0 0.0")),
        nn_radius_frames=cfg.get_float("nn_radius", 0.01),
        num_orientations=cfg.get_int("num_orientations", 8),
        num_finger_placements=cfg.get_int("num_finger_placements", 10),
        deepen_hand=cfg.get_bool("deepen_hand", True),
        hand_axes=tuple(cfg.get_int_list("hand_axes", "2")),
        friction_coeff=cfg.get_float("friction_coeff", 20.0),
        min_viable=cfg.get_int("min_viable", 6),
        model_file=cfg.get_str("model_file", ""),
        weights_file=weights,
        batch_size=cfg.get_int("batch_size", 1),
        min_score=cfg.get_float("min_score", 0.0),
        remove_plane_before_image_calculation=cfg.get_bool(
            "remove_plane_before_image_calculation", False),
        workspace_grasps=tuple(
            cfg.get_float_list("workspace_grasps", "-1 1 -1 1 -1 1")),
        min_aperture=cfg.get_float("min_aperture", 0.0),
        max_aperture=cfg.get_float("max_aperture", 0.085),
        filter_approach_direction=cfg.get_bool("filter_approach_direction", False),
        direction=tuple(cfg.get_float_list("direction", "1 0 0")),
        thresh_rad=cfg.get_float("thresh_rad", 2.3),
        min_inliers=cfg.get_int("min_inliers", 1),
        num_selected=cfg.get_int("num_selected", 100),
        centered_at_origin=cfg.get_bool("centered_at_origin", False),
    )


@dataclasses.dataclass(frozen=True)
class CEMConfig:
    """Sequential importance sampling parameters
    (reference: src/gpd/sequential_importance_sampling.cpp:11-52; a copy of
    gpd_tpu/config.py:345-369)."""

    num_init_samples: int = 50
    num_iterations: int = 5
    num_samples_per_iteration: int = 50
    prob_rand_samples: float = 0.3
    standard_deviation: float = 0.02
    sampling_method: int = 0  # 0 = SUM_OF_GAUSSIANS, 1 = MAX_OF_GAUSSIANS
    min_score: float = 0.0

    @staticmethod
    def from_file(path: str) -> "CEMConfig":
        cfg = ConfigFile(path)
        return CEMConfig(
            num_init_samples=cfg.get_int("num_init_samples", 50),
            num_iterations=cfg.get_int("num_iterations", 5),
            num_samples_per_iteration=cfg.get_int("num_samples_per_iteration", 50),
            prob_rand_samples=cfg.get_float("prob_rand_samples", 0.3),
            standard_deviation=cfg.get_float("standard_deviation", 0.02),
            sampling_method=cfg.get_int("sampling_method", 0),
            min_score=cfg.get_float("min_score", 0.0),
        )
