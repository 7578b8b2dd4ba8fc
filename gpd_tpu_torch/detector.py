"""Grasp detection pipeline (port of gpd_tpu/detector.py).

The reference's ``GraspDetector`` (src/gpd/grasp_detector.cpp): host-side
preprocessing with one compaction, then the detection core (local frames,
hand search, filters, valid-first compaction, descriptors, CNN scores) and
selection, all on one device.

``GraspDetector.detect`` runs as gpd_tpu's jitted device programs
(detector.py:689-745) do, in three parts with one read back to the host
after the first: A, ``candidates_program`` (sampling, the hand search and
filters, and the counts the rest needs); the read of those counts; B,
``score_candidates`` over the live sample blocks and image chunks only
(gpd_tpu's ``lax.cond`` and ``while_loop`` skips, whose trip counts here
come from that read); C, ``select_and_cluster``. On a card each part is a
replay of a CUDA graph captured at the first request of its static key
(``graphs.Programs``); on the CPU the same parts run eagerly.
``detect_core`` and the staged route run eagerly, reading each count where
they need it; with ``host_reads=False`` (CEM's fused program) every
block runs, masked, and nothing is read back.

``GraspDetector.candidates_with_images`` runs A and B the same way, B with
the images, for data generation (``datagen.py``, whose relabeling is a
third program on the same graphs and pool) and ``api.calc_grasp_descriptors``.

``GraspDetector.preprocess_cloud`` runs gpd_tpu's preprocess programs
(detector.py:40-66, 623-642) the same way: workspace filter and voxels,
the outlier filter, normals, each a CUDA graph replay on a card and eager on
the CPU, with the host compactions between them.

Stage times are reported in the reference's format
(grasp_detector.cpp:313-320).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from gpd_tpu_torch import profiling, resolve_device
from gpd_tpu_torch import select as sel
from gpd_tpu_torch.config import DetectorConfig, load_config
from gpd_tpu_torch.core.types import CloudArrays, Grasps, _next_size
from gpd_tpu_torch.graphs import Programs, clone_tree
from gpd_tpu_torch.io.pcd import load_cloud_file
from gpd_tpu_torch.net import lenet
from gpd_tpu_torch.ops import candidates as cand
from gpd_tpu_torch.ops import draws
from gpd_tpu_torch.ops import images as img
from gpd_tpu_torch.ops import neighbors as nbr
from gpd_tpu_torch.ops import preprocess as pp
from gpd_tpu_torch.ops.frames import estimate_frames
from gpd_tpu_torch.ops.normals import (estimate_normals, refine_normals,
                                       reverse_normals_cloud)

# Sample-block size of the active-sample-compacted descriptor inputs: big
# sample sets have valid hands at a fraction of their samples, so samples
# are reordered active-first and whole inactive blocks are skipped.
_SAMPLE_BLOCK = 512


_SERVE_BUCKETS = (2048, 4096, 8192, 16384, 32768, 65536, 131072)


def serve_capacity(n_points: int) -> int:
    """Power-of-two capacity bucket of the serving entry points
    (``detect_file``, the CLI): gpd_tpu's ``serve_capacity``
    (detector.py:93). The padded capacity decides routes through
    ``effective_config`` (identity or nearest-K image neighborhoods, the
    hand-search cap), so the port buckets as gpd_tpu does to pick the same
    grasps."""
    for b in _SERVE_BUCKETS:
        if n_points <= b:
            return b
    return _next_size(n_points)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _compact_hands(grasps: Grasps, cap: int) -> Grasps:
    """Valid hands to the front (stable), ``cap`` slots kept: the
    reference's createImageList compaction (image_generator.cpp:91-98)."""
    return grasps.take(torch.argsort(~grasps.valid, stable=True)[:cap])


def _prep_filter_voxel(cloud: CloudArrays, workspace: tuple,
                       cell_size: float, do_voxel: bool) -> CloudArrays:
    """gpd_tpu's first preprocess program (detector.py:40-49): the workspace
    filter, then the voxel downsample if ``do_voxel``."""
    cloud = pp.filter_workspace(cloud, workspace)
    if do_voxel:
        cloud = pp.voxelize(cloud, cell_size)
    return cloud


# The statistical outlier filter's settings, gpd_tpu's defaults
# (ops/preprocess.py:149) as the reference sets them (cloud.cpp:166-174).
_OUTLIER_MEAN_K = 50
_OUTLIER_STDDEV_MULT = 1.0


def _prep_outliers(cloud: CloudArrays, mean_k: int,
                   stddev_mult: float) -> CloudArrays:
    """Statistical outlier removal as one program (gpd_tpu runs
    ``remove_statistical_outliers``' jitted ``_outlier_kernel``,
    ops/preprocess.py:101-146)."""
    return pp.remove_statistical_outliers(cloud, mean_k, stddev_mult)


def _prep_normals(cloud: CloudArrays, radius: float, do_estimate: bool,
                  refine_k: int, flip: bool) -> CloudArrays:
    """gpd_tpu's normals program (detector.py:52-66): normals estimated if
    ``do_estimate``, the reverse pass, the refinement if ``refine_k`` > 0
    (its loop on the device) and the flip if ``flip``."""
    if do_estimate:
        cloud = estimate_normals(cloud, radius)
    cloud = reverse_normals_cloud(cloud)
    if refine_k > 0:
        cloud = dataclasses.replace(cloud, normals=refine_normals(
            cloud.points, cloud.normals, cloud.mask, k=refine_k))
    if flip:
        cloud = dataclasses.replace(cloud, normals=-cloud.normals)
    return cloud


def candidates_stage(cloud: CloudArrays, sample_pos: torch.Tensor,
                     sample_mask: torch.Tensor, cfg: DetectorConfig,
                     host_reads: bool = True,
                     stats: Optional[dict] = None) -> Grasps:
    """Steps 1-2 of detectGrasps: frames -> hand search -> filters
    (grasp_detector.cpp:192-258). ``host_reads=False``: no read of a count
    back to the host (for CUDA graph capture). ``stats`` as in
    ``search_hands_with_frames``."""
    frames, fvalid = estimate_frames(
        sample_pos, sample_mask, cloud.points, cloud.mask, cloud.normals,
        radius=cfg.nn_radius_frames)
    return hands_at_frames(cloud, sample_pos, frames, fvalid, cfg, host_reads,
                           stats)


def hands_at_frames(cloud: CloudArrays, sample_pos: torch.Tensor,
                    frames: torch.Tensor, fvalid: torch.Tensor,
                    cfg: DetectorConfig, host_reads: bool = True,
                    stats: Optional[dict] = None) -> Grasps:
    """Step 2 of detectGrasps at given local frames (S, 3, 3) and their
    valid flags: the hand search, then the workspace/direction filters."""
    grasps = cand.search_hands_with_frames(cloud, sample_pos, frames, fvalid,
                                           cfg, host_reads, stats)
    hg = cfg.hand_geometry
    grasps = sel.filter_grasps_workspace(
        grasps, cfg.workspace_grasps, cfg.min_aperture, cfg.max_aperture,
        hg.outer_diameter, hg.depth)
    if cfg.filter_approach_direction:
        grasps = sel.filter_grasps_direction(grasps, cfg.direction,
                                             cfg.thresh_rad)
    return grasps


def image_point_mask(cloud: CloudArrays, generator: torch.Generator,
                     cfg: DetectorConfig) -> torch.Tensor:
    """Cloud-level point mask for descriptor extraction, shared by every
    sample: with remove_plane_before_image_calculation, the points off the
    RANSAC plane (image_generator.cpp:101-129)."""
    if not cfg.remove_plane_before_image_calculation:
        return cloud.mask
    inliers, _ = pp.fit_plane_ransac(cloud.points, cloud.mask, generator)
    return cloud.mask & ~inliers


def _shadow_shape(cloud: CloudArrays, cfg: DetectorConfig):
    """(sources k, points per source n_sp, voxel cap) of compute_shadows:
    up to shadow_source_cap of each sample's image neighborhood cast
    shadows."""
    k_img = min(cfg.image_neighbors_cap, cloud.capacity)
    k = min(cfg.shadow_source_cap, k_img)
    n_sp = img.num_shadow_points(cfg.image_geometry)
    return k, n_sp, min(cfg.shadow_voxel_cap, k * n_sp)


def shadow_noise(generator: torch.Generator, cloud: CloudArrays,
                 num_samples: int, cfg: DetectorConfig):
    """The shadow draws of every sample, in original sample order (None
    without a shadow channel)."""
    if cfg.image_geometry.num_channels != 15:
        return None
    k, n_sp, v_cap = _shadow_shape(cloud, cfg)
    return draws.shadow_noise(generator, num_samples, cloud.num_cameras, k,
                              n_sp, v_cap, cloud.device)


def _per_sample_inputs(cloud: CloudArrays, img_mask: torch.Tensor,
                       sample_pos: torch.Tensor, sample_mask: torch.Tensor,
                       noise, cfg: DetectorConfig, sample_uid=None):
    """Per-sample descriptor inputs for one block of samples: image-radius
    neighborhoods + shadow point sets (image_generator.cpp:17-70).

    ``sample_uid`` (S,) holds each row's ORIGINAL sample index; the shadow
    draws are taken by it, so results do not depend on how the sample axis
    is permuted or blocked."""
    # When the cap covers the cloud, identity neighborhoods (whole cloud +
    # in-radius mask, no gather, no sort); otherwise the nearest K, which
    # cover the (much smaller) image volume.
    k_img = min(cfg.image_neighbors_cap, cloud.capacity)
    if k_img >= cloud.capacity:
        nn_valid, nn_d2 = nbr.radius_mask(sample_pos, sample_mask,
                                          cloud.points, img_mask,
                                          cfg.image_radius)
        nn_idx = None
    else:
        nn_idx, nn_valid = nbr.radius_neighbors(
            sample_pos, sample_mask, cloud.points, img_mask,
            radius=cfg.image_radius, k=k_img, exact=True)
        nn_d2 = None

    if cfg.image_geometry.num_channels != 15:
        return nn_idx, nn_valid, None, None
    # Shadow sources: up to shadow_source_cap of the nearest neighborhood
    # points (occupied-voxel sets saturate quickly).
    width = nn_valid.shape[1]
    sc = min(cfg.shadow_source_cap, width)
    if sc < width:
        if nn_d2 is None:
            nn_d2 = nbr.sum_sq3(sample_pos[:, None, :] - cloud.points[nn_idx])
        negd, src_pos = nbr.select_max_k(
            torch.where(nn_valid, -nn_d2, -torch.inf), sc, exact=True)
        src_idx = (src_pos if nn_idx is None
                   else torch.gather(nn_idx, 1, src_pos))
        src_valid = negd > -torch.inf
    elif nn_idx is None:
        src_idx = torch.arange(width, device=nn_valid.device).expand(
            nn_valid.shape)
        src_valid = nn_valid
    else:
        src_idx, src_valid = nn_idx, nn_valid
    uid = (torch.arange(sample_pos.shape[0], device=sample_pos.device)
           if sample_uid is None else sample_uid)
    ig = cfg.image_geometry
    shadow_pts, shadow_valid = img.compute_shadows(
        cloud.points[src_idx], src_valid, cloud.cam_source[src_idx],
        cloud.view_points, img.shadow_length_of(ig),
        img.num_shadow_points(ig), cfg.shadow_voxel_cap,
        noise[0][uid], noise[1][uid])
    return nn_idx, nn_valid, shadow_pts, shadow_valid


def image_inputs_stage(cloud: CloudArrays, img_mask: torch.Tensor,
                       sample_pos: torch.Tensor, sample_mask: torch.Tensor,
                       noise, cfg: DetectorConfig):
    """Shared per-sample descriptor inputs (image_generator.cpp:17-70) over
    the points of ``img_mask`` (``image_point_mask``). Returns (nn_idx |
    None for identity neighborhoods, nn_valid, shadow_pts, shadow_valid)."""
    return _per_sample_inputs(cloud, img_mask, sample_pos, sample_mask,
                              noise, cfg)


def _image_inputs_blocked(cloud: CloudArrays, img_mask: torch.Tensor,
                          sample_pos: torch.Tensor, sample_mask: torch.Tensor,
                          sample_uid: torch.Tensor, n_active: int, noise,
                          cfg: DetectorConfig, block: int):
    """_per_sample_inputs over sample blocks, for the blocks before the
    active count (callers order samples active-first); later rows are
    empty. Returns the same tuple as image_inputs_stage."""
    S = sample_pos.shape[0]
    parts = [_per_sample_inputs(cloud, img_mask, sample_pos[b:b + block],
                                sample_mask[b:b + block], noise, cfg,
                                sample_uid=sample_uid[b:b + block])
             for b in range(0, n_active, block)]
    live = min(S, -(-n_active // block) * block)

    def rows(i, empty_shape, dtype):
        dead = torch.zeros((S - live,) + empty_shape, dtype=dtype,
                           device=sample_pos.device)
        return torch.cat([p[i] for p in parts] + [dead])

    k_img = min(cfg.image_neighbors_cap, cloud.capacity)
    identity = k_img >= cloud.capacity
    nn_idx = None if identity else rows(0, (k_img,), torch.int64)
    nn_valid = rows(1, (k_img,), torch.bool)
    if cfg.image_geometry.num_channels != 15:
        return nn_idx, nn_valid, None, None
    v_cap = _shadow_shape(cloud, cfg)[2]
    return (nn_idx, nn_valid, rows(2, (v_cap, 3), torch.float32),
            rows(3, (v_cap,), torch.bool))


def _sample_activity(grasps: Grasps, num_samples: int) -> torch.Tensor:
    """(S,) bool: sample has >= 1 valid candidate. The batch is the hand
    search's sample-major layout, so this is a reshape."""
    return torch.any(grasps.valid.reshape(num_samples, -1), dim=1)


def live_counts(grasps: Grasps, sample_mask: torch.Tensor) -> torch.Tensor:
    """(2,) int64 on the device: the valid hands and the active samples
    (those with a valid hand), the counts whose reads decide how many image
    chunks and sample blocks ``score_candidates`` runs."""
    active = _sample_activity(grasps, sample_mask.shape[0]) & sample_mask
    return torch.stack([grasps.valid.sum(), active.sum()])


def _descriptor_inputs(cloud: CloudArrays, img_mask: torch.Tensor,
                       grasps: Grasps, sample_pos: torch.Tensor,
                       sample_mask: torch.Tensor, noise, cfg: DetectorConfig,
                       n_active: Optional[int] = None):
    """Descriptor inputs, with active-sample compaction for sample sets
    larger than one block: the blocks past ``n_active`` (the active-sample
    count, or any count in its block; None reads it back to the host) are
    skipped. Returns (nn_idx, nn_valid, shadow_pts, shadow_valid, sid_map);
    sid_map (or None) maps grasp sample ids to rows of the reordered
    per-sample tensors."""
    S = sample_pos.shape[0]
    if S <= _SAMPLE_BLOCK:
        return image_inputs_stage(cloud, img_mask, sample_pos, sample_mask,
                                  noise, cfg) + (None,)
    active = _sample_activity(grasps, S) & sample_mask
    sorder = torch.argsort(~active, stable=True)
    sid_map = torch.argsort(sorder)            # old sample id -> new row
    out = _image_inputs_blocked(
        cloud, img_mask, sample_pos[sorder],
        sample_mask[sorder] & active[sorder], sorder,
        int(active.sum()) if n_active is None else n_active, noise, cfg,
        _SAMPLE_BLOCK)
    return out + (sid_map,)


def _images_for(cloud: CloudArrays, g: Grasps, nn_idx, nn_valid,
                shadow_pts, shadow_valid, cfg: DetectorConfig,
                sid_map=None) -> torch.Tensor:
    """Grasp images for a compacted batch of hands (createImageList,
    image_generator.cpp:72-99)."""
    sid = g.sample_id if sid_map is None else sid_map[g.sample_id]
    h_nvalid = nn_valid[sid] & g.valid[:, None]
    if nn_idx is None:
        # Shared neighborhood: the (N, 3) cloud arrays go in unexpanded.
        h_pts, h_nrm = cloud.points, cloud.normals
    else:
        h_idx = nn_idx[sid]
        h_pts, h_nrm = cloud.points[h_idx], cloud.normals[h_idx]
    return img.make_images(
        h_pts, h_nrm, h_nvalid, g.orientation, g.sample, g.bottom,
        g.center, g.valid, cfg.image_geometry,
        shadow_pts=None if shadow_pts is None else shadow_pts[sid],
        shadow_valid=None if shadow_valid is None else shadow_valid[sid])


def descriptors_stage(cloud: CloudArrays, grasps: Grasps, nn_idx, nn_valid,
                      shadow_pts, shadow_valid, cfg: DetectorConfig,
                      image_cap: int) -> Tuple[Grasps, torch.Tensor]:
    """Step 3 alone (createImages, grasp_detector.cpp:260-265): valid-first
    compaction to ``image_cap`` hands, one rasterization pass. Returns
    (compacted Grasps, images)."""
    g = _compact_hands(grasps, image_cap)
    return g, _images_for(cloud, g, nn_idx, nn_valid, shadow_pts,
                          shadow_valid, cfg)


def _order_valid_first(grasps: Grasps, padded: int) -> Grasps:
    """Valid-first (stable) order, padded to ``padded`` slots with invalid
    entries so fixed-size chunks cover every candidate."""
    total = grasps.capacity
    order = torch.argsort(~grasps.valid, stable=True)
    order = torch.nn.functional.pad(order, (0, padded - total))
    g_all = grasps.take(order)
    if padded > total:
        g_all = dataclasses.replace(g_all, valid=g_all.valid & (
            torch.arange(padded, device=order.device) < total))
    return g_all


def score_candidates(cloud: CloudArrays, grasps: Grasps,
                     sample_pos: torch.Tensor, sample_mask: torch.Tensor,
                     net: lenet.LeNet, generator: torch.Generator,
                     cfg: DetectorConfig, image_cap: int,
                     scores_only: bool = True,
                     timer: Optional[profiling.StageTimer] = None,
                     host_reads: bool = True,
                     live: Optional[Tuple[int, int]] = None,
                     images_out: Optional[torch.Tensor] = None
                     ) -> Tuple[Grasps, Optional[torch.Tensor]]:
    """Images + CNN scores for a candidate batch in the hand search's
    sample-major layout (the reference's pruneGraspCandidates shape,
    grasp_detector.cpp:529-552): descriptor inputs over the active sample
    blocks, valid-first order, then images and scores in chunks of
    ``image_cap`` hands over the live chunks only (gpd_tpu's ``lax.cond``
    and ``while_loop``, detector.py:459-499). ``sample_pos`` must be the
    one the candidates came from. How many blocks and chunks are live
    comes from ``live`` = (valid hands, active samples), or any counts in
    the same chunk and block, as ``detect`` passes them; else from one host
    read of ``live_counts``; with ``host_reads=False`` (CEM's fused
    program) nothing is read and every block and chunk runs, the hands past
    the valid ones scoring -inf as they do anyway.

    Returns (scored Grasps in valid-first order, images): with
    ``scores_only=False`` the (G, size, size, C) uint8 images in the same
    order, zeros for the chunks past the last valid hand (as gpd_tpu's
    skipped chunks), written into ``images_out`` when given (a tensor of
    that shape and type); with ``scores_only=True`` None, and no chunk's
    images outlive its scoring. A ``timer`` gets the descriptors, images
    and classify stages.
    """
    timer = timer or profiling.StageTimer(on=False)
    S = sample_pos.shape[0]
    if live is None:
        live = (live_counts(grasps, sample_mask).tolist() if host_reads
                else (grasps.capacity, S))
    n_valid, n_active = live
    noise = shadow_noise(generator, cloud, S, cfg)
    img_mask = image_point_mask(cloud, generator, cfg)
    nn_idx, nn_valid, shadow_pts, shadow_valid, sid_map = _descriptor_inputs(
        cloud, img_mask, grasps, sample_pos, sample_mask, noise, cfg,
        n_active)
    timer.mark("descriptors")

    n_chunks = max(1, -(-grasps.capacity // image_cap))
    g_all = _order_valid_first(grasps, n_chunks * image_cap)
    n_live = -(-n_valid // image_cap)
    device = grasps.valid.device
    scores = torch.full((n_chunks * image_cap,), -torch.inf, device=device)
    images = None
    if not scores_only:
        ig = cfg.image_geometry
        shape = (n_chunks * image_cap, ig.size, ig.size, ig.num_channels)
        if images_out is None:
            images = torch.zeros(shape, dtype=torch.uint8, device=device)
        else:
            if images_out.shape != shape or images_out.dtype != torch.uint8:
                raise ValueError(f"images_out is {images_out.dtype} "
                                 f"{tuple(images_out.shape)}; the images are "
                                 f"uint8 {shape}")
            images = images_out
            images[n_live * image_cap:] = 0
    for i in range(n_live):
        chunk = slice(i * image_cap, (i + 1) * image_cap)
        chunk_images = _images_for(cloud, g_all.take(chunk), nn_idx, nn_valid,
                                   shadow_pts, shadow_valid, cfg, sid_map)
        timer.mark("images")
        scores[chunk] = lenet.score(net, chunk_images)
        timer.mark("classify")
        if images is not None:
            images[chunk] = chunk_images
    # Classification scores attach to the ordered batch
    # (grasp_detector.cpp:267-273).
    return dataclasses.replace(
        g_all, score=torch.where(g_all.valid, scores, -torch.inf)), images


def detect_core(cloud: CloudArrays, sample_pos: torch.Tensor,
                sample_mask: torch.Tensor, net: lenet.LeNet,
                generator: torch.Generator, cfg: DetectorConfig,
                image_cap: int, scores_only: bool = False,
                timer: Optional[profiling.StageTimer] = None,
                stats: Optional[dict] = None
                ) -> Tuple[Grasps, Optional[torch.Tensor]]:
    """frames -> candidates -> filters -> images -> CNN scores
    (grasp_detector.cpp:192-273, steps 1-4). Returns (scored Grasps in
    valid-first order, their uint8 images or, with ``scores_only=True``,
    None). ``stats`` as in ``search_hands_with_frames``."""
    timer = timer or profiling.StageTimer(on=False)
    grasps = candidates_stage(cloud, sample_pos, sample_mask, cfg,
                              stats=stats)
    timer.mark("candidates")
    return score_candidates(cloud, grasps, sample_pos, sample_mask, net,
                            generator, cfg, image_cap, scores_only, timer)


def sample_points(cloud: CloudArrays, generator: torch.Generator,
                  cfg: DetectorConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """[sampleAbovePlane] -> subsample(num_samples) -> (positions, mask):
    gpd_tpu's ``_sample_kernel`` (detector.py:69-79)."""
    pool = cloud.mask
    if cfg.sample_above_plane:
        pool = pp.sample_above_plane(cloud, generator)
    idx, valid = pp.subsample_uniform(generator, pool, cfg.num_samples)
    return torch.where(valid[:, None], cloud.points[idx], 1e6), valid


def candidates_program(cloud: CloudArrays,
                       sample_pos: Optional[torch.Tensor],
                       sample_mask: Optional[torch.Tensor],
                       generator: torch.Generator, cfg: DetectorConfig
                       ) -> Tuple[Grasps, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """The first of ``detect``'s three parts, which reads nothing back to
    the host: the samples (``sample_points`` when ``sample_pos`` is None),
    ``candidates_stage`` without host reads, and in one (5,) int64 device
    tensor the counts that the rest of the request needs: valid hands,
    active samples (``live_counts``), valid samples, cloud points, and the
    largest neighbourhood the hand search swept (``hand_neighbors_max``).
    Returns (grasps, sample_pos, sample_mask, counts)."""
    if sample_pos is None:
        sample_pos, sample_mask = sample_points(cloud, generator, cfg)
    stats = {}
    grasps = candidates_stage(cloud, sample_pos, sample_mask, cfg,
                              host_reads=False, stats=stats)
    counts = torch.cat([live_counts(grasps, sample_mask),
                        torch.stack([sample_mask.sum(), cloud.mask.sum(),
                                     stats["hand_neighbors_max"]])])
    return grasps, sample_pos, sample_mask, counts


def select_and_cluster(grasps: Grasps, cfg: DetectorConfig) -> Grasps:
    """Steps 5-7 of detectGrasps (grasp_detector.cpp:275-311): top-k
    selection, optional clustering with the reference's <=3-clusters
    fallback (append the selected hands), final score-descending sort."""
    k = min(grasps.capacity, _next_size(cfg.num_selected, 64))
    g, _ = sel.select_top_k(grasps, cfg.num_selected, out_cap=k)
    if cfg.min_inliers <= 0:
        return g          # select_top_k already sorted it
    clustered = sel.cluster_grasps(g, cfg.min_inliers)
    keep_originals = clustered.valid.sum() <= 3
    merged = Grasps(**{f.name: torch.cat([getattr(clustered, f.name),
                                          getattr(g, f.name)])
                       for f in dataclasses.fields(Grasps)})
    merged = dataclasses.replace(merged, valid=torch.cat(
        [clustered.valid, g.valid & keep_originals]))
    return sel.sort_by_score(merged)


class GraspDetector:
    """End-to-end detector (reference: include/gpd/grasp_detector.h).

    ``params`` is a gpd_tpu parameter dict of numpy arrays (see
    ``lenet.params_from_numpy``); by default the configured weights
    (``_default_params``). ``device`` defaults to CUDA and raises without
    it."""

    def __init__(self, config, params=None, device=None):
        if isinstance(config, str):
            config = load_config(config)
        self.cfg: DetectorConfig = config
        self.device = resolve_device(device)
        # The detector's programs (preprocess, detect's parts, data
        # generation's relabeling, the sharded parts) as CUDA graphs by
        # static key, in one memory pool.
        self.programs = Programs(self.device)
        # On a card, the images buffer of every B that keeps its images, by
        # shape (``_images_buffer``).
        self._images = {}
        if params is None:
            params = self._default_params()
        self.net = lenet.params_from_numpy(params, self.device)
        self.last_runtimes = {}
        self.last_counts = {}

    @property
    def graphs(self) -> dict:
        """The CUDA graphs of the detector's programs by static key, the
        program's name first."""
        return self.programs.graphs

    @property
    def pool(self):
        """The memory pool of every graph in ``graphs``."""
        return self.programs.pool

    @property
    def last_graphs(self) -> list:
        """The keys the last request replayed (none on the CPU)."""
        return self.programs.last_graphs

    @property
    def _force_eager(self) -> bool:
        """Test hook: the eager routes of detect, preprocess, data
        generation and the sharded functions, the baselines the graphs are
        timed and held against, as CEM's ``_force_loop``."""
        return self.programs.eager

    @_force_eager.setter
    def _force_eager(self, on: bool):
        self.programs.eager = on

    @property
    def net(self) -> lenet.LeNet:
        """The LeNet that scores candidates."""
        return self._net

    @net.setter
    def net(self, net: lenet.LeNet):
        """A different net drops the graphs whose key holds the old net's
        identity (detect's and data generation's parts): they keep the old
        net alive, and no later request could replay them. The preprocess
        and relabeling graphs hold no net and stay."""
        old = self.__dict__.get("_net")
        if old is not None and net is not old:
            self.programs.graphs = {k: g for k, g in self.graphs.items()
                                    if id(old) not in k}
        self._net = net

    def _default_params(self):
        """The configured weights in any format ``lenet.load_params`` reads;
        else (no weights_file, or one that is missing, unreadable or of an
        unknown kind) the packaged checkpoint with a NOTE, else random init
        with a WARNING: gpd_tpu/detector.py:570-592."""
        C = self.cfg.image_geometry.num_channels
        try:
            if not self.cfg.weights_file:
                raise FileNotFoundError("no weights_file configured")
            return lenet.load_params(self.cfg.weights_file, C)
        except (FileNotFoundError, ValueError, OSError) as e:
            default = lenet.default_params_path(C)
            if os.path.exists(default):
                print(f"NOTE: {e}; using packaged checkpoint {default}.")
                return lenet.load_params_npz(default)
            print(f"WARNING: could not load classifier weights ({e}); "
                  f"using random initialization.")
            return lenet.init_params(torch.Generator().manual_seed(0), C,
                                     self.cfg.image_geometry.size)

    def _generator(self, generator: Optional[torch.Generator]):
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    def preprocess_cloud(self, points: np.ndarray,
                         view_points: Optional[np.ndarray] = None,
                         cam_source: Optional[np.ndarray] = None,
                         normals: Optional[np.ndarray] = None,
                         generator: Optional[torch.Generator] = None,
                         capacity=None) -> CloudArrays:
        """removeNans -> filterWorkspace -> voxelize -> [removeOutliers] ->
        normals(+reverse) -> [refine] (candidates_generator.cpp:14-37).
        Returns a compacted CloudArrays on the detector's device.
        ``generator`` stands where gpd_tpu takes ``key``, and is unused as
        that is: preprocessing draws nothing.

        ``capacity`` pins the padded size of every stage; ``"serve"`` takes
        each stage's ``serve_capacity`` bucket, as gpd_tpu's serving entry
        points do (the capacity picks routes in ``effective_config``);
        None pads snugly (``_next_size``).

        As gpd_tpu runs it (detector.py:623-642): the programs
        ``_prep_filter_voxel``, ``_prep_outliers`` (with
        ``cfg.remove_outliers``) and ``_prep_normals``, each compacted on
        the host (``compact_host``) before the next. On a card each program
        replays a CUDA graph captured at the first request of its key (the
        device, the input cloud's capacity and camera count, and the
        program's static arguments) in the span ``preprocess_capture``,
        into the detector's one pool (``graphs.Programs``); the returned
        cloud is a copy. On the CPU the same programs run eagerly. The test
        hook ``_force_eager`` runs them eagerly on a card too. The request
        is one span, ``preprocess``, from the finite filter on; inside it
        the spans ``preprocess_upload``, each program's (by its name) and
        ``preprocess_compact`` (``profiling``)."""
        del generator
        with profiling.span("preprocess"):
            cfg = self.cfg
            serve = capacity == "serve"
            points = np.asarray(points, np.float32).reshape(-1, 3)
            finite = np.isfinite(points).all(axis=1)
            points = points[finite]
            if normals is not None:
                normals = np.asarray(normals,
                                     np.float32).reshape(-1, 3)[finite]
            if cam_source is not None:
                cam_source = np.asarray(cam_source)[..., finite]

            def compact(c):
                with profiling.span("preprocess_compact"):
                    if serve:
                        return c.compact_host(
                            serve_capacity(int(c.mask.sum())))
                    return c.compact_host(capacity)

            def run(name, program, cloud, *static):
                key = (name, cloud.device, cloud.capacity, cloud.num_cameras,
                       *static)
                with profiling.span(name):
                    return self.programs.run(
                        key, lambda _, c: program(c, *static), (cloud,),
                        capture_span="preprocess_capture")

            self.programs.last_graphs = []
            with profiling.span("preprocess_upload"):
                cloud = CloudArrays.from_numpy(
                    points, view_points=view_points, cam_source=cam_source,
                    normals=normals, device=self.device,
                    capacity=serve_capacity(len(points)) if serve
                    else capacity)
            cloud = compact(run("prep_filter_voxel", _prep_filter_voxel,
                                cloud, tuple(cfg.workspace), cfg.voxel_size,
                                cfg.voxelize))
            if cfg.remove_outliers:
                cloud = compact(run("prep_outliers", _prep_outliers, cloud,
                                    _OUTLIER_MEAN_K, _OUTLIER_STDDEV_MULT))
            cloud = run("prep_normals", _prep_normals, cloud,
                        cfg.normals_radius, normals is None or cfg.voxelize,
                        cfg.refine_normals_k, cfg.centered_at_origin)
            return cloud if self._force_eager else clone_tree(cloud)

    def sample_cloud(self, cloud: CloudArrays,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[sampleAbovePlane] -> subsample(num_samples) -> (positions,
        mask)."""
        return sample_points(cloud, self._generator(generator), self.cfg)

    def image_cap(self, num_samples: int) -> int:
        """Image/score chunk size: small enough that the all-invalid tail
        chunks are skipped."""
        cfg = self.cfg
        total = num_samples * cfg.num_orientations * len(cfg.hand_axes)
        return min(_next_size(total, 256), 512)

    def effective_config(self, cloud: CloudArrays) -> DetectorConfig:
        """Clamp the neighbor caps to the cloud's padded capacity: the hand
        search runs uncapped on identity neighborhoods up to
        search_identity_max, and image neighborhoods cover the cloud when it
        is close to the cap."""
        n = cloud.capacity
        changes = {}
        if self.cfg.search_neighbors_cap > n:
            changes["search_neighbors_cap"] = n
        elif self.cfg.search_neighbors_cap < n <= self.cfg.search_identity_max:
            changes["search_neighbors_cap"] = n
        if n <= 1.5 * self.cfg.image_neighbors_cap:
            if self.cfg.image_neighbors_cap != n:
                changes["image_neighbors_cap"] = n
        if changes:
            return dataclasses.replace(self.cfg, **changes)
        return self.cfg

    def detect(self, cloud: CloudArrays,
               sample_pos: Optional[torch.Tensor] = None,
               sample_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               verbose: bool = True, staged: bool = False,
               staged_cap: Optional[int] = None) -> Grasps:
        """Full detectGrasps pipeline with stage timing.

        By default gpd_tpu's device programs (``_detect_programs``): CUDA
        graph replays on a card, one read back to the host per request.
        ``last_runtimes`` holds detect (steps 1-4), select and total
        seconds. ``staged=True`` takes gpd_tpu's staged route
        (``_detect_staged``), which times each stage.
        Under GPD_TPU_PROFILE the request is traced
        (``profiling.maybe_trace``), as one span ``detect`` that holds the
        route's spans and ``detect_result``, the read of the selection's
        valid flags."""
        if staged:
            return self._detect_staged(cloud, sample_pos, sample_mask,
                                       generator, verbose, staged_cap)
        self.programs.last_graphs = []
        with profiling.maybe_trace(), profiling.span("detect"):
            cfg = self.effective_config(cloud)
            gen = self._generator(generator)
            t0 = time.perf_counter()
            route = (self._detect_eager if self._force_eager
                     else self._detect_programs)
            out, counts, t_detect, t_select = route(cloud, sample_pos,
                                                    sample_mask, gen, cfg)
            t_total = time.perf_counter() - t0

            self.last_runtimes = dict(detect=t_detect, select=t_select,
                                      total=t_total)
            with profiling.span("detect_result"):
                valid = self._count(cloud, counts, out)
            if verbose:
                scores = out.score.cpu().numpy()
                print("======== Selected grasps ========")
                for i in np.nonzero(valid)[0][:10]:
                    print(f"Grasp {i}: {scores[i]:.4f}")
                print(f"Selected the {int(valid.sum())} best grasps.")
                print("======== RUNTIMES ========")
                print(f" 1. Candidate generation + descriptors + "
                      f"classification: {t_detect:.4f}s")
                print(f" 2. Selection/clustering: {t_select:.4f}s")
                print("==========")
                print(f" TOTAL: {t_total:.4f}s")
        return out

    def _detect_eager(self, cloud: CloudArrays, sample_pos, sample_mask,
                      gen: torch.Generator, cfg: DetectorConfig):
        """``detect`` as eager stages (``_force_eager``): ``sample_cloud``,
        ``detect_core`` (which reads its block and chunk counts back to the
        host) and ``select_and_cluster``. Returns (grasps, counts, detect
        s, select s)."""
        if sample_pos is None:
            sample_pos, sample_mask = self.sample_cloud(cloud, gen)
        cap = self.image_cap(sample_pos.shape[0])
        stats = {}

        t_c0 = time.perf_counter()
        with profiling.span("detect_core"):
            g, _ = detect_core(cloud, sample_pos, sample_mask, self.net,
                               gen, cfg, cap, scores_only=True, stats=stats)
            n_candidates = int(g.valid.sum())  # also waits for the device
        t_detect = time.perf_counter() - t_c0

        t_s0 = time.perf_counter()
        with profiling.span("select_and_cluster"):
            out = select_and_cluster(g, cfg)
            _sync(self.device)
        counts = dict(points=int(cloud.mask.sum()),
                      samples=int(sample_mask.sum()), candidates=n_candidates,
                      hand_neighbors_max=int(stats["hand_neighbors_max"]))
        return out, counts, t_detect, time.perf_counter() - t_s0

    def _detect_programs(self, cloud: CloudArrays, sample_pos, sample_mask,
                         gen: torch.Generator, cfg: DetectorConfig):
        """``detect`` as gpd_tpu's device programs (detector.py:689-745):
        A, the read of its counts and B (``_scored_programs``), then C,
        ``select_and_cluster``, which reads B's outputs in place and is
        keyed as B. The profiler spans are gpd_tpu's: ``detect_core`` (A,
        the read, B) and ``select_and_cluster`` (C), each ended by a wait,
        to time it. Returns (grasps, counts, detect s, select s)."""
        t_c0 = time.perf_counter()
        with profiling.span("detect_core"):
            scored, _, counts, key = self._scored_programs(
                cloud, sample_pos, sample_mask, gen, cfg)
            _sync(self.device)
        t_detect = time.perf_counter() - t_c0

        t_s0 = time.perf_counter()
        with profiling.span("select_and_cluster"):
            out = clone_tree(self.programs.run(
                ("select",) + key, lambda _: select_and_cluster(scored, cfg)))
            _sync(self.device)
        n_valid, _, n_samples, n_points, n_hood = counts
        counts = dict(points=n_points, samples=n_samples, candidates=n_valid,
                      hand_neighbors_max=n_hood)
        return out, counts, t_detect, time.perf_counter() - t_s0

    def _scored_programs(self, cloud: CloudArrays, sample_pos, sample_mask,
                         gen: torch.Generator, cfg: DetectorConfig,
                         images: bool = False):
        """gpd_tpu's ``detect_core`` as device programs: A,
        ``candidates_program``; one read of its counts, the only read back
        to the host; B, ``score_candidates`` over the live sample blocks and
        image chunks, with the images if ``images``.

        On a card each part replays a CUDA graph (``self.programs``, one
        pool), captured at the first
        request of its key in a span of its own, ``detect_capture``. A's key
        is the device, the cloud's capacity and camera count, the LeNet's
        identity, the config, the sample count and whether the caller gave
        the samples (they are then copied into A's inputs); B's adds the
        live (sample blocks, image chunks), which the read gives, and
        ``"images"`` if it keeps them. B reads A's outputs in place, and
        binds the net it was captured with. A and B draw through their
        graphs' own generators (``Programs.run``), so the request draws
        what the eager route draws. On the CPU the same parts run eagerly.
        A capture that fails raises; nothing falls back to the eager
        route.

        Returns B's outputs, (scored Grasps in valid-first order, images or
        None), which the next replay rewrites (the images, in the
        detector's ``_images_buffer``, the next B with images of any key);
        A's counts as a list (valid
        hands, active samples, valid samples, cloud points, largest hand
        neighbourhood); and B's key
        without its name."""
        given = sample_pos is not None
        S = sample_pos.shape[0] if given else cfg.num_samples
        cap = self.image_cap(S)
        inputs = (cloud, sample_pos, sample_mask) if given else (cloud,)
        net = self.net
        key = (cloud.device, cloud.capacity, cloud.num_cameras, id(net), cfg,
               S, given)

        def part_a(g, cloud, spos=None, smask=None):
            # A hands its cloud on: on a card, B reads the graph's copy.
            return (cloud,) + candidates_program(cloud, spos, smask, g, cfg)

        with profiling.span("candidates"):
            cloud_a, grasps, spos, smask, counts = self.programs.run(
                ("candidates",) + key, part_a, inputs, gen)
        with profiling.span("candidates_read"):
            counts = counts.tolist()
        n_valid, n_active = counts[:2]
        # The live blocks and chunks, as counts at their ends.
        blocks = -(-n_active // _SAMPLE_BLOCK) if S > _SAMPLE_BLOCK else 0
        live = (-(-n_valid // cap) * cap, blocks * _SAMPLE_BLOCK)
        key = key + live
        out = (self._images_buffer(cfg, max(1, -(-grasps.capacity // cap))
                                   * cap) if images else None)
        with profiling.span("score"):
            scored, imgs = self.programs.run(
                ("score",) + key + (("images",) if images else ()),
                lambda g: score_candidates(cloud_a, grasps, spos, smask, net,
                                           g, cfg, cap,
                                           scores_only=not images,
                                           live=live, images_out=out),
                (), gen)
        return scored, imgs, counts, key

    def _images_buffer(self, cfg: DetectorConfig, rows: int) -> torch.Tensor:
        """The (rows, size, size, C) uint8 tensor a B with images writes
        into. On a card one per shape, made once outside the graphs' pool
        and shared by every such B key: a live pair's key then adds its
        working set to the pool, not a copy of the images (8192 x 60 x 60 x
        15 bytes at the default config). A B's images are read before the
        next B replays, so one buffer serves them all. On the CPU a new
        tensor each call, as the eager route's."""
        ig = cfg.image_geometry
        shape = (rows, ig.size, ig.size, ig.num_channels)
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=torch.uint8, device=self.device)
        if shape not in self._images:
            self._images[shape] = torch.empty(shape, dtype=torch.uint8,
                                              device=self.device)
        return self._images[shape]

    def candidates_with_images(self, cloud: CloudArrays,
                               generator: Optional[torch.Generator] = None,
                               cfg: Optional[DetectorConfig] = None
                               ) -> Tuple[Grasps, torch.Tensor, int]:
        """gpd_tpu's ``_sample_kernel`` + ``detect_core(scores_only=False)``
        (datagen.py:227-240, api.py:64-69): samples drawn from ``cloud``,
        the scored candidates in valid-first order, their (G, size, size, C)
        uint8 images, and the valid count. ``cfg`` defaults to the
        effective config of ``cloud``.

        By default the device programs of ``detect``'s A and B
        (``_scored_programs``, B with images): A's key is ``detect``'s, the
        valid count comes from its read, and the outputs are the graph's
        own on a card (the images the detector's buffer), which the next
        replay rewrites (a caller clones what it keeps). Under
        ``_force_eager``: ``sample_points`` and the eager
        ``detect_core``, which reads its counts where it needs them, then
        one more read for the valid count."""
        cfg = cfg or self.effective_config(cloud)
        gen = self._generator(generator)
        if self._force_eager:
            spos, smask = sample_points(cloud, gen, cfg)
            grasps, images = detect_core(cloud, spos, smask, self.net, gen,
                                         cfg, self.image_cap(spos.shape[0]))
            return grasps, images, int(grasps.valid.sum())
        scored, images, counts, _ = self._scored_programs(
            cloud, None, None, gen, cfg, images=True)
        return scored, images, counts[0]

    def _count(self, cloud: CloudArrays, counts: dict,
               out: Grasps) -> np.ndarray:
        """Fills ``last_counts`` from the request's ``counts``; returns the
        selection's valid flags."""
        valid = out.valid.cpu().numpy()
        self.last_counts = dict(points=counts["points"],
                                capacity=cloud.capacity,
                                samples=counts["samples"],
                                candidates=counts["candidates"],
                                selected=int(valid.sum()),
                                hand_neighbors_max=counts[
                                    "hand_neighbors_max"])
        return valid

    def _detect_staged(self, cloud: CloudArrays, sample_pos, sample_mask,
                       generator, verbose: bool,
                       staged_cap: Optional[int] = None) -> Grasps:
        """gpd_tpu's staged route (gpd_tpu/detector.py:747-810):
        ``detect_core`` with images and scores in chunks of ``staged_cap``
        (by default the hand count rounded up, at most 4096), waiting for
        the device after every stage and chunk, for the reference's
        four-line runtime report (grasp_detector.cpp:313-320).
        ``last_runtimes`` holds candidates, images (descriptor inputs
        included), classify and total seconds. The generator draws as in
        ``detect``, so both routes score the same candidates."""
        cfg = self.effective_config(cloud)
        gen = self._generator(generator)
        with profiling.maybe_trace():
            t0 = time.perf_counter()
            if sample_pos is None:
                sample_pos, sample_mask = self.sample_cloud(cloud, gen)
            total = (sample_pos.shape[0] * cfg.num_orientations
                     * len(cfg.hand_axes))
            cap = staged_cap or min(_next_size(total, 256), 4096)
            timer = profiling.StageTimer(self.device)
            stats = {}
            with profiling.span("detect_core"):
                g, _ = detect_core(cloud, sample_pos, sample_mask, self.net,
                                   gen, cfg, cap, scores_only=True,
                                   timer=timer, stats=stats)
                n_valid = int(g.valid.sum())
            with profiling.span("select_and_cluster"):
                out = select_and_cluster(g, cfg)
                _sync(self.device)
            t_total = time.perf_counter() - t0

        st = timer.stages
        self.last_runtimes = dict(
            candidates=st["candidates"],
            images=st["descriptors"] + st.get("images", 0.0),
            classify=st.get("classify", 0.0), total=t_total)
        valid = self._count(cloud, dict(
            points=int(cloud.mask.sum()), samples=int(sample_mask.sum()),
            candidates=n_valid,
            hand_neighbors_max=int(stats["hand_neighbors_max"])), out)
        if verbose:
            rt = self.last_runtimes
            print(f"Selected the {int(valid.sum())} best grasps.")
            print("======== RUNTIMES ========")
            print(f" 1. Candidate generation: {rt['candidates']:.4f}s")
            print(f" 2. Descriptors/images: {rt['images']:.4f}s")
            print(f" 3. Classification: {rt['classify']:.4f}s")
            print("==========")
            print(f" TOTAL: {t_total:.4f}s")
        return out

    def detect_file(self, pcd_path: str,
                    generator: Optional[torch.Generator] = None,
                    verbose: bool = True) -> Grasps:
        """CONFIG + PCD -> grasps, the detect_grasps app's path
        (src/detect_grasps.cpp): one view point at ``cfg.camera_position``
        and serving capacity buckets."""
        points = load_cloud_file(pcd_path)
        vp = np.asarray(self.cfg.camera_position, np.float32).reshape(1, 3)
        cloud = self.preprocess_cloud(points, view_points=vp,
                                      capacity="serve")
        return self.detect(cloud, generator=generator, verbose=verbose)
