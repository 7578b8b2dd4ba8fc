"""Grasp detection pipeline (port of gpd_tpu/detector.py).

The reference's ``GraspDetector`` (src/gpd/grasp_detector.cpp): host-side
preprocessing with one compaction, then the detection core (local frames,
hand search, filters, valid-first compaction, descriptors, CNN scores) and
selection, all on one device. PyTorch runs eagerly, so gpd_tpu's fused
programs become plain functions, its ``lax.cond``/``while_loop`` skips of
dead blocks become Python loops over live blocks whose trip counts come from
one host read each; with ``host_reads=False`` (CEM's fused program, which a
CUDA graph captures) every block runs, masked, and nothing is read back.

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


def candidates_stage(cloud: CloudArrays, sample_pos: torch.Tensor,
                     sample_mask: torch.Tensor, cfg: DetectorConfig,
                     host_reads: bool = True) -> Grasps:
    """Steps 1-2 of detectGrasps: frames -> hand search -> filters
    (grasp_detector.cpp:192-258). ``host_reads=False``: no read of a count
    back to the host (for CUDA graph capture)."""
    frames, fvalid = estimate_frames(
        sample_pos, sample_mask, cloud.points, cloud.mask, cloud.normals,
        radius=cfg.nn_radius_frames)
    grasps = cand.search_hands_with_frames(cloud, sample_pos, frames, fvalid,
                                           cfg, host_reads)
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
            radius=cfg.image_radius, k=k_img)
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
            torch.where(nn_valid, -nn_d2, -torch.inf), sc)
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


def _descriptor_inputs(cloud: CloudArrays, img_mask: torch.Tensor,
                       grasps: Grasps, sample_pos: torch.Tensor,
                       sample_mask: torch.Tensor, noise, cfg: DetectorConfig,
                       host_reads: bool = True):
    """Descriptor inputs, with active-sample compaction for sample sets
    larger than one block: one host read of the active count skips the
    blocks past it, or, with ``host_reads=False``, every block runs.
    Returns (nn_idx, nn_valid, shadow_pts, shadow_valid, sid_map); sid_map
    (or None) maps grasp sample ids to rows of the reordered per-sample
    tensors."""
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
        int(active.sum()) if host_reads else S, noise, cfg, _SAMPLE_BLOCK)
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
                     host_reads: bool = True
                     ) -> Tuple[Grasps, Optional[torch.Tensor]]:
    """Images + CNN scores for a candidate batch in the hand search's
    sample-major layout (the reference's pruneGraspCandidates shape,
    grasp_detector.cpp:529-552): descriptor inputs, valid-first order, then
    images and scores in chunks of ``image_cap`` hands over the live chunks
    only (one host read of the valid count). ``sample_pos`` must be the one
    the candidates came from. ``host_reads=False`` reads nothing back to
    the host, for CUDA graph capture (gpd_tpu's ``lax.cond`` and
    ``while_loop`` over live chunks, detector.py:459-499, without
    data-dependent control flow): every chunk runs, and the hands past the
    valid ones score -inf as they do anyway.

    Returns (scored Grasps in valid-first order, images): with
    ``scores_only=False`` the (G, size, size, C) uint8 images in the same
    order, zeros for the chunks past the last valid hand (as gpd_tpu's
    skipped chunks); with ``scores_only=True`` None, and no chunk's images
    outlive its scoring. A ``timer`` gets the descriptors, images and
    classify stages.
    """
    timer = timer or profiling.StageTimer(on=False)
    noise = shadow_noise(generator, cloud, sample_pos.shape[0], cfg)
    img_mask = image_point_mask(cloud, generator, cfg)
    nn_idx, nn_valid, shadow_pts, shadow_valid, sid_map = _descriptor_inputs(
        cloud, img_mask, grasps, sample_pos, sample_mask, noise, cfg,
        host_reads)
    timer.mark("descriptors")

    n_chunks = max(1, -(-grasps.capacity // image_cap))
    g_all = _order_valid_first(grasps, n_chunks * image_cap)
    n_live = (-(-int(grasps.valid.sum()) // image_cap) if host_reads
              else n_chunks)
    device = grasps.valid.device
    scores = torch.full((n_chunks * image_cap,), -torch.inf, device=device)
    images = None
    if not scores_only:
        ig = cfg.image_geometry
        images = torch.zeros((n_chunks * image_cap, ig.size, ig.size,
                              ig.num_channels), dtype=torch.uint8,
                             device=device)
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
                timer: Optional[profiling.StageTimer] = None
                ) -> Tuple[Grasps, Optional[torch.Tensor]]:
    """frames -> candidates -> filters -> images -> CNN scores
    (grasp_detector.cpp:192-273, steps 1-4). Returns (scored Grasps in
    valid-first order, their uint8 images or, with ``scores_only=True``,
    None)."""
    timer = timer or profiling.StageTimer(on=False)
    grasps = candidates_stage(cloud, sample_pos, sample_mask, cfg)
    timer.mark("candidates")
    return score_candidates(cloud, grasps, sample_pos, sample_mask, net,
                            generator, cfg, image_cap, scores_only, timer)


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
        if params is None:
            params = self._default_params()
        self.net = lenet.params_from_numpy(params, self.device)
        self.last_runtimes = {}
        self.last_counts = {}

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
                         capacity=None) -> CloudArrays:
        """removeNans -> filterWorkspace -> voxelize -> [removeOutliers] ->
        normals(+reverse) -> [refine] (candidates_generator.cpp:14-37).
        Returns a compacted CloudArrays on the detector's device.

        ``capacity`` pins the padded size of every stage; ``"serve"`` takes
        each stage's ``serve_capacity`` bucket, as gpd_tpu's serving entry
        points do (the capacity picks routes in ``effective_config``);
        None pads snugly (``_next_size``)."""
        cfg = self.cfg
        serve = capacity == "serve"
        points = np.asarray(points, np.float32).reshape(-1, 3)
        finite = np.isfinite(points).all(axis=1)
        points = points[finite]
        if normals is not None:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)[finite]
        if cam_source is not None:
            cam_source = np.asarray(cam_source)[..., finite]

        def compact(c):
            if serve:
                return c.compact_host(serve_capacity(int(c.mask.sum())))
            return c.compact_host(capacity)

        cloud = CloudArrays.from_numpy(
            points, view_points=view_points, cam_source=cam_source,
            normals=normals, device=self.device,
            capacity=serve_capacity(len(points)) if serve else capacity)
        cloud = pp.filter_workspace(cloud, tuple(cfg.workspace))
        if cfg.voxelize:
            cloud = pp.voxelize(cloud, cfg.voxel_size)
        cloud = compact(cloud)
        if cfg.remove_outliers:
            cloud = compact(pp.remove_statistical_outliers(cloud))
        if normals is None or cfg.voxelize:
            cloud = estimate_normals(cloud, cfg.normals_radius)
        cloud = reverse_normals_cloud(cloud)
        if cfg.refine_normals_k > 0:
            cloud = dataclasses.replace(cloud, normals=refine_normals(
                cloud.points, cloud.normals, cloud.mask, k=cfg.refine_normals_k))
        if cfg.centered_at_origin:
            cloud = dataclasses.replace(cloud, normals=-cloud.normals)
        return cloud

    def sample_cloud(self, cloud: CloudArrays,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[sampleAbovePlane] -> subsample(num_samples) -> (positions,
        mask)."""
        gen = self._generator(generator)
        pool = cloud.mask
        if self.cfg.sample_above_plane:
            pool = pp.sample_above_plane(cloud, gen)
        idx, valid = pp.subsample_uniform(gen, pool, self.cfg.num_samples)
        return torch.where(valid[:, None], cloud.points[idx], 1e6), valid

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
               verbose: bool = True, sync_stages: bool = False,
               staged: bool = False,
               staged_cap: Optional[int] = None) -> Grasps:
        """Full detectGrasps pipeline with stage timing.

        ``last_runtimes`` holds detect (steps 1-4), select and total
        seconds. ``sync_stages=True`` also waits for the device after every
        stage and adds each stage's seconds (sample, candidates,
        descriptors, images, classify), for the reference's per-stage
        report (grasp_detector.cpp:313-320) at the cost of those waits.
        ``staged=True`` takes gpd_tpu's staged route instead
        (``_detect_staged``). Under GPD_TPU_PROFILE the request is traced
        (``profiling.maybe_trace``)."""
        if staged:
            return self._detect_staged(cloud, sample_pos, sample_mask,
                                       generator, verbose, staged_cap)
        cfg = self.effective_config(cloud)
        gen = self._generator(generator)
        with profiling.maybe_trace():
            t0 = time.perf_counter()
            timer = profiling.StageTimer(self.device, on=sync_stages)
            if sample_pos is None:
                sample_pos, sample_mask = self.sample_cloud(cloud, gen)
                timer.mark("sample")
            cap = self.image_cap(sample_pos.shape[0])

            t_c0 = time.perf_counter()
            with profiling.span("detect_core"):
                g, _ = detect_core(cloud, sample_pos, sample_mask, self.net,
                                   gen, cfg, cap, scores_only=True,
                                   timer=timer)
                n_candidates = int(g.valid.sum())  # also waits for the device
            t_detect = time.perf_counter() - t_c0

            t_s0 = time.perf_counter()
            with profiling.span("select_and_cluster"):
                out = select_and_cluster(g, cfg)
                _sync(self.device)
            t_select = time.perf_counter() - t_s0
            t_total = time.perf_counter() - t0

        self.last_runtimes = dict(detect=t_detect, select=t_select,
                                  total=t_total, **timer.stages)
        valid = self._count(cloud, sample_mask, n_candidates, out)
        if verbose:
            scores = out.score.cpu().numpy()
            print("======== Selected grasps ========")
            for i in np.nonzero(valid)[0][:10]:
                print(f"Grasp {i}: {scores[i]:.4f}")
            print(f"Selected the {int(valid.sum())} best grasps.")
            print("======== RUNTIMES ========")
            st = timer.stages
            if st:
                print(f" 1. Candidate generation: {st['candidates']:.4f}s")
                print(f" 2. Descriptors/images: "
                      f"{st['descriptors'] + st.get('images', 0.0):.4f}s")
                print(f" 3. Classification: {st.get('classify', 0.0):.4f}s")
                print(f" 4. Selection/clustering: {t_select:.4f}s")
            else:
                print(f" 1. Candidate generation + descriptors + "
                      f"classification: {t_detect:.4f}s")
                print(f" 2. Selection/clustering: {t_select:.4f}s")
            print("==========")
            print(f" TOTAL: {t_total:.4f}s")
        return out

    def _count(self, cloud: CloudArrays, sample_mask: torch.Tensor,
               n_candidates: int, out: Grasps) -> np.ndarray:
        """Fills ``last_counts``; returns the selection's valid flags."""
        valid = out.valid.cpu().numpy()
        self.last_counts = dict(points=int(cloud.mask.sum()),
                                capacity=cloud.capacity,
                                samples=int(sample_mask.sum()),
                                candidates=n_candidates,
                                selected=int(valid.sum()))
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
            with profiling.span("detect_core"):
                g, _ = detect_core(cloud, sample_pos, sample_mask, self.net,
                                   gen, cfg, cap, scores_only=True,
                                   timer=timer)
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
        valid = self._count(cloud, sample_mask, n_valid, out)
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
