"""Training-data generation (port of gpd_tpu/datagen.py; the reference's
``DataGenerator``, src/gpd/data_generator.cpp).

Per (object, view) pair: candidates and grasp images from the view cloud on
the card (``raster_blocks`` at 12/15 channels and ``raster_sums`` at 1/3),
ground-truth antipodal labels by re-evaluating each candidate against the
object's full mesh cloud (``ops.candidates.reevaluate_hypotheses``), 50/50
positive/negative balancing, and chunked HDF5 output in the reference's
dataset format ('images' (N, s, s, C) uint8 + 'labels' (N, 1) uint8,
data_generator.cpp:279-304).

Each attempt runs as gpd_tpu's programs (datagen.py:227-244): the
detector's A and B (``GraspDetector.candidates_with_images``: samples and
candidates, one read of their counts, images and scores over the live
blocks and chunks), then R, the relabeling, each a CUDA graph replay on a
card in the detector's graphs and pool, eager on the CPU; then one read of
the valid labels. The detector's ``_force_eager`` takes the eager attempt
(``sample_points``, ``detect_core``, ``reevaluate_hypotheses``).

Progress is journaled per (object, view), so an interrupted run resumes
where it left off; rows are written at running offsets as the reference's
insertIntoHDF5 does (data_generator.cpp:460-).

Randomness: each (object, view) gets its own ``torch.Generator`` on the
detector's device, seeded from ``seed`` and gpd_tpu's crc32 salt of
"object:view" (``view_generator``); its attempts draw in call order, every
draw behind ``ops/draws.py``. Balancing and the final permutation keep
gpd_tpu's NumPy generator, so the same labels give the same rows.

The work list is sharded round-robin by ``process_index`` /
``process_count`` as in gpd_tpu; each process writes its own shard.
h5py is imported where a file is opened, so the module imports without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gpd_tpu_torch import profiling
from gpd_tpu_torch.config import ConfigFile
from gpd_tpu_torch.core.types import CloudArrays
from gpd_tpu_torch.detector import GraspDetector
from gpd_tpu_torch.ops import candidates as cand


@dataclasses.dataclass
class DataGenConfig:
    """Parameters from cfg/generate_data.cfg (data_generator.cpp:10-71)."""

    data_root: str = ""
    objects_file: str = ""
    output_root: str = "."
    num_views_per_object: int = 20
    min_grasps_per_view: int = 100
    max_grasps_per_view: int = 500
    test_views: Sequence[int] = (2, 5, 8, 13, 16)
    chunk_size: int = 1000
    num_samples: int = 500

    @staticmethod
    def from_file(path: str) -> "DataGenConfig":
        cfg = ConfigFile(path)
        return DataGenConfig(
            data_root=cfg.get_str("data_root", ""),
            objects_file=cfg.get_str("objects_file_location", ""),
            output_root=cfg.get_str("output_root", "."),
            num_views_per_object=cfg.get_int("num_views_per_object", 20),
            min_grasps_per_view=cfg.get_int("min_grasps_per_view", 100),
            max_grasps_per_view=cfg.get_int("max_grasps_per_view", 500),
            test_views=tuple(cfg.get_int_list("test_views", "2 5 8 13 16")),
            chunk_size=cfg.get_int("chunk_size", 1000),
            num_samples=cfg.get_int("num_samples", 500),
        )


def balance_instances(max_count: int, positives: np.ndarray,
                      negatives: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """50/50 class balancing capped at max_count
    (data_generator.cpp:406-430 balanceInstances): keeps
    min(#pos, #neg, max_count) of each class."""
    n = min(len(positives), len(negatives), max_count)
    pos = rng.permutation(positives)[:n]
    neg = rng.permutation(negatives)[:n]
    return np.concatenate([pos, neg])


# The columns of a hand in ``DataGenerator``'s packed float32 table, and
# their widths.
HAND_FIELDS = (("sample", 3), ("orientation", 9), ("top", 1),
               ("finger_placement", 1), ("sample_id", 1), ("attempt", 1),
               ("label", 1))
_INT_FIELDS = ("finger_placement", "sample_id", "attempt", "label")


def _hand_fields(table: torch.Tensor) -> dict:
    """The packed (n, 17) float32 hands as a dict of (n, ...) tensors: the
    rotation (n, 3, 3), the integer fields int64."""
    out, col = {}, 0
    for name, width in HAND_FIELDS:
        v = table[:, col:col + width]
        col += width
        if name == "orientation":
            v = v.reshape(-1, 3, 3)
        elif width == 1:
            v = v[:, 0]
        out[name] = v.long() if name in _INT_FIELDS else v
    return out


def _on_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host. From a card it is copied into page-locked memory
    from torch's caching host allocator, which serves a later copy of the
    same size from the same pages once the caller has dropped the array: a
    pageable copy of a view's rows (35-54 MB) faulted fresh pages in on
    every view."""
    if not t.is_cuda:
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


class HDF5ShardWriter:
    """Chunked HDF5 writer in the reference's dataset layout with an offset
    journal for resume (replaces createDatasetsHDF5/insertIntoHDF5/
    reshapeHDF5, data_generator.cpp:279-347,460-)."""

    def __init__(self, path: str, image_size: int, channels: int,
                 chunk_size: int = 1000):
        import h5py
        self.path = path
        self.journal_path = path + ".journal"
        try:
            self.h5 = h5py.File(path, "a")
        except OSError:
            # A crash can leave the file unopenable two ways: truncated
            # before the first flush (no HDF5 superblock at all), or killed
            # mid-write with a valid signature but eof < stored_eof. The
            # journal is the source of truth either way. h5py raises
            # OSError for lock contention / permissions too, so recover
            # destructively only when the file is genuinely unreadable:
            # not-HDF5, or HDF5 that fails even a read-only open.
            corrupt = False
            if os.path.exists(path):
                if not h5py.is_hdf5(path):
                    corrupt = True
                else:
                    # Probe with locking disabled: under default HDF5 file
                    # locking a CONCURRENT writer's exclusive lock also makes
                    # h5py.File(path, 'r') raise OSError, and deleting here
                    # would destroy a live shard another process is writing
                    # (multi-host generate() shards by process_index). With
                    # locking=False the open only fails if the bytes are
                    # genuinely unreadable.
                    try:
                        h5py.File(path, "r", locking=False).close()
                    except OSError:
                        corrupt = True
                    except TypeError:  # h5py too old for locking kwarg
                        try:
                            h5py.File(path, "r").close()
                        except OSError:
                            corrupt = True
            if not corrupt:
                raise
            os.remove(path)
            if os.path.exists(self.journal_path):
                os.remove(self.journal_path)
            self.h5 = h5py.File(path, "a")
        shape = (image_size, image_size, channels)
        if "images" not in self.h5:
            self.h5.create_dataset(
                "images", shape=(0,) + shape, maxshape=(None,) + shape,
                dtype=np.uint8, chunks=(chunk_size,) + shape)
            self.h5.create_dataset(
                "labels", shape=(0, 1), maxshape=(None, 1), dtype=np.uint8,
                chunks=(chunk_size, 1))
        self.done = set()
        if os.path.exists(self.journal_path):
            with open(self.journal_path) as f:
                for line in f:
                    rec = json.loads(line)
                    self.done.add((rec["obj"], rec["view"]))
                    # Truncate any partial write past the journaled offset.
            last_offset = max((rec["end"] for rec in map(
                json.loads, open(self.journal_path))), default=0)
            if self.h5["labels"].shape[0] > last_offset:
                self.h5["images"].resize(last_offset, axis=0)
                self.h5["labels"].resize(last_offset, axis=0)

    def is_done(self, obj: str, view: int) -> bool:
        return (obj, view) in self.done

    def append(self, obj: str, view: int, images: np.ndarray,
               labels: np.ndarray) -> None:
        n0 = self.h5["labels"].shape[0]
        n1 = n0 + len(labels)
        self.h5["images"].resize(n1, axis=0)
        self.h5["labels"].resize(n1, axis=0)
        self.h5["images"][n0:n1] = images
        self.h5["labels"][n0:n1] = labels.reshape(-1, 1).astype(np.uint8)
        self.h5.flush()
        with open(self.journal_path, "a") as f:
            f.write(json.dumps({"obj": obj, "view": view,
                                "start": n0, "end": n1}) + "\n")
        self.done.add((obj, view))

    def shuffle_in_place(self, seed: int = 0, block: int = 20000) -> None:
        """Final shuffle (replaces shuffle_hdf5.py): streaming
        monotonic-gather blocks into a temp file + atomic rename, O(block)
        memory at any dataset size (same scheme as
        apps/hdf5_tools.py cmd_shuffle). The previous all-in-RAM permutation
        spiked ~11 GB at the end of a multi-hour 201k-example run — the
        worst possible moment for an OOM kill."""
        import h5py
        n = self.h5["labels"].shape[0]
        perm = np.random.default_rng(seed).permutation(n)
        self.h5.flush()
        tmp = self.path + ".shuffle.tmp"
        with h5py.File(tmp, "w") as dst:
            for name in ("images", "labels"):
                d = self.h5[name]
                out = dst.create_dataset(
                    name, shape=d.shape, dtype=d.dtype, chunks=d.chunks,
                    maxshape=d.maxshape)
                for b0 in range(0, n, block):
                    sel = perm[b0:b0 + block]
                    order = np.argsort(sel)
                    rows = d[np.sort(sel)]  # HDF5 needs monotonic indices
                    inv = np.empty_like(order)
                    inv[order] = np.arange(len(order))
                    out[b0:b0 + len(sel)] = rows[inv]
        self.h5.close()
        os.replace(tmp, self.path)
        self.h5 = h5py.File(self.path, "a")

    def close(self):
        self.h5.close()


def view_generator(seed: int, obj: str, view: int,
                   device) -> torch.Generator:
    """The generator of one (object, view) unit: seeded from ``seed`` and
    gpd_tpu's stable crc32 salt (datagen.py:282; Python's hash() is salted
    per process, which would make reruns irreproducible)."""
    salt = zlib.crc32(f"{obj}:{view}".encode()) & 0x7FFFFFFF
    return torch.Generator(device=device).manual_seed(
        (seed << 31 | salt) & ((1 << 64) - 1))


class DataGenerator:
    """Per-(object, view) labeled grasp-image generation
    (data_generator.cpp:73-277 generateData) on the detector's device."""

    def __init__(self, detector: GraspDetector, gen_cfg: DataGenConfig):
        self.detector = detector
        self.gen = gen_cfg
        self.last_counts = {}
        # The last view's packed hand tables (``HAND_FIELDS``' columns):
        # every attempt's valid candidates, and the kept rows.
        self._candidates = self._rows = None

    @property
    def last_candidates(self) -> dict:
        """The last view's valid candidates, every attempt's, as
        ``_hand_fields``; empty before the first view."""
        return {} if self._candidates is None else _hand_fields(
            self._candidates)

    @property
    def last_rows(self) -> dict:
        """The last view's kept rows in the returned order, as
        ``_hand_fields``; empty before the first view."""
        return {} if self._rows is None else _hand_fields(self._rows)

    def generate_view(self, view_cloud: CloudArrays, mesh_cloud: CloudArrays,
                      generator: torch.Generator,
                      rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """One (object, view) unit: candidates and images from the view
        cloud, ground-truth labels from the mesh cloud, balanced 50/50.
        Attempts repeat until ``min_grasps_per_view`` positives, at most 8,
        and stop after two in a row without a positive (the reference spins
        on such views forever). Returns (images (N, s, s, C) uint8, labels
        (N,) int32).

        Afterwards ``last_counts`` holds the attempts, the valid candidates,
        their positives, the rows kept and the mesh cloud's points;
        ``last_candidates`` every attempt's valid candidates and
        ``last_rows`` the kept rows, in the returned order, each a dict of
        device tensors (``HAND_FIELDS``: the hand's sample, its rotation,
        top, finger placement, sample index, attempt and label) unpacked
        from the view's packed tables when read; and the
        detector's ``last_graphs`` the keys the view replayed. The whole
        unit is the span ``datagen_view``, each attempt ``datagen_attempt``
        (holding detect's ``candidates``, ``candidates_read`` and ``score``,
        then ``relabel``), and the balance and the copy of the kept rows
        ``datagen_rows``."""
        det = self.detector
        with profiling.span("datagen_view"):
            cfg = det.effective_config(view_cloud)
            min_pos = self.gen.min_grasps_per_view
            images_all: List[torch.Tensor] = []
            labels_all: List[np.ndarray] = []
            hands_all: List[torch.Tensor] = []
            n_pos = 0
            zero_streak = 0
            det.programs.last_graphs = []
            for attempt in range(8):
                with profiling.span("datagen_attempt"):
                    labels, images, hands = self._attempt(
                        view_cloud, mesh_cloud, generator, cfg, attempt)
                labels_all.append(labels)
                images_all.append(images)
                hands_all.append(hands)
                got = int(labels.sum())
                n_pos += got
                zero_streak = zero_streak + 1 if got == 0 else 0
                if n_pos >= min_pos or zero_streak >= 2:
                    break
            with profiling.span("datagen_rows"):
                labels = np.concatenate(labels_all)
                pos_idx = np.nonzero(labels == 1)[0]
                neg_idx = np.nonzero(labels == 0)[0]
                keep = balance_instances(self.gen.max_grasps_per_view,
                                         pos_idx, neg_idx, rng)
                keep = rng.permutation(keep)
                # One attempt's images and hands are their own copies.
                one = len(images_all) == 1
                images = images_all[0] if one else torch.cat(images_all)
                table = hands_all[0] if one else torch.cat(hands_all)
                rows = torch.from_numpy(keep.astype(np.int64)).to(
                    images.device)
                self._candidates, self._rows = table, table[rows]
                out = _on_host(images[rows]).numpy(), labels[keep]
                self.last_counts = dict(
                    attempts=len(labels_all), candidates=len(labels),
                    positives=n_pos, kept=len(keep),
                    mesh_points=int(mesh_cloud.mask.sum()))
        return out

    def _attempt(self, view_cloud: CloudArrays, mesh_cloud: CloudArrays,
                 generator: torch.Generator, cfg, attempt: int = 0
                 ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
        """One attempt: the valid candidates' labels on the host, and on the
        device (copies) their images and hands (``_hand_fields``' packed
        columns, ``attempt`` as the attempt's). Candidates come
        valid-first, so all three are the valid prefix. B's hands are
        copied before R replays: a B captured after R may hold its outputs
        in memory that R uses inside its replay (``graphs.CapturedGraph``).

        R, the relabeling, runs in the span ``relabel`` with its read. It
        searches the mesh cloud under the mesh's effective config: up to
        ``search_identity_max`` every mesh point within the hand's radius,
        as the reference's kd-tree radius search gives them, where the view
        cloud's cap (gpd_tpu's, datagen.py:217) kept only the nearest
        ``search_neighbors_cap`` of a mesh larger than the view. R is keyed
        by the hand capacity, the mesh cloud's capacity and camera count and
        that config; the candidates and the mesh are copied into its
        inputs, and it draws nothing."""
        det = self.detector
        grasps, images, n_valid = det.candidates_with_images(
            view_cloud, generator, cfg)
        g = grasps
        hands = torch.cat([g.sample[:n_valid],
                           g.orientation[:n_valid].reshape(-1, 9),
                           g.top[:n_valid, None],
                           g.finger_placement[:n_valid, None],
                           g.sample_id[:n_valid, None],
                           torch.full_like(g.top[:n_valid, None], attempt)],
                          1)
        images = images[:n_valid].clone()
        rcfg = det.effective_config(mesh_cloud)
        with profiling.span("relabel"):
            labels = det.programs.run(
                ("relabel", mesh_cloud.device, grasps.capacity,
                 mesh_cloud.capacity, mesh_cloud.num_cameras, rcfg),
                lambda _, mesh, g: cand.reevaluate_hypotheses(mesh, g,
                                                              rcfg)[0],
                (mesh_cloud, grasps))[:n_valid]
            host = labels.cpu().numpy()
        return host, images, torch.cat([hands, labels[:, None]], 1)

    def generate(self, items: Sequence[Tuple[str, int, CloudArrays, CloudArrays]],
                 writer_train: HDF5ShardWriter,
                 writer_test: Optional[HDF5ShardWriter] = None,
                 seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 total_items: Optional[int] = None) -> None:
        """Drive generation over a work-list of (object_name, view_id,
        view_cloud, mesh_cloud); shards round-robin across processes and
        resumes from the journal."""
        rng = np.random.default_rng(seed + process_index)
        t0 = time.time()
        n_done = 0
        for i, (obj, view, vc, mc) in enumerate(items):
            if i % process_count != process_index:
                continue
            is_test = view in self.gen.test_views
            writer = writer_test if (is_test and writer_test) else writer_train
            if writer.is_done(obj, view):
                continue
            images, labels = self.generate_view(
                vc, mc, view_generator(seed, obj, view, self.detector.device),
                rng)
            writer.append(obj, view, images, labels)
            n_done += 1
            # Per-view rate + ETA like the reference
            # (data_generator.cpp:230-247); total_items is a hint since the
            # work-list streams lazily.
            per = (time.time() - t0) / max(n_done, 1)
            msg = (f"[{obj}:{view}] {len(labels)} instances "
                   f"({int(labels.sum())} pos), {per:.1f}s/view")
            if total_items:
                n_mine = -(-(total_items - process_index) // process_count)
                rem = per * max(n_mine - n_done, 0)
                msg += (f", ETA {int(rem // 3600)}h "
                        f"{int(rem % 3600 // 60)}m {int(rem % 60)}s")
            print(msg, flush=True)


def read_pose_hdf5(path: str, dsname: str) -> np.ndarray:
    """Read a 4x4 pose matrix from a BigBIRD HDF5 file
    (data_generator.cpp:691-701 readPoseFromHDF5)."""
    import h5py
    with h5py.File(path, "r") as f:
        mat = np.asarray(f[dsname], dtype=np.float32)
    if mat.shape != (4, 4):
        raise ValueError(f"{path}:{dsname}: expected (4,4), got {mat.shape}")
    return mat


def calculate_transform(data_root: str, obj: str, camera: int, angle: int,
                        reference_camera: int) -> np.ndarray:
    """Camera->table transform for one BigBIRD view
    (data_generator.cpp:667-689 calculateTransform):

        T = H_table_from_ref(angle) @ inv(H_NP<camera>_from_NP<ref>)

    from <obj>/poses/NP<ref>_<angle>_pose.h5 and <obj>/calibration.h5.
    """
    pose_file = os.path.join(
        data_root, obj, "poses",
        f"NP{reference_camera}_{angle}_pose.h5")
    t_table_from_ref = read_pose_hdf5(pose_file,
                                      "H_table_from_reference_camera")
    calib_file = os.path.join(data_root, obj, "calibration.h5")
    t_cam_from_ref = read_pose_hdf5(
        calib_file, f"H_NP{camera}_from_NP{reference_camera}")
    return t_table_from_ref @ np.linalg.inv(t_cam_from_ref)


def fuse_views(clouds: Sequence[np.ndarray],
               transforms: Sequence[np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Transform per-view clouds into the table frame and concatenate
    (data_generator.cpp:630-661): returns (points, camera-source bitmask —
    bit i = view i, replacing the reference's block 0/1 matrix — and the
    per-view camera positions T[:3, 3])."""
    pts_out = []
    cam_out = []
    cam_pos = []
    for k, (pts, T) in enumerate(zip(clouds, transforms)):
        hom = np.concatenate(
            [pts, np.ones((len(pts), 1), pts.dtype)], 1).astype(np.float32)
        pts_out.append((hom @ T.T)[:, :3])
        cam_out.append(np.full(len(pts), np.uint32(1) << np.uint32(k),
                               np.uint32))
        cam_pos.append(T[:3, 3])
    return (np.concatenate(pts_out), np.concatenate(cam_out),
            np.stack(cam_pos).astype(np.float32))


def create_multiview_cloud(data_root: str, obj: str, camera: int,
                           angles: Sequence[int], reference_camera: int,
                           capacity: Optional[int] = None,
                           device=None) -> CloudArrays:
    """BigBIRD multi-view fusion (data_generator.cpp:617-665
    createMultiViewCloud): load <obj>/clouds/NP<camera>_<angle>.pcd for each
    turntable angle, transform into the table frame via the pose/calibration
    HDF5s, concatenate with per-view camera sources and camera positions.
    The cloud lands on ``device`` (CUDA unless named)."""
    from gpd_tpu_torch.io.pcd import load_cloud_file
    clouds = []
    transforms = []
    for angle in angles:
        path = os.path.join(data_root, obj, "clouds",
                            f"NP{camera}_{angle}.pcd")
        pts = load_cloud_file(path)
        pts = pts[np.isfinite(pts).all(axis=1)]
        clouds.append(pts.astype(np.float32))
        transforms.append(
            calculate_transform(data_root, obj, camera, angle,
                                reference_camera))
    pts, cam, vp = fuse_views(clouds, transforms)
    return CloudArrays.from_numpy(pts, view_points=vp, cam_source=cam,
                                  capacity=capacity, device=device)
