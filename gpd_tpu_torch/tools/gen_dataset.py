"""Generate a labeled grasp-image training set from the synthetic object zoo
(port of gpd_tpu's tools/gen_dataset.py).

A stand-in for the reference's ``generate_data`` over BigBIRD (reference:
src/gpd/data_generator.cpp:73-277, src/generate_data.cpp): each (object,
view) pair runs candidates and descriptors on the partial view cloud and
labels each candidate by re-evaluating it against the object's dense
ground-truth cloud, then balances 50/50 and appends to train/test HDF5.
The work list is gpd_tpu's, item for item (its NumPy rendering is shared):

  - single-object items alternate 1-camera and 2-camera fused views
    (``synthetic.render_fused_views``, the analog of createMultiViewCloud,
    data_generator.cpp:617-665);
  - multi-object table scenes (2-4 objects on a plane,
    ``synthetic.make_scene``) captured with 2 fused cameras and
    occlusion-aware rendering; their ground truth holds the table and the
    neighboring objects, so a collision with clutter labels negative.

    python -m gpd_tpu_torch.tools.gen_dataset OUT_DIR [num_objects] \
        [views_per_object] [num_scenes]

Writes OUT_DIR/train.h5 and OUT_DIR/test.h5 (the reference's layout:
'images' (N, 60, 60, C) uint8, 'labels' (N, 1) uint8), both shuffled in
place; the last view of every object and scene goes to test.h5. Progress
is journaled per (object, view), so a rerun resumes. Runs on the CUDA card
(``main(argv, device="cpu")`` for the CPU), each attempt as the detector's
CUDA graphs there.

The detector is ``DetectorConfig()``'s defaults with the tool's three
overrides (``num_samples=NUM_SAMPLES``, ``min_inliers=0``,
``weights_file=""``): gpd_tpu's tool reads the reference's
cfg/eigen_params.cfg first, which the repo does not hold. Every view and
mesh is padded to a fixed capacity, so one set of graph keys serves all
single-object views and one all scene views; the environment variables
``GPD_VIEW_CAPACITY``, ``GPD_SCENE_VIEW_CAPACITY``, ``GPD_MESH_CAPACITY``,
``GPD_SCENE_MESH_CAPACITY`` and ``GPD_NUM_SAMPLES`` override them as in
gpd_tpu.
"""

import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

VIEW_CAPACITY = int(os.environ.get("GPD_VIEW_CAPACITY", 4096))
SCENE_VIEW_CAPACITY = int(os.environ.get("GPD_SCENE_VIEW_CAPACITY", 12288))
MESH_CAPACITY = int(os.environ.get("GPD_MESH_CAPACITY", 6144))
SCENE_MESH_CAPACITY = int(os.environ.get("GPD_SCENE_MESH_CAPACITY", 33792))
NUM_SAMPLES = int(os.environ.get("GPD_NUM_SAMPLES", 300))


def _mesh_arrays(mpts, mnrm, capacity, device):
    from gpd_tpu_torch.core.types import CloudArrays
    return CloudArrays.from_numpy(
        mpts, normals=mnrm, view_points=np.zeros((1, 3), np.float32),
        capacity=capacity, device=device)


def _fit_capacity(rng, vpts, vcam, cap):
    """Random downsample a raw rendered view to the pinned capacity (the
    synthetic sensor's resolution limit): fused 2-camera captures can
    exceed it before voxelization."""
    if len(vpts) > cap:
        idx = rng.choice(len(vpts), cap, replace=False)
        vpts = vpts[idx]
        vcam = None if vcam is None else vcam[idx]
    return vpts, vcam


def build_items(det, num_objects: int, views_per_object: int, seed: int = 0,
                num_scenes: int = 0):
    """Work list of (name, view_id, view CloudArrays, mesh CloudArrays),
    streamed: each view is preprocessed by ``det`` as it is reached, and
    each mesh made on ``det.device``.

    Single objects: odd views render two fused cameras (multi-camera
    normals orientation and shadow intersection see real 2-camera
    statistics). Scenes: every capture is 2 fused cameras with occlusion
    rendering.

    Scene items stream first: they are the scarcer signal, so a run cut
    short (or resumed) always has full clutter coverage.
    """
    from gpd_tpu_torch.datasets import synthetic as syn

    srng = np.random.default_rng(seed + 7)
    for s in range(num_scenes):
        spts, snrm = syn.make_scene(srng)
        mesh = _mesh_arrays(spts, snrm, SCENE_MESH_CAPACITY, det.device)
        cams = syn.view_cameras(srng, 2 * views_per_object, dist=0.7)
        for v in range(views_per_object):
            vpts, vcam, vps = syn.render_fused_views(
                srng, spts, snrm, cams[2 * v:2 * v + 2], occluded=True)
            if len(vpts) < 500:
                continue
            vpts, vcam = _fit_capacity(srng, vpts, vcam, SCENE_VIEW_CAPACITY)
            view = det.preprocess_cloud(
                vpts, view_points=vps, cam_source=vcam,
                capacity=SCENE_VIEW_CAPACITY)
            yield f"scene_{s:03d}", v, view, mesh

    rng = np.random.default_rng(seed + 1)
    for name, mpts, mnrm in syn.object_zoo(num_objects, seed=seed):
        mesh = _mesh_arrays(mpts, mnrm, MESH_CAPACITY, det.device)
        cams = syn.view_cameras(rng, 2 * views_per_object)
        for v in range(views_per_object):
            if v % 2 == 1:
                vpts, vcam, vps = syn.render_fused_views(
                    rng, mpts, mnrm, cams[2 * v:2 * v + 2], occluded=False)
            else:
                vpts = syn.render_view(rng, mpts, mnrm, cams[2 * v])
                vcam, vps = None, cams[2 * v].reshape(1, 3)
            if len(vpts) < 200:
                continue
            vpts, vcam = _fit_capacity(rng, vpts, vcam, VIEW_CAPACITY)
            view = det.preprocess_cloud(
                vpts, view_points=vps, cam_source=vcam,
                capacity=VIEW_CAPACITY)
            yield name, v, view, mesh


def make_detector(device=None):
    """The tool's detector: ``DetectorConfig()`` with its three overrides,
    on ``device`` (CUDA unless named)."""
    from gpd_tpu_torch.config import DetectorConfig
    from gpd_tpu_torch.detector import GraspDetector

    cfg = dataclasses.replace(DetectorConfig(), num_samples=NUM_SAMPLES,
                              min_inliers=0, weights_file="")
    return GraspDetector(cfg, device=device)


def make_generator(det, views_per_object: int):
    """gpd_tpu's tool's DataGenerator: 30-400 grasps a view, the last view
    of every object and scene held out for test."""
    from gpd_tpu_torch.datagen import DataGenConfig, DataGenerator

    return DataGenerator(det, DataGenConfig(
        min_grasps_per_view=30, max_grasps_per_view=400,
        num_views_per_object=views_per_object,
        test_views=(views_per_object - 1,)))


def main(argv=None, device=None):
    """Returns 0. ``device`` defaults to CUDA."""
    argv = argv if argv is not None else sys.argv[1:]
    from gpd_tpu_torch.datagen import HDF5ShardWriter

    out_dir = argv[0] if len(argv) > 0 else os.path.join(
        tempfile.gettempdir(), "gpd_dataset")
    num_objects = int(argv[1]) if len(argv) > 1 else 24
    views_per_object = int(argv[2]) if len(argv) > 2 else 8
    num_scenes = int(argv[3]) if len(argv) > 3 else max(num_objects // 3, 1)
    os.makedirs(out_dir, exist_ok=True)

    det = make_detector(device)
    gen = make_generator(det, views_per_object)
    C = det.cfg.image_geometry.num_channels
    size = det.cfg.image_geometry.size
    wtrain = HDF5ShardWriter(os.path.join(out_dir, "train.h5"), size, C)
    wtest = HDF5ShardWriter(os.path.join(out_dir, "test.h5"), size, C)

    t0 = time.time()
    try:
        items = build_items(det, num_objects, views_per_object,
                            num_scenes=num_scenes)
        total = (num_objects + num_scenes) * views_per_object
        gen.generate(items, wtrain, writer_test=wtest, total_items=total)
        wtrain.shuffle_in_place()
        wtest.shuffle_in_place()
        ntr = wtrain.h5["labels"].shape[0]
        nte = wtest.h5["labels"].shape[0]
    finally:
        wtrain.close()
        wtest.close()
    print(f"done: train={ntr} test={nte} in {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
