"""CLI: generate labeled training data (port of
gpd_tpu/apps/generate_data.py; the reference's src/generate_data.cpp).

    python -m gpd_tpu_torch.apps.generate_data CONFIG_FILE

The config follows cfg/generate_data.cfg plus the detector's keys: a data
root with per-object view clouds DATA_ROOT/OBJ/view_NN.pcd and ground-truth
mesh clouds DATA_ROOT/OBJ/gt_cloud.pcd, the objects listed one per line in
``objects_file_location``. Writes OUTPUT_ROOT/train.h5 (shuffled) and
OUTPUT_ROOT/test.h5 (the ``test_views``). Progress is journaled per
(object, view); re-running resumes. Runs on the CUDA card.
"""

import os
import sys


def main(argv=None, device=None):
    """Returns 0, or -1 on a usage error. ``device`` defaults to CUDA."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("Usage: generate_data CONFIG_FILE")
        return -1

    from gpd_tpu_torch.config import load_config
    from gpd_tpu_torch.datagen import (DataGenConfig, DataGenerator,
                                       HDF5ShardWriter)
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.io.pcd import load_cloud_file

    cfg = load_config(argv[0])
    gen_cfg = DataGenConfig.from_file(argv[0])
    det = GraspDetector(cfg, device=device)
    gen = DataGenerator(det, gen_cfg)

    with open(gen_cfg.objects_file) as f:
        objects = [ln.strip() for ln in f if ln.strip()]
    print(f"Generating data for {len(objects)} objects, "
          f"{gen_cfg.num_views_per_object} views each.")

    def iter_items():
        for obj in objects:
            mesh_path = os.path.join(gen_cfg.data_root, obj, "gt_cloud.pcd")
            mesh = det.preprocess_cloud(load_cloud_file(mesh_path),
                                        capacity="serve")
            for view in range(gen_cfg.num_views_per_object):
                vp = os.path.join(gen_cfg.data_root, obj,
                                  f"view_{view:02d}.pcd")
                if not os.path.exists(vp):
                    continue
                view_cloud = det.preprocess_cloud(load_cloud_file(vp),
                                                  capacity="serve")
                yield obj, view, view_cloud, mesh

    C = cfg.image_geometry.num_channels
    size = cfg.image_geometry.size
    os.makedirs(gen_cfg.output_root, exist_ok=True)
    train_w = HDF5ShardWriter(
        os.path.join(gen_cfg.output_root, "train.h5"), size, C,
        gen_cfg.chunk_size)
    test_w = HDF5ShardWriter(
        os.path.join(gen_cfg.output_root, "test.h5"), size, C,
        gen_cfg.chunk_size)
    try:
        gen.generate(list(iter_items()), train_w, test_w)
        train_w.shuffle_in_place()
    finally:
        train_w.close()
        test_w.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
