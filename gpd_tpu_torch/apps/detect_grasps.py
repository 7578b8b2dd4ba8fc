"""CLI: detect grasp poses in a point cloud (port of
gpd_tpu/apps/detect_grasps.py).

The reference's ``detect_grasps`` app (src/detect_grasps.cpp):

    python -m gpd_tpu_torch.apps.detect_grasps CONFIG PCD [NORMALS_CSV] [OUT_CSV] [--staged]

runs on the CUDA card. A NORMALS_CSV argument, even an empty one, names a
file that must exist, as in gpd_tpu. ``--staged`` takes the detector's
staged route (``GraspDetector.detect(staged=True)``), which prints the
reference's per-stage runtime report.
"""

import os
import sys

import numpy as np


def main(argv=None, device=None):
    """Returns 0, or -1 on a usage error or a missing file. ``device``
    defaults to CUDA."""
    argv = list(argv if argv is not None else sys.argv[1:])
    staged = "--staged" in argv
    if staged:
        argv.remove("--staged")
    if len(argv) < 2:
        print("Error: Not enough input arguments!\n")
        print("Usage: detect_grasps CONFIG_FILE PCD_FILE [NORMALS_FILE] "
              "[OUT_CSV] [--staged]\n")
        print("Detect grasp poses for a point cloud, PCD_FILE (*.pcd), "
              "using parameters from CONFIG_FILE (*.cfg).\n")
        return -1

    config_filename, pcd_filename = argv[0], argv[1]
    normals_filename = argv[2] if len(argv) > 2 else None
    # The reference's checkFileExists: a message and -1, not a traceback.
    files = [config_filename, pcd_filename]
    if normals_filename is not None:
        files.append(normals_filename)
    for f in files:
        if not os.path.exists(f):
            print(f"File {f} could not be found!")
            return -1

    from gpd_tpu_torch.config import load_config
    from gpd_tpu_torch.core.types import write_grasps_csv
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.io.pcd import load_cloud_file, load_normals_csv

    cfg = load_config(config_filename)
    detector = GraspDetector(cfg, device=device)

    points = load_cloud_file(pcd_filename)
    print(f"Loaded point cloud with {points.shape[0]} points.")
    normals = None
    if normals_filename is not None:
        normals = load_normals_csv(normals_filename)
        print(f"Loaded surface normals from file: {normals_filename}")

    vp = np.asarray(cfg.camera_position, np.float32).reshape(1, 3)
    cloud = detector.preprocess_cloud(points, view_points=vp, normals=normals,
                                      capacity="serve")
    print(f"Processed cloud: {int(cloud.mask.sum())} points.")

    grasps = detector.detect(cloud, staged=staged)
    if len(argv) > 3:
        write_grasps_csv(argv[3], grasps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
