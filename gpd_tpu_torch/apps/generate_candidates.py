"""CLI: grasp candidates only, no CNN scoring (port of
gpd_tpu/apps/generate_candidates.py; the reference's
src/generate_candidates.cpp).

    python -m gpd_tpu_torch.apps.generate_candidates CONFIG PCD [OUT_CSV]

runs on the CUDA card, prints the candidate count and writes the valid
candidates to OUT_CSV when one is given.
"""

import sys

import numpy as np


def main(argv=None, device=None):
    """Returns 0, or -1 on a usage error. ``device`` defaults to CUDA."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: generate_candidates CONFIG_FILE PCD_FILE [OUT_CSV]")
        return -1

    import torch

    from gpd_tpu_torch.config import load_config
    from gpd_tpu_torch.core.types import write_grasps_csv
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.io.pcd import load_cloud_file
    from gpd_tpu_torch.ops import candidates as cand

    cfg = load_config(argv[0])
    detector = GraspDetector(cfg, device=device)
    points = load_cloud_file(argv[1])
    vp = np.asarray(cfg.camera_position, np.float32).reshape(1, 3)
    cloud = detector.preprocess_cloud(points, view_points=vp,
                                      capacity="serve")
    spos, smask = detector.sample_cloud(
        cloud, torch.Generator(device=detector.device).manual_seed(0))
    grasps = cand.search_hands(cloud, spos, smask, cfg)
    n = int(grasps.valid.sum())
    nfull = int(grasps.full_antipodal.sum())
    print(f"Generated {n} grasp candidates ({nfull} full-antipodal).")
    if len(argv) > 2:
        write_grasps_csv(argv[2], grasps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
