"""CLI: CEM-based grasp detection (port of
gpd_tpu/apps/cem_detect_grasps.py; the reference's src/cem_detect_grasps.cpp).

    python -m gpd_tpu_torch.apps.cem_detect_grasps CONFIG PCD

runs on the CUDA card. The config's num_init_samples, num_iterations,
num_samples_per_iteration, prob_rand_samples, standard_deviation,
sampling_method and min_score keys set the sampling (``CEMConfig``).
"""

import sys

import numpy as np


def main(argv=None, device=None):
    """Returns 0, or -1 on a usage error. ``device`` defaults to CUDA."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: cem_detect_grasps CONFIG_FILE PCD_FILE")
        return -1

    from gpd_tpu_torch.cem import SequentialImportanceSampling
    from gpd_tpu_torch.config import CEMConfig, load_config
    from gpd_tpu_torch.detector import GraspDetector
    from gpd_tpu_torch.io.pcd import load_cloud_file

    cfg = load_config(argv[0])
    cem_cfg = CEMConfig.from_file(argv[0])
    detector = GraspDetector(cfg, device=device)
    points = load_cloud_file(argv[1])
    vp = np.asarray(cfg.camera_position, np.float32).reshape(1, 3)
    cloud = detector.preprocess_cloud(points, view_points=vp,
                                      capacity="serve")
    sis = SequentialImportanceSampling(detector, cem_cfg)
    sis.detect(cloud)
    return 0


if __name__ == "__main__":
    sys.exit(main())
