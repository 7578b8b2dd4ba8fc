"""CLI: label candidates from a view cloud against a ground-truth mesh cloud
(port of gpd_tpu/apps/label_grasps.py; the reference's
src/label_grasps.cpp).

    python -m gpd_tpu_torch.apps.label_grasps CONFIG_FILE PCD_FILE MESH_PCD_FILE

Both clouds are preprocessed with the config's camera position as their
view point; candidates and images come from the view cloud, labels from
``reevaluate_hypotheses`` on the mesh cloud. Runs on the CUDA card.
"""

import sys

import numpy as np


def main(argv=None, device=None):
    """Returns 0, or -1 on a usage error. ``device`` defaults to CUDA."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print("Usage: label_grasps CONFIG_FILE PCD_FILE MESH_PCD_FILE")
        return -1

    import torch

    from gpd_tpu_torch.config import load_config
    from gpd_tpu_torch.detector import GraspDetector, detect_core
    from gpd_tpu_torch.io.pcd import load_cloud_file
    from gpd_tpu_torch.ops import candidates as cand

    cfg = load_config(argv[0])
    detector = GraspDetector(cfg, device=device)
    vp = np.asarray(cfg.camera_position, np.float32).reshape(1, 3)

    view_cloud = detector.preprocess_cloud(load_cloud_file(argv[1]),
                                           view_points=vp)
    mesh_cloud = detector.preprocess_cloud(load_cloud_file(argv[2]),
                                           view_points=vp)

    gen = torch.Generator(device=detector.device).manual_seed(0)
    spos, smask = detector.sample_cloud(view_cloud, gen)
    cap = detector.image_cap(spos.shape[0])
    grasps, _ = detect_core(view_cloud, spos, smask, detector.net, gen, cfg,
                            cap)
    n = int(grasps.valid.sum())
    print(f"Created {n} grasp candidates with images.")

    labels, _ = cand.reevaluate_hypotheses(mesh_cloud, grasps, cfg)
    n_pos = int(labels.sum())
    print(f"Ground-truth antipodal grasps: {n_pos}/{n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
