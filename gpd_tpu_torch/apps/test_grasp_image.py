"""CLI: descriptor debug path, the candidates and grasp image at one sample
(port of gpd_tpu/apps/test_grasp_image.py; reference:
src/tests/test_grasp_image.cpp, README.md:223).

Usage: python -m gpd_tpu_torch.apps.test_grasp_image PCD SAMPLE_INDEX [OUT_PNG]

Runs on the card unless ``main(argv, device="cpu")``.
"""

import sys

import numpy as np
import torch

from gpd_tpu_torch import viz
from gpd_tpu_torch.config import DetectorConfig
from gpd_tpu_torch.detector import GraspDetector, detect_core
from gpd_tpu_torch.io.pcd import load_cloud_file


def hand_poses(pcd: str, sample_idx: int, device=None):
    """The hand poses at one processed cloud point: (sample index used,
    Grasps in valid-first order, their uint8 images). The reference test's
    hard-coded parameters (hand 0.01/0.12/0.06/0.02, image
    0.10/0.06/0.02/60/15), one sample, the view point at the origin, draws
    from ``torch.Generator(device).manual_seed(0)``."""
    cfg = DetectorConfig(num_samples=1)
    det = GraspDetector(cfg, device=device)
    cloud = det.preprocess_cloud(load_cloud_file(pcd),
                                 view_points=np.zeros((1, 3), np.float32))
    sample_idx = min(sample_idx, int(cloud.mask.sum()) - 1)
    spos = cloud.points[sample_idx:sample_idx + 1]
    smask = torch.ones(1, dtype=torch.bool, device=det.device)
    gen = torch.Generator(device=det.device).manual_seed(0)
    grasps, images = detect_core(cloud, spos, smask, det.net, gen, cfg, 16)
    return sample_idx, grasps, images


def main(argv=None, device=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: test_grasp_image PCD_FILE SAMPLE_INDEX [OUT_PNG]")
        return -1
    sample_idx, grasps, images = hand_poses(argv[0], int(argv[1]), device)
    h = grasps.to_host()
    print(f"sample {sample_idx}: {int(h.valid.sum())} valid hand poses")
    for i in np.nonzero(h.valid)[0]:
        print(f"  orientation {i}: full_antipodal="
              f"{bool(h.full_antipodal[i])} "
              f"half={bool(h.half_antipodal[i])} "
              f"width={float(h.width[i]):.4f}")
    if h.valid.any():
        first = int(np.nonzero(h.valid)[0][0])
        out_png = argv[2] if len(argv) > 2 else "grasp_image.png"
        try:
            viz.grasp_image_grid(images[first], out_png)
        except ImportError as e:         # matplotlib is optional
            print(f"did not write {out_png}: {e}")
        else:
            print(f"wrote {out_png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
