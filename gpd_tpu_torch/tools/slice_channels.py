"""Derive a 3-channel training set from a 15-channel one by slicing (port
of gpd_tpu's tools/slice_channels.py, NumPy and h5py only).

The 15-channel image layout is [proj0: normals x3, depth, shadow; proj1:
...; proj2: ...] (reference: image_15_channels_strategy.cpp:47-105), and the
3-channel strategy is exactly proj0's normals image
(image_3_channels_strategy.cpp), so channels 0:3 of a 15-channel dataset
are the 3-channel dataset. One generation run serves both classifiers.

    python -m gpd_tpu_torch.tools.slice_channels in.h5 out.h5 [C0 C1]

The output's datasets equal those gpd_tpu's tool writes, byte for byte.
"""

import sys

import numpy as np


def main(argv=None):
    """Returns 0, or -1 on a usage error."""
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: slice_channels IN_H5 OUT_H5 [C0 C1]")
        return -1
    import h5py

    src, dst = argv[0], argv[1]
    c0 = int(argv[2]) if len(argv) > 2 else 0
    c1 = int(argv[3]) if len(argv) > 3 else 3
    block = 8192
    with h5py.File(src, "r") as fi, h5py.File(dst, "w") as fo:
        n, s, _, _ = fi["images"].shape
        shape = (s, s, c1 - c0)
        fo.create_dataset("images", shape=(n,) + shape, dtype=np.uint8,
                          chunks=(1000,) + shape)
        fo.create_dataset("labels", data=fi["labels"][:])
        for i in range(0, n, block):
            fo["images"][i:i + block] = fi["images"][i:i + block, :, :, c0:c1]
    print(f"{dst}: {n} examples, channels [{c0}:{c1}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
