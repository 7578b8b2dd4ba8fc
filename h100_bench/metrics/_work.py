"""The work a request, view or step needs, counted from shapes and counts
that the benchmark reads itself, and the card's published peaks: the
operations and bytes behind the rooflines and mfu shares. No count depends
on how the program chunks or pads its launches.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989 TFLOP/s in bfloat16, 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def lenet_forward_flops(channels: int, size: int = 60) -> int:
    """Multiply-adds x 2 of one image through the LeNet: conv1 C->20 5x5,
    2x2 pool, conv2 20->50 5x5, 2x2 pool, fc 50*s*s->500, fc 500->2
    (gpd_tpu_torch/net/lenet.py). Biases, ReLUs and pools are left out,
    so the count errs low. 83.04 MFLOP at 15 channels, 45.41 at 3."""
    c1 = size - 4
    p1 = c1 // 2
    c2 = p1 - 4
    p2 = c2 // 2
    conv1 = 2 * c1 * c1 * 20 * channels * 25
    conv2 = 2 * c2 * c2 * 50 * 20 * 25
    fc = 2 * (50 * p2 * p2 * 500 + 500 * 2)
    return conv1 + conv2 + fc


def lenet_train_flops(channels: int, size: int = 60) -> int:
    """One image's forward and backward: three forwards."""
    return 3 * lenet_forward_flops(channels, size)


# The image planes a raster kernel writes per hand, as float32 sums: the
# request needs one per channel (the kernels write more: counts, shadow
# sums), so the count errs low.
def raster_bytes(channels: int, size: int, hands: int,
                 nbhd_points: int) -> int:
    """Least bytes of a request's images: each valid hand's planes
    (size x size x channels float32) written once, and each point of each
    valid hand's image neighbourhood read once as six 2-byte values (its
    position in the hand frame and |normal|)."""
    return hands * size * size * channels * 4 + nbhd_points * 12


def roofline_share(nbytes: float, kernel_s: float) -> float:
    """The least time the bytes take at the HBM peak, over the kernels'
    time, in percent."""
    return nbytes / PEAK_HBM_BYTES / kernel_s * 100.0
