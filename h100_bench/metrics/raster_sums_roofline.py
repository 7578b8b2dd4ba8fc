"""raster_sums_roofline: the 1/3-channel raster kernel's share of its
roofline over the traced requests (``_roofline``)."""

from h100_bench.metrics import _roofline


def read(layer):
    return _roofline.share(layer, "raster_sums")
