"""The share of a raster kernel's roofline over a traced window: the
least bytes of the traced requests' images (``_work.raster_bytes``, from
the benchmark's own counts) at the HBM peak, over the traced time of every
kernel whose name holds the kernel's name. Nothing when no such kernel
ran."""

from h100_bench import trace as tr
from h100_bench.metrics import _work


def share(layer, kernel: str):
    evs = layer.get("events")
    reqs = layer.get("requests")
    if not evs or not reqs:
        return None
    w0, w1 = layer["window"]
    t = sum(b - a for a, b, e in tr.clipped(tr.device_ops(evs, ("kernel",)),
                                            w0, w1) if kernel in e["name"])
    if t <= 0:
        return None
    nbytes = sum(_work.raster_bytes(layer["channels"], layer["size"],
                                    q["hands"], q["nbhd_points"])
                 for q in reqs)
    return _work.roofline_share(nbytes, t / 1e6)
