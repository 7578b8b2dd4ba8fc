"""d2h_copy_ms.datagen: the device-to-host copies launched inside the
program's ``datagen_view`` spans (the counts' and the labels' reads, the
kept rows' images), per data-generation view (``_datagen``)."""

from h100_bench import trace as tr
from h100_bench.metrics import _datagen


def _d2h_us(layer, ivs):
    return sum(e["dur"] for e in tr.launched_inside(
        layer["events"], ivs, ("gpu_memcpy",)) if "DtoH" in e["name"])


def read(layer):
    return _datagen.per_view_ms(layer, ["datagen_view"], _d2h_us)
