"""The share of the traced window in which no kernel, copy or set ran on
the device, in percent."""

from h100_bench import trace as tr


def share(layer):
    evs = layer.get("events")
    if not evs:
        return None
    w0, w1 = layer["window"]
    busy, _ = tr.busy_and_gaps(evs, w0, w1)
    return (1.0 - busy / (w1 - w0)) * 100.0
