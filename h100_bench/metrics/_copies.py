"""Copy time between host and device in the traced window, per unit of
work (view or step)."""

from h100_bench import trace as tr


def per_unit_ms(layer, kind: str, unit: str):
    evs = layer.get("events")
    n = layer.get(unit)
    if not evs or not n:
        return None
    w0, w1 = layer["window"]
    t = sum(b - a for a, b, e in tr.clipped(
        tr.device_ops(evs, ("gpu_memcpy",)), w0, w1) if kind in e["name"])
    return t / n / 1e3
