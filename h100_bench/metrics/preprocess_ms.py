"""preprocess_ms: the mean host time of a traced request's preprocessing,
from its start (the file read, for a request from a file) to a device sync
after ``preprocess_cloud``: the benchmark's own clock."""


def read(layer):
    t = layer.get("preprocess_s")
    return sum(t) / len(t) * 1e3 if t else None
