"""request_mfu: the LeNet forward operations of the traced requests'
valid candidates (``_work.lenet_forward_flops``) over their summed request
time and the bfloat16 peak, in percent."""

from h100_bench.metrics import _work


def read(layer):
    reqs = layer.get("requests")
    if not reqs:
        return None
    flops = sum(q["hands"] for q in reqs) * _work.lenet_forward_flops(
        layer["channels"], layer["size"])
    if not flops:
        return None
    t = sum(q["latency_s"] for q in reqs)
    return flops / t / _work.PEAK_BF16_FLOPS * 100.0
