"""cem_request_mfu: the LeNet forward operations of the traced CEM
requests' valid hands (``_work.lenet_forward_flops`` x ``live_hands``)
over their summed request time and the bfloat16 peak, in percent: the
request's share of the card's peak, which bounds what a change to any of
its parts can gain."""

from h100_bench.metrics import _cem, _work


def read(layer):
    reqs = _cem.counters(layer)
    if reqs is None:
        return None
    flops = sum(q["live_hands"] for q in reqs) * _work.lenet_forward_flops(
        layer["channels"], layer["size"])
    t = sum(q["latency_s"] for q in reqs)
    return flops / t / _work.PEAK_BF16_FLOPS * 100.0 if flops and t \
        else None
