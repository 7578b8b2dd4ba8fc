"""train_upload_ms: the copy time launched inside the program's
``train_upload`` spans (each block's permutation, images and labels), per
window step (``_spans``)."""

from h100_bench.metrics import _spans


def read(layer):
    return _spans.per_step_ms(
        layer, "train_upload",
        lambda lay, ivs: _spans.device_us(lay, ivs, ("gpu_memcpy",)))
