"""train_mfu: the LeNet forward and backward operations of the images of
the steps completed in the traced window (``_work.lenet_train_flops``)
over the window and the float32 peak (training runs float32, TF32 off),
in percent."""

from h100_bench.metrics import _work


def read(layer):
    n = layer.get("images")
    if not n:
        return None
    w0, w1 = layer["window"]
    flops = n * _work.lenet_train_flops(layer["channels"], layer["size"])
    return flops / ((w1 - w0) / 1e6) / _work.PEAK_F32_FLOPS * 100.0
