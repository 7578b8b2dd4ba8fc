"""datagen_images_kernel_ms: the device time (kernels, copies, sets)
launched inside the program's ``candidates`` and ``score`` spans (detect's
graphs A and B: samples, frames, the hand search, descriptors, images and
LeNet), per data-generation view (``_datagen``)."""

from h100_bench.metrics import _datagen, _spans


def read(layer):
    return _datagen.per_view_ms(layer, ["candidates", "score"],
                                _spans.device_us)
