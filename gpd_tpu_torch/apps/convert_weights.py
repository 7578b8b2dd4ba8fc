"""CLI: convert classifier weights between formats (port of
gpd_tpu/apps/convert_weights.py; the reference's pytorch/torch_to_onnx.py
and the EigenClassifier raw-.bin loader, eigen_classifier.cpp:28-50).

    python -m gpd_tpu_torch.apps.convert_weights SRC DST.npz  [NUM_CHANNELS]
    python -m gpd_tpu_torch.apps.convert_weights SRC DST.onnx [NUM_CHANNELS] [--to-onnx]

SRC is any format ``net.lenet.load_params`` reads (a raw .bin directory,
.npz, a torch checkpoint, .onnx, OpenVINO .xml). A DST ending in .onnx, or
``--to-onnx``, writes ONNX through ``net.onnx_io.export_params_onnx``;
anything else writes .npz. Runs on the host only.
"""

import sys


def main(argv=None):
    """Returns 0, or -1 on a usage error."""
    argv = list(argv if argv is not None else sys.argv[1:])
    to_onnx = "--to-onnx" in argv
    if to_onnx:
        argv.remove("--to-onnx")
    if len(argv) < 2:
        print("Usage: convert_weights SRC DST.{npz,onnx} [NUM_CHANNELS] "
              "[--to-onnx]")
        return -1
    from gpd_tpu_torch.net import lenet
    from gpd_tpu_torch.net.onnx_io import export_params_onnx

    channels = int(argv[2]) if len(argv) > 2 else 15
    params = lenet.load_params(argv[0], channels)
    if to_onnx or argv[1].endswith(".onnx"):
        export_params_onnx(params, argv[1], channels)
    else:
        lenet.save_params_npz(argv[1], params)
    print(f"wrote {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
