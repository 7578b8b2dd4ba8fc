"""gpd_tpu_torch's weight I/O (net/lenet.load_params and its loaders,
net/onnx_io, apps/convert_weights, GraspDetector's weights_file) against
gpd_tpu's on the CPU.

Every file is written into tmp_path: by gpd_tpu where it has a writer (npz,
ONNX, both LeNet variants), by the test otherwise (a raw .bin directory, a
torch state dict, an OpenVINO .xml + .bin, which gpd_tpu's own test reads
from an absent reference checkout). Loaded parameters must equal gpd_tpu's
exactly, the port's ONNX bytes must equal gpd_tpu's, and a detector built
from each format must hold gpd_tpu's parameters; each fallback (empty,
missing, unknown or unreadable weights_file) must print gpd_tpu's reason
and load what gpd_tpu loads.
"""

import os

import jax
import numpy as np
import pytest
import torch

import gpd_tpu.detector as jdet
from gpd_tpu.apps import convert_weights as jconvert
from gpd_tpu.config import DetectorConfig as JConfig
from gpd_tpu.config import ImageGeometry as JImageGeometry
from gpd_tpu.net import lenet as jlenet
from gpd_tpu.net import onnx_io as jonnx
from gpd_tpu_torch import detector as tdet
from gpd_tpu_torch.apps import convert_weights
from gpd_tpu_torch.config import DetectorConfig, ImageGeometry
from gpd_tpu_torch.net import lenet, onnx_io
from test_torch_threads import set_cpu_share

set_cpu_share()

TORCH_NAMES = {v: k for k, v in lenet.TORCH_NAMES.items()}


def jparams(variant="net", channels=15, seed=1):
    key = jax.random.PRNGKey(seed)
    p = (jlenet.init_params_ccfff(key, channels) if variant == "ccfff"
         else jlenet.init_params(key, channels))
    return {k: np.asarray(v) for k, v in p.items()}


def assert_same(ours, theirs):
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def write_bin_dir(path, p):
    os.makedirs(path)
    for k, name in lenet.BIN_NAMES.items():
        p[k].astype("<f4").tofile(os.path.join(path, name))


def write_openvino(xml_path, p, precision):
    """An OpenVINO IR of the LeNet: the XML's Convolution and
    FullyConnected layers point at blobs of one .bin beside it."""
    blob, layers = bytearray(), []
    dt = "<f2" if precision == "FP16" else "<f4"
    dims = {"conv1": ([1, p["conv1_w"].shape[1], 60, 60], [1, 20, 56, 56]),
            "conv2": ([1, 20, 28, 28], [1, 50, 24, 24]),
            "fc1": ([1, 7200], [1, 500]), "fc2": ([1, 500], [1, 2])}
    for i, (name, (ind, outd)) in enumerate(dims.items()):
        offs = []
        for suffix in ("_w", "_b"):
            raw = p[name + suffix].astype(dt).tobytes()
            offs.append((len(blob), len(raw)))
            blob += raw
        port = lambda d: "".join(f"<dim>{x}</dim>" for x in d)
        kind = "Convolution" if name.startswith("conv") else "FullyConnected"
        layers.append(
            f'<layer id="{i + 1}" name="{name}" type="{kind}" '
            f'precision="{precision}"><input><port id="0">{port(ind)}'
            f'</port></input><output><port id="1">{port(outd)}</port>'
            f'</output><blobs><weights offset="{offs[0][0]}" '
            f'size="{offs[0][1]}"/><biases offset="{offs[1][0]}" '
            f'size="{offs[1][1]}"/></blobs></layer>')
    with open(xml_path, "w") as f:
        f.write('<?xml version="1.0"?><net name="lenet" version="5"><layers>'
                '<layer id="0" name="data" type="Input"><output><port id="0">'
                '<dim>1</dim></port></output></layer>' + "".join(layers) +
                "</layers></net>")
    with open(xml_path[:-4] + ".bin", "wb") as f:
        f.write(bytes(blob))


def weights_files(tmp_path):
    """{label: (path, channels, parameters written)} in every format."""
    out = {}
    p = jparams()
    path = str(tmp_path / "net.npz")
    jlenet.save_params_npz(path, p)
    out["npz"] = (path, 15, p)
    p = jparams("ccfff", seed=2)
    path = str(tmp_path / "ccfff.npz")
    jlenet.save_params_npz(path, p)
    out["npz NetCCFFF"] = (path, 15, p)
    p = jparams(channels=3, seed=3)
    path = str(tmp_path / "params3")
    write_bin_dir(path, p)
    out["bin directory"] = (path, 3, p)
    p = jparams(seed=4)
    path = str(tmp_path / "net.pt")
    torch.save({"module." + TORCH_NAMES[k]: torch.tensor(v)
                for k, v in p.items()}, path)
    out["torch state dict"] = (path, 15, p)
    for variant, seed in (("net", 5), ("ccfff", 6)):
        p = jparams(variant, seed=seed)
        path = str(tmp_path / f"{variant}.onnx")
        jonnx.export_params_onnx(p, path, 15)
        out[f"onnx {variant}"] = (path, 15, p)
    for precision, seed in (("FP32", 7), ("FP16", 8)):
        p = jparams(seed=seed)
        path = str(tmp_path / f"ir_{precision}.xml")
        write_openvino(path, p, precision)
        out[f"openvino {precision}"] = (path, 15, p)
    return out


FORMATS = ["npz", "npz NetCCFFF", "bin directory", "torch state dict",
           "onnx net", "onnx ccfff", "openvino FP32", "openvino FP16"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_params_equals_gpd_tpu(tmp_path, fmt):
    path, channels, written = weights_files(tmp_path)[fmt]
    ours = lenet.load_params(path, channels)
    assert_same(ours, jlenet.load_params(path, channels))
    if not fmt.startswith("openvino FP16"):
        assert_same(ours, written)


@pytest.mark.parametrize("variant", ["net", "ccfff"])
def test_onnx_export_byte_identical(tmp_path, variant):
    """The port's ONNX file is gpd_tpu's, byte for byte, and gpd_tpu's
    reader gives back the parameters."""
    p = jparams(variant, seed=9)
    ours, theirs = str(tmp_path / "ours.onnx"), str(tmp_path / "theirs.onnx")
    onnx_io.export_params_onnx(p, ours, 15)
    jonnx.export_params_onnx(p, theirs, 15)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert_same(jonnx.load_params_onnx(ours), p)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dst", ["out.npz", "out.onnx"])
def test_convert_weights_matches_gpd_tpu(tmp_path, fmt, dst, capsys):
    """Both CLIs on the same source: ONNX outputs byte-identical, npz
    outputs holding the same arrays."""
    src, channels, _ = weights_files(tmp_path)[fmt]
    ours, theirs = str(tmp_path / ("ours_" + dst)), str(tmp_path /
                                                        ("theirs_" + dst))
    assert convert_weights.main([src, ours, str(channels)]) == 0
    assert jconvert.main([src, theirs, str(channels)]) == 0
    assert capsys.readouterr().out.count("wrote ") == 2
    if dst.endswith(".onnx"):
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    else:
        assert_same(lenet.load_params_npz(ours),
                    jlenet.load_params_npz(theirs))
    assert convert_weights.main([src]) == -1


@pytest.mark.parametrize("fmt", FORMATS)
def test_detector_holds_gpd_tpu_params(tmp_path, fmt, capsys):
    """A CPU detector with weights_file in each format holds gpd_tpu's
    detector's parameters, with no fallback."""
    path, channels, _ = weights_files(tmp_path)[fmt]
    ig = dict(num_channels=channels)
    td = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(**ig), weights_file=path), device="cpu")
    jd = jdet.GraspDetector(JConfig(
        image_geometry=JImageGeometry(**ig), weights_file=path))
    assert "NOTE" not in capsys.readouterr().out
    assert_same(lenet.params_to_numpy(td.net), jd.params)


def fallback_cases(tmp_path):
    """{label: (weights_file, channels)} that gpd_tpu cannot load."""
    (tmp_path / "weights.txt").write_text("not weights")
    short = str(tmp_path / "short_bin")
    write_bin_dir(short, jparams())
    os.remove(os.path.join(short, "ip1_weights.bin"))
    wrong = str(tmp_path / "wrong_bin")
    write_bin_dir(wrong, jparams(channels=3))
    (tmp_path / "broken.onnx").write_bytes(b"\x3a\x00")
    return {"empty": ("", 15),
            "missing npz": (str(tmp_path / "absent.npz"), 15),
            "unknown suffix": (str(tmp_path / "weights.txt"), 3),
            "bin without ip1": (short, 15),
            "bin of the wrong size": (wrong, 15),
            "onnx without initializers": (str(tmp_path / "broken.onnx"), 15),
            "missing, no packaged checkpoint": (str(tmp_path / "a.npz"), 1)}


@pytest.mark.parametrize("case", ["empty", "missing npz", "unknown suffix",
                                  "bin without ip1", "bin of the wrong size",
                                  "onnx without initializers",
                                  "missing, no packaged checkpoint"])
def test_fallbacks_match_gpd_tpu(tmp_path, case, capsys):
    """Each weights_file gpd_tpu cannot load: the same reason printed, with
    the packaged checkpoint (NOTE) or random init (WARNING), and the packaged
    checkpoint's parameters where it exists."""
    path, channels = fallback_cases(tmp_path)[case]
    ig = dict(num_channels=channels)
    jd = jdet.GraspDetector(JConfig(
        image_geometry=JImageGeometry(**ig), weights_file=path))
    theirs = capsys.readouterr().out.strip()
    td = tdet.GraspDetector(DetectorConfig(
        image_geometry=ImageGeometry(**ig), weights_file=path), device="cpu")
    ours = capsys.readouterr().out.strip()
    if channels == 1:
        assert theirs.startswith("WARNING: could not load classifier weights")
        assert ours == theirs
        assert td.net.conv1.in_channels == 1
        return
    reason = theirs.split("; using packaged checkpoint")[0]
    assert reason.startswith("NOTE: ") and ours.startswith(reason + "; using "
                                                           "packaged checkpoint")
    assert_same(lenet.params_to_numpy(td.net), jd.params)
