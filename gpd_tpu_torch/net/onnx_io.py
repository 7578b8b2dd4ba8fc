"""Self-contained ONNX and OpenVINO-IR weight interchange, no onnx package
(port of gpd_tpu/net/onnx_io.py, NumPy only, kept byte for byte in what it
writes).

The reference deploys its classifier through ONNX -> OpenVINO IR
(reference: pytorch/torch_to_onnx.py; src/gpd/net/openvino_classifier.cpp:
39-97 reads models/openvino/*.xml + .bin). This module implements the
minimum of both formats directly:

  - ONNX: hand-rolled protobuf wire-format encode/decode for the fixed
    LeNet topology (ModelProto/GraphProto/NodeProto/TensorProto). The
    exported file is a complete opset-13 graph (Conv/Relu/MaxPool/
    Reshape/Gemm), the same bytes gpd_tpu writes (producer "gpd_tpu"); the
    importer reads any ONNX file whose initializers follow the torch LeNet
    naming (conv1.weight, ... as torch_to_onnx.py produces them).
  - OpenVINO IR: the XML graph (xml.etree) + raw little-endian f32/f16 .bin
    blobs addressed by per-layer <blobs> offset/size, the layout
    openvino_classifier.cpp consumes.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Minimal protobuf wire-format helpers.
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode())


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    Length-delimited values come back as bytes; varints as ints; 32/64-bit
    as raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# ---------------------------------------------------------------------------
# ONNX export (fixed LeNet topology, opset 13).
# ---------------------------------------------------------------------------

_ONNX_FLOAT = 1
_ONNX_INT64 = 7


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype == np.int64:
        dtype = _ONNX_INT64
        raw = arr.astype("<i8").tobytes()
    else:
        dtype = _ONNX_FLOAT
        raw = arr.astype("<f4").tobytes()
    out = b""
    for d in arr.shape:
        out += _int_field(1, d)                    # dims
    out += _int_field(2, dtype)                    # data_type
    out += _str_field(8, name)                     # name
    out += _len_field(9, raw)                      # raw_data
    return out


def _attr_ints(name: str, ints: List[int]) -> bytes:
    out = _str_field(1, name)
    for v in ints:
        out += _int_field(8, v)                    # ints
    out += _int_field(20, 7)                       # type = INTS
    return out


def _attr_int(name: str, v: int) -> bytes:
    return _str_field(1, name) + _int_field(3, v) + _int_field(20, 2)


def _node(op: str, inputs: List[str], outputs: List[str],
          attrs: List[bytes] = ()) -> bytes:
    out = b""
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    out += _str_field(4, op)
    for a in attrs:
        out += _len_field(5, a)
    return out


def _value_info(name: str, dims: List[Optional[int]]) -> bytes:
    shape = b""
    for d in dims:
        if d is None:
            shape += _len_field(1, _str_field(2, "batch"))
        else:
            shape += _len_field(1, _int_field(1, d))
    tensor_type = _int_field(1, _ONNX_FLOAT) + _len_field(2, shape)
    type_proto = _len_field(1, tensor_type)
    return _str_field(1, name) + _len_field(2, type_proto)


def export_params_onnx(params: Dict, path: str, num_channels: int,
                       image_size: int = 60) -> None:
    """Write the LeNet as a complete ONNX (opset 13) model.

    Graph: Conv-Relu-MaxPool x2 -> Reshape -> Gemm-Relu -> Gemm [-> Relu ->
    Gemm for the NetCCFFF variant]; initializer names follow the torch
    state_dict convention so torch_to_onnx.py consumers interchange."""
    P = {k: np.asarray(v, np.float32) for k, v in params.items()}
    flat = P["fc1_w"].shape[1]

    inits = [
        _tensor_proto("conv1.weight", P["conv1_w"]),
        _tensor_proto("conv1.bias", P["conv1_b"]),
        _tensor_proto("conv2.weight", P["conv2_w"]),
        _tensor_proto("conv2.bias", P["conv2_b"]),
        _tensor_proto("fc1.weight", P["fc1_w"]),
        _tensor_proto("fc1.bias", P["fc1_b"]),
        _tensor_proto("fc2.weight", P["fc2_w"]),
        _tensor_proto("fc2.bias", P["fc2_b"]),
        _tensor_proto("reshape_dims", np.array([0, flat], np.int64)),
    ]
    pool_attrs = [_attr_ints("kernel_shape", [2, 2]),
                  _attr_ints("strides", [2, 2])]
    nodes = [
        _node("Conv", ["input", "conv1.weight", "conv1.bias"], ["c1"],
              [_attr_ints("kernel_shape", [5, 5])]),
        _node("Relu", ["c1"], ["r1"]),
        _node("MaxPool", ["r1"], ["p1"], pool_attrs),
        _node("Conv", ["p1", "conv2.weight", "conv2.bias"], ["c2"],
              [_attr_ints("kernel_shape", [5, 5])]),
        _node("Relu", ["c2"], ["r2"]),
        _node("MaxPool", ["r2"], ["p2"], pool_attrs),
        _node("Reshape", ["p2", "reshape_dims"], ["flat"]),
        _node("Gemm", ["flat", "fc1.weight", "fc1.bias"], ["g1"],
              [_attr_int("transB", 1)]),
        _node("Relu", ["g1"], ["r3"]),
    ]
    if "fc3_w" in P:                                   # NetCCFFF
        inits += [_tensor_proto("fc3.weight", P["fc3_w"]),
                  _tensor_proto("fc3.bias", P["fc3_b"])]
        nodes += [
            _node("Gemm", ["r3", "fc2.weight", "fc2.bias"], ["g2"],
                  [_attr_int("transB", 1)]),
            _node("Relu", ["g2"], ["r4"]),
            _node("Gemm", ["r4", "fc3.weight", "fc3.bias"], ["logits"],
                  [_attr_int("transB", 1)]),
        ]
    else:
        nodes += [_node("Gemm", ["r3", "fc2.weight", "fc2.bias"], ["logits"],
                        [_attr_int("transB", 1)])]

    graph = b""
    for nd in nodes:
        graph += _len_field(1, nd)
    graph += _str_field(2, "gpd_lenet")
    for it in inits:
        graph += _len_field(5, it)
    graph += _len_field(
        11, _value_info("input", [None, num_channels, image_size,
                                  image_size]))
    graph += _len_field(12, _value_info("logits", [None, 2]))

    model = _int_field(1, 8)                          # ir_version 8
    model += _str_field(2, "gpd_tpu")                 # producer
    model += _len_field(7, graph)
    model += _len_field(8, _int_field(2, 13))         # opset 13, default ""
    with open(path, "wb") as f:
        f.write(model)


# ---------------------------------------------------------------------------
# ONNX import.
# ---------------------------------------------------------------------------

_NAME_MAP = {
    "conv1.weight": "conv1_w", "conv1.bias": "conv1_b",
    "conv2.weight": "conv2_w", "conv2.bias": "conv2_b",
    "fc1.weight": "fc1_w", "fc1.bias": "fc1_b",
    "fc2.weight": "fc2_w", "fc2.bias": "fc2_b",
    "fc3.weight": "fc3_w", "fc3.bias": "fc3_b",
}


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = _ONNX_FLOAT
    name = ""
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
        elif field == 4 and wire == 2:      # packed float_data
            floats = list(np.frombuffer(val, "<f4"))
        elif field == 4 and wire == 5:
            floats.append(struct.unpack("<f", val)[0])
        elif field == 7 and wire == 2:      # packed int64_data
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                ints.append(v)
    if raw:
        np_dtype = "<i8" if dtype == _ONNX_INT64 else "<f4"
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    else:
        arr = np.asarray(ints, np.int64)
    return name, arr.reshape(dims or (-1,))


def load_params_onnx(path: str) -> Dict[str, np.ndarray]:
    """Read LeNet parameters from an ONNX file's initializers (torch or
    gpd_tpu naming)."""
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _iter_fields(model):
        if field == 7 and wire == 2:
            graph = val
    if graph is None:
        raise ValueError(f"{path}: no graph in ONNX model")
    params: Dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == 2:                  # initializer
            name, arr = _parse_tensor(val)
            key = _NAME_MAP.get(name)
            if key is not None:
                params[key] = np.ascontiguousarray(arr, np.float32)
    missing = {"conv1_w", "conv1_b", "conv2_w", "conv2_b",
               "fc1_w", "fc1_b", "fc2_w", "fc2_b"} - set(params)
    if missing:
        raise ValueError(f"{path}: missing initializers for {sorted(missing)}")
    return params


# ---------------------------------------------------------------------------
# OpenVINO IR import (openvino_classifier.cpp's .xml + .bin layout).
# ---------------------------------------------------------------------------


def load_params_openvino(xml_path: str,
                         bin_path: Optional[str] = None
                         ) -> Dict[str, np.ndarray]:
    """Read LeNet weights from an OpenVINO IR: the XML lists Convolution /
    FullyConnected layers whose <blobs> give byte offsets/sizes into the
    raw .bin (models/openvino/*.xml; reference openvino_classifier.cpp
    loads the same pair through the Inference Engine)."""
    if bin_path is None:
        bin_path = xml_path[:-4] + ".bin" if xml_path.endswith(".xml") \
            else xml_path + ".bin"
    tree = ET.parse(xml_path)
    root = tree.getroot()
    with open(bin_path, "rb") as f:
        blob = f.read()

    def read(off: int, size: int, precision: str) -> np.ndarray:
        raw = blob[off:off + size]
        if len(raw) != size:
            raise ValueError(f"{bin_path}: blob [{off}:{off+size}] out of "
                             f"range ({len(blob)} bytes)")
        a = np.frombuffer(raw, "<f2" if precision == "FP16" else "<f4")
        return a.astype(np.float32)

    convs = []
    fcs = []
    for layer in root.iter("layer"):
        ltype = layer.get("type")
        if ltype not in ("Convolution", "FullyConnected"):
            continue
        precision = layer.get("precision", "FP32")
        blobs = layer.find("blobs")
        if blobs is None:
            continue
        w = blobs.find("weights")
        b = blobs.find("biases")
        out_dims = [int(d.text) for d in
                    layer.find("output").find("port").findall("dim")]
        in_dims = [int(d.text) for d in
                   layer.find("input").find("port").findall("dim")]
        wt = read(int(w.get("offset")), int(w.get("size")), precision)
        bs = read(int(b.get("offset")), int(b.get("size")), precision) \
            if b is not None else None
        entry = (layer.get("name"), ltype, in_dims, out_dims, wt, bs)
        (convs if ltype == "Convolution" else fcs).append(entry)

    if len(convs) != 2 or len(fcs) != 2:
        raise ValueError(
            f"{xml_path}: expected 2 Convolution + 2 FullyConnected LeNet "
            f"layers, got {len(convs)} + {len(fcs)}")

    params: Dict[str, np.ndarray] = {}
    for i, (name, _, ind, outd, wt, bs) in enumerate(convs, start=1):
        cout, cin = outd[1], ind[1]
        k = int(np.sqrt(wt.size // (cout * cin)))
        params[f"conv{i}_w"] = wt.reshape(cout, cin, k, k)
        params[f"conv{i}_b"] = (bs if bs is not None
                                else np.zeros(cout, np.float32))
    for i, (name, _, ind, outd, wt, bs) in enumerate(fcs, start=1):
        nout = outd[-1]
        nin = wt.size // nout
        params[f"fc{i}_w"] = wt.reshape(nout, nin)
        params[f"fc{i}_b"] = (bs if bs is not None
                              else np.zeros(nout, np.float32))
    return params
