"""Point-cloud file I/O, PCD and PLY (port of gpd_tpu/io/pcd.py).

Host-side loaders in place of the reference's PCL file reading
(src/gpd/util/cloud.cpp:643-660 loadPointCloudFromFile): PCD ascii, binary
and binary_compressed (LZF), ascii and binary_little_endian PLY, per-point
normals from CSV, and an ascii PCD writer.

Ascii PCD bodies parse natively, as gpd_tpu's do with its C++ fast path:
the port's own copy of that parser (``csrc/pcd_ascii.cpp``) is built at
first use with the host C++ compiler (``ops/_build.py``) and called through
ctypes. Where no compiler exists, and for a body with fewer numbers than the
header promises (which then fails as malformed), NumPy parses instead.
``ascii_route()`` says which route ascii bodies take.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import struct

import numpy as np

from gpd_tpu_torch import profiling
from gpd_tpu_torch.ops import _build

_PCD_TYPE = {("F", 4): "f4", ("F", 8): "f8",
             ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
             ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def _lzf_decompress(data: bytes, expected: int) -> bytes:
    """LZF decompression (PCL binary_compressed PCD bodies)."""
    out = bytearray(expected)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out[o:o + run] = data[i:i + run]
            i += run
            o += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out[o] = out[ref]
                o += 1
                ref += 1
    return bytes(out)


@functools.lru_cache(maxsize=None)
def _native_parser():
    """``parse_ascii_floats`` from csrc/pcd_ascii.cpp, built on first use;
    None where there is no host C++ compiler."""
    if _build.host_compiler() is None:
        return None
    fn = _build.load("pcd_ascii").parse_ascii_floats
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
    return fn


def ascii_route() -> str:
    """"native" when ascii bodies parse with csrc/pcd_ascii.cpp, else
    "numpy"."""
    return "numpy" if _native_parser() is None else "native"


def _parse_ascii_block(text_bytes: bytes, n_values: int) -> np.ndarray:
    """The first ``n_values`` floats of an ascii body, natively; NumPy
    parses the whole body where the native parser is missing or finds fewer
    (gpd_tpu/io/pcd.py:76-85)."""
    fn = _native_parser()
    if fn is not None:
        out = np.empty(n_values, dtype=np.float32)
        got = fn(text_bytes, len(text_bytes),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_values)
        if got == n_values:
            return out
    return np.array(text_bytes.split(), dtype=np.float32)


def load_pcd(path: str) -> np.ndarray:
    """Load a PCD file; returns (N, 3) float32 xyz. NaN rows preserved."""
    with open(path, "rb") as f:
        raw = f.read()

    header_lines = []
    pos = 0
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode("ascii", "replace").strip()
        pos = nl + 1
        if line and not line.startswith("#"):
            header_lines.append(line)
        if line.upper().startswith("DATA"):
            break

    hdr = {}
    for line in header_lines:
        parts = line.split()
        hdr[parts[0].upper()] = parts[1:]

    fields = hdr["FIELDS"]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
    npts = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0].lower()

    dtype_fields = []
    for name, size, typ, count in zip(fields, sizes, types, counts):
        base = _PCD_TYPE[(typ, size)]
        if count == 1:
            dtype_fields.append((name, base))
        else:
            dtype_fields.append((name, base, (count,)))
    rec_dtype = np.dtype(dtype_fields)

    if mode == "ascii":
        ncols = sum(counts)
        vals = _parse_ascii_block(raw[pos:], npts * ncols)
        vals = vals[: npts * ncols].reshape(npts, ncols)
        out = np.empty((npts, 3), dtype=np.float32)
        col = 0
        colmap = {}
        for name, count in zip(fields, counts):
            colmap[name] = col
            col += count
        for i, ax in enumerate(("x", "y", "z")):
            out[:, i] = vals[:, colmap[ax]]
        return out

    if mode == "binary":
        body = raw[pos: pos + rec_dtype.itemsize * npts]
        rec = np.frombuffer(body, dtype=rec_dtype, count=npts)
        return np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)

    if mode == "binary_compressed":
        comp_size, uncomp_size = struct.unpack_from("<II", raw, pos)
        body = _lzf_decompress(raw[pos + 8: pos + 8 + comp_size], uncomp_size)
        # binary_compressed stores data field-by-field (SoA).
        out = np.empty((npts, 3), dtype=np.float32)
        off = 0
        for name, size, typ, count in zip(fields, sizes, types, counts):
            nbytes = size * count * npts
            if name in ("x", "y", "z"):
                arr = np.frombuffer(body, dtype=_PCD_TYPE[(typ, size)],
                                    count=npts * count, offset=off)
                out[:, "xyz".index(name)] = arr.reshape(npts, count)[:, 0]
            off += nbytes
        return out

    raise ValueError(f"Unsupported PCD DATA mode: {mode}")


def load_ply(path: str) -> np.ndarray:
    """Minimal ascii/binary_little_endian PLY loader; returns (N,3) float32."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii", "replace")
    mode = "ascii" if "format ascii" in header else "binary_little_endian"
    m = re.search(r"element vertex (\d+)", header)
    if not m:
        raise ValueError("PLY missing vertex element")
    npts = int(m.group(1))
    props = re.findall(r"property (\w+) (\w+)", header)
    type_map = {"float": "f4", "float32": "f4", "double": "f8",
                "uchar": "u1", "uint8": "u1", "int": "i4", "int32": "i4",
                "short": "i2", "ushort": "u2"}
    if mode == "ascii":
        body = raw[end:]
        vals = np.array(body.split(), dtype=np.float64)
        ncols = len(props)
        vals = vals[: npts * ncols].reshape(npts, ncols)
        names = [p[1] for p in props]
        idx = [names.index(ax) for ax in ("x", "y", "z")]
        return vals[:, idx].astype(np.float32)
    rec = np.frombuffer(raw, dtype=np.dtype(
        [(p[1], type_map[p[0]]) for p in props]), count=npts, offset=end)
    return np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)


def load_cloud_file(path: str) -> np.ndarray:
    """Dispatch by extension (reference: cloud.cpp:643-660), the parse in
    the span ``read_file``."""
    ext = os.path.splitext(path)[1].lower()
    with profiling.span("read_file"):
        if ext == ".pcd":
            return load_pcd(path)
        if ext == ".ply":
            return load_ply(path)
    raise ValueError(f"Unsupported point-cloud file type: {path}")


def load_normals_csv(path: str) -> np.ndarray:
    """Load per-point normals from CSV (reference: cloud.cpp:622 setNormalsFromFile)."""
    return np.loadtxt(path, delimiter=",", dtype=np.float64).astype(np.float32)


def save_pcd(path: str, points: np.ndarray) -> None:
    """Write an ascii PCD (xyz) for interchange with the reference tools."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("# .PCD v.7 - Point Cloud Data file format\nVERSION .7\n"
                "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {n}\nDATA ascii\n")
        np.savetxt(f, points, fmt="%.6f")
