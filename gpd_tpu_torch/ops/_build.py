"""Builds the port's native code from ``gpd_tpu_torch/csrc`` at first use.

Each CUDA kernel ``csrc/<name>.cu`` compiles with nvcc for Hopper
(``sm_90a``), and each host library ``csrc/<name>.cpp`` with the host C++
compiler, into a shared library with a plain C interface, loaded with
``ctypes``; the C ABI (``gpd_c_api``) also compiles against this Python's
headers, and links its libpython where this interpreter runs from it.
Libraries go to ``gpd_tpu_torch/_build/`` (ignored by git) under a name
that carries a hash of the source, the ``csrc/*.cuh`` headers (for
kernels) or its own ``.h`` (for a host library), and the flags, so an
edited source rebuilds and an unchanged one is reused. ``launch`` calls a
kernel library's launch function and counts the launch by the name of the
wrapper that made it (``LAUNCHES``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
# Host libraries that embed this Python.
EMBEDS_PYTHON = ("gpd_c_api",)
# Dynamic shared memory one block may use on Hopper (232,448 bytes).
MAX_DYNAMIC_SMEM = 232448

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Kernel launches by the name of the wrapper that made them (``launch``).
LAUNCHES: collections.Counter = collections.Counter()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def host_compiler() -> Optional[str]:
    """The host C++ compiler (``c++``, else ``g++``), or None where there is
    none."""
    return shutil.which("c++") or shutil.which("g++")


def _is_host(name: str) -> bool:
    return os.path.exists(os.path.join(CSRC, name + ".cpp"))


def python_include() -> Optional[str]:
    """This Python's include directory if it holds ``Python.h``, else
    None."""
    inc = sysconfig.get_paths()["include"]
    return inc if os.path.exists(os.path.join(inc, "Python.h")) else None


def _runs_on_shared_libpython() -> bool:
    """Whether this interpreter runs from a shared libpython. An executable
    with the interpreter linked in (as Debian's python3) exports its
    symbols; a library loaded into it must not link libpython, which would
    bring a second, uninitialized interpreter into the process."""
    with open("/proc/self/maps") as f:
        return "/libpython" in f.read()


def _host_flags(name: str) -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of a host library. One that embeds this
    Python also takes its headers, and links its libpython when this
    interpreter runs from it (a C program that embeds a library built by
    an interpreter with the symbols linked in links libpython itself)."""
    if name not in EMBEDS_PYTHON:
        return HOST_FLAGS, []
    inc = python_include()
    if inc is None:
        raise RuntimeError(f"Python.h not found in "
                           f"{sysconfig.get_paths()['include']}: the C ABI "
                           f"needs this Python's development headers")
    link = []
    if _runs_on_shared_libpython():
        libdir = sysconfig.get_config_var("LIBDIR")
        link = [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                f"-lpython{sysconfig.get_config_var('LDVERSION')}"]
    return HOST_FLAGS + [f"-I{inc}"], link


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers in
    csrc/ (a kernel: every .cuh; a host library: its own .h), and the
    flags."""
    if _is_host(name):
        flags = sum(_host_flags(name), [])
        files = [f for f in (name + ".cpp", name + ".h")
                 if os.path.exists(os.path.join(CSRC, f))]
    else:
        flags = NVCC_FLAGS
        files = [name + ".cu", *sorted(f for f in os.listdir(CSRC)
                                       if f.endswith(".cuh"))]
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        with open(os.path.join(CSRC, f), "rb") as src:
            digest.update(src.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _command(name: str, out: str):
    if _is_host(name):
        cxx = host_compiler()
        if cxx is None:
            raise RuntimeError("no host C++ compiler (c++ or g++) found")
        flags, link = _host_flags(name)
        return [cxx, *flags, "-o", out, os.path.join(CSRC, name + ".cpp"),
                *link]
    return [nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, name + ".cu")]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named library that is not built yet, one compiler
    process each, all started together. Returns the compiler's output per
    name (for kernels, register and shared-memory use from ``-Xptxas -v``);
    raises if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(library_path(name))
        return lib


def cuda_error_string(lib: ctypes.CDLL, err: int) -> str:
    fn = lib.gpd_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return f"CUDA error {err}: {fn(err).decode()}"


def launch(name: str, library: str, symbol: str, argtypes: Sequence,
           device: torch.device, *args) -> None:
    """Calls ``symbol`` of the kernel library ``library`` (built at first
    use) with ``args`` (of the ctypes ``argtypes``) and, last, the current
    stream of ``device``, under that device's guard, and counts one launch
    of the wrapper ``name`` in ``LAUNCHES``. The function returns a CUDA
    error code; one that is not zero raises."""
    lib = load(library)
    fn = getattr(lib, symbol)           # the library keeps one per symbol
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{cuda_error_string(lib, err)}")
    LAUNCHES[name] += 1
