"""Build and load the port's CUDA kernels.

Each ``coin_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``coin_tpu_torch/_build/lib<name>.so``, a shared library
with a plain C interface that is loaded with ``ctypes``. Nothing is built
when the package is imported: a library is built the first time its
kernel is launched (or by :func:`build_all`, which starts one ``nvcc`` per
source at once), and rebuilt when its source is newer than the library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("roi_align", "roi_align_bwd", "roi_align_int8",
           "roi_align_int8_bwd", "nms", "normalize", "augment", "quantize",
           "qconv", "qconv_wgrad", "window_attention", "ms_deform",
           "fusion_nms", "deform_conv", "dedup", "preprocess")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the port's CUDA kernels cannot be built")
    return found


def _paths(name: str):
    return (os.path.join(CSRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def _start(name: str, extra_flags: List[str]):
    src, lib = _paths(name)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def build_all(names: Iterable[str] = SOURCES,
              extra_flags: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every stale library, one ``nvcc`` per source, all started
    together. Returns the compiler output of each build (``-Xptxas -v``
    in ``extra_flags`` makes it list registers and spills)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = list(extra_flags)
    started = {n: _start(n, extra) for n in names
               if extra or _stale(n)}
    logs, failed = {}, []
    for name, (proc, tmp, lib) in started.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
