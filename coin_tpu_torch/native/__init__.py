"""The native JPEG decoder of the port's loaders (ctypes).

``decoder.cpp`` (the arithmetic of the JAX package's native decoder, so
both give the same bytes) is built with ``g++ ... -ljpeg -pthread`` the
first time it is needed, into the git-ignored
``coin_tpu_torch/_build/libcoin_native.so``: to a temporary name, then
renamed, so processes that build at once never load a half-written file.
It is rebuilt when the source is newer, and loaded with ``ctypes.CDLL``,
whose symbols stay local (the JAX package's library exports the same
names, and the tests load both into one process). It exposes:

- ``decode_batch(blobs, scales, canvas_hw)``: threaded JPEG decode and
  bilinear resize straight into a packed uint8 canvas batch;
- ``jpeg_size(blob)``: a JPEG's (height, width) from its header.

``available()`` is False where g++, libjpeg or its header is missing or
the build fails: the loaders then decode with PIL, as the JAX package's
do. ``toolchain()`` and ``build_error()`` say which.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from coin_tpu_torch.kernels.build import BUILD_DIR

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "decoder.cpp")
_LIB = os.path.join(BUILD_DIR, "libcoin_native.so")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


def toolchain() -> Tuple[Optional[str], bool]:
    """(g++'s path or None, whether g++ finds ``<jpeglib.h>``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None, False
    try:
        res = subprocess.run(
            [gxx, "-fsyntax-only", "-x", "c++", "-"],
            input="#include <cstdio>\n#include <jpeglib.h>\n",
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return gxx, False
    return gxx, res.returncode == 0


def _build() -> Optional[str]:
    """Compile the library; the error's text, or None when it built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp, "-ljpeg", "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        err = f"g++ exited with {e.returncode}: {e.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        err = f"g++ did not run: {e}"
    else:
        os.replace(tmp, _LIB)
        return None
    if os.path.exists(tmp):
        os.remove(tmp)
    return err


def _load():
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (os.path.getmtime(_LIB)
                                        < os.path.getmtime(_SRC)):
            _error = _build()
            if _error is not None:
                logger.info("native decoder build failed (%s); using PIL",
                            _error)
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            _error = f"load failed: {e}"
            logger.info("native decoder %s; using PIL", _error)
            return None
        lib.coin_decode_batch.restype = ctypes.c_int
        lib.coin_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.coin_jpeg_size.restype = ctypes.c_int
        lib.coin_jpeg_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is, or before the
    first call of ``available``)."""
    return _error


def jpeg_size(blob: bytes) -> Optional[Tuple[int, int]]:
    lib = _load()
    if lib is None:
        return None
    hw = (ctypes.c_int32 * 2)()
    if lib.coin_jpeg_size(blob, len(blob), hw) != 0:
        return None
    return int(hw[0]), int(hw[1])


def decode_batch(blobs: Sequence[bytes], scales: Sequence[float],
                 canvas_hw: Tuple[int, int], num_threads: int = 8):
    """(canvases (N, H, W, 3) uint8, out_hw (N, 4) int32 [nh, nw, orig_h,
    orig_w]), each image resized by its scale into the top left of its
    zeroed canvas; None when the library is unavailable or any image
    failed."""
    n = len(blobs)
    if len(scales) != n:
        raise ValueError(f"decode_batch: {n} blobs, {len(scales)} scales")
    lib = _load()
    if lib is None:
        return None
    ch, cw = canvas_hw
    canvases = np.zeros((n, ch, cw, 3), np.uint8)
    out_hw = np.zeros((n, 4), np.int32)
    datas = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    sc = (ctypes.c_float * n)(*[float(s) for s in scales])
    fails = lib.coin_decode_batch(
        datas, lens, sc, n,
        canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ch, cw,
        out_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    if fails:
        logger.warning("native decode: %d/%d images failed", fails, n)
        return None
    return canvases, out_hw
