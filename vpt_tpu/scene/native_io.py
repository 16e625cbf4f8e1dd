"""ctypes bindings for libvptio (native/vptio.cpp) with graceful fallback.

The native library accelerates large-volume ingest (mmap + threads) and
corner-table packing; every entry point has a pure-Python/NumPy equivalent
in scene/io.py and ops/interp.py, so the framework works without the
compiled library (``available()`` reports which path is active).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native")
# built from the sources by `make -C native` (or build()); not tracked
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libvptio.so")


def build() -> bool:
    """Compile libvptio from native/vptio.cpp with ``make -C native``.
    Returns whether the library is available afterwards (False when make
    or the sources are missing, or the compile fails)."""
    if shutil.which("make") is None or not os.path.exists(
            os.path.join(_NATIVE_DIR, "Makefile")):
        return False
    subprocess.run(["make", "-s", "-C", _NATIVE_DIR], capture_output=True,
                   timeout=300)
    _lib.cache_clear()
    return available()


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.vptio_zip_open.restype = ctypes.c_void_p
    lib.vptio_zip_open.argtypes = [ctypes.c_char_p]
    lib.vptio_zip_close.argtypes = [ctypes.c_void_p]
    lib.vptio_zip_count.restype = ctypes.c_int64
    lib.vptio_zip_count.argtypes = [ctypes.c_void_p]
    lib.vptio_zip_name.restype = ctypes.c_char_p
    lib.vptio_zip_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.vptio_zip_read.restype = ctypes.c_int64
    lib.vptio_zip_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
    ]
    lib.vptio_load_raw_f32.restype = ctypes.c_int
    lib.vptio_load_raw_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.vptio_place_block_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.vptio_pack_corners_f32.restype = ctypes.c_int
    lib.vptio_pack_corners_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int,
    ]
    return lib


def available() -> bool:
    return _lib() is not None


class NativeZip:
    """Native mirror of scene/io.ZIPReader (stored entries only)."""

    def __init__(self, path: str):
        lib = _lib()
        if lib is None:
            raise RuntimeError("libvptio not built (run make -C native)")
        self._lib = lib
        self._handle = lib.vptio_zip_open(path.encode())
        if not self._handle:
            raise FileNotFoundError(f"not a readable stored ZIP: {path}")

    def close(self):
        if self._handle:
            self._lib.vptio_zip_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def get_files(self):
        n = self._lib.vptio_zip_count(self._handle)
        return [self._lib.vptio_zip_name(self._handle, i).decode() for i in range(n)]

    def read_file(self, name: str) -> bytes:
        size = self._lib.vptio_zip_read(self._handle, name.encode(), None)
        if size < 0:
            raise FileNotFoundError(f"ZIP entry missing or compressed: {name}")
        buf = np.empty(size, np.uint8)
        self._lib.vptio_zip_read(
            self._handle, name.encode(), buf.ctypes.data_as(ctypes.c_void_p)
        )
        return buf.tobytes()


def load_raw_f32(path: str, width: int, height: int, depth: int,
                 threads: int = 0) -> np.ndarray:
    """Threaded mmap load of a headerless uint8 volume -> (D, H, W) f32."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libvptio not built (run make -C native)")
    out = np.empty((depth, height, width), np.float32)
    rc = lib.vptio_load_raw_f32(
        path.encode(), width, height, depth,
        out.ctypes.data_as(ctypes.c_void_p), threads,
    )
    if rc != 0:
        raise IOError(f"vptio_load_raw_f32 failed with code {rc} for {path}")
    return out


def pack_corners_f32(volume: np.ndarray, threads: int = 0) -> np.ndarray:
    """Threaded corner-table packing (ops/interp.pack_volume_corners)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libvptio not built (run make -C native)")
    volume = np.ascontiguousarray(volume, np.float32)
    D, H, W = volume.shape
    out = np.empty((D + 1, H + 1, W + 1, 8), np.float32)
    rc = lib.vptio_pack_corners_f32(
        volume.ctypes.data_as(ctypes.c_void_p), D, H, W,
        out.ctypes.data_as(ctypes.c_void_p), threads,
    )
    if rc != 0:
        raise IOError("vptio_pack_corners_f32 failed")
    return out
