"""Build and bind the native image decoder ``csrc/dataio.cc`` (counterpart
of ``srgan_tpu/native/__init__.py``).

``load_batch(paths, crop, out_size, flips, num_threads)`` fills an NHWC
float32 array with decoded, centre-cropped, resized, flipped and per-image
min-maxed images on a C++ thread pool, the GIL released for the whole batch.

The source is compiled with ``g++`` at first use into
``build/srgan_tpu_torch/`` (``ops/build.py``'s directory), named by a hash of
the source and the compile command, and loaded with ``ctypes``.  It needs the
libpng and libjpeg headers and libraries.  Where the build fails,
``available()`` is False, ``build_error()`` holds the compiler's output, and
``load_image`` / ``load_batch`` raise with it: nothing here falls back to
another decoder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from srgan_tpu_torch.ops import build

SRC = build.CSRC / "dataio.cc"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lpthread")
BUILD_TIMEOUT_S = 180

_lock = threading.Lock()
# library path -> the loaded library, or the reason it could not be had
_LOADED: Dict[Path, ctypes.CDLL] = {}
_ERRORS: Dict[Path, str] = {}


def _target() -> Path:
    return build.hashed_library("dataio", SRC, (CXX, *CXX_FLAGS, *LIBS))


def _compile(so: Path):
    """Compile into a temporary name, then rename: a reader never sees half
    a file.  Raises with the compiler's output."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)


def _load() -> Path:
    so = _target()
    with _lock:
        if so in _LOADED or so in _ERRORS:
            return so
        try:
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
        except (RuntimeError, OSError) as e:
            _ERRORS[so] = str(e)
            return so
        lib.srgan_load_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.srgan_load_image.restype = ctypes.c_int
        lib.srgan_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.srgan_load_batch.restype = ctypes.c_int
        _LOADED[so] = lib
        return so


def _lib() -> ctypes.CDLL:
    so = _load()
    if so not in _LOADED:
        raise RuntimeError(f"the native decoder could not be built or "
                           f"loaded: {_ERRORS[so]}")
    return _LOADED[so]


def available() -> bool:
    """True when the decoder is built (building it if needed) and loaded."""
    return _load() in _LOADED


def build_error() -> Optional[str]:
    """The compiler's (or the loader's) output where the decoder could not
    be had, else None."""
    return _ERRORS.get(_load())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_image(path: str, crop: int, out_size: int,
               flip: bool = False) -> np.ndarray:
    """One image as (out_size, out_size, 3) float32 in [-1, 1]."""
    lib = _lib()
    out = np.empty((out_size, out_size, 3), np.float32)
    if lib.srgan_load_image(path.encode(), crop, out_size, int(flip),
                            _ptr(out, ctypes.c_float)) != 0:
        raise IOError(f"native decode failed: {path}")
    return out


def load_batch(paths: Sequence[str], crop: int, out_size: int,
               flips: Optional[np.ndarray] = None,
               num_threads: int = 0) -> np.ndarray:
    """The images of ``paths`` as (n, out_size, out_size, 3) float32, image
    i mirrored where ``flips[i]`` is set, on ``num_threads`` threads
    (0: the CPU count, at most 16)."""
    lib = _lib()
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    flips = np.zeros(n, np.uint8) if flips is None else \
        np.ascontiguousarray(flips, np.uint8)
    if flips.shape != (n,):
        raise ValueError(f"flips of shape {flips.shape} for {n} paths")
    num_threads = num_threads or min(os.cpu_count() or 8, 16)
    failed = lib.srgan_load_batch(names, n, crop, out_size,
                                  _ptr(flips, ctypes.c_ubyte), num_threads,
                                  _ptr(out, ctypes.c_float))
    if failed != 0:
        raise IOError(f"native decode failed for {failed}/{n} images")
    return out
