"""Build the CUDA sources under ``srgan_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by plain ``nvcc`` into its own shared
library with a C interface, which ``ctypes`` loads; no source includes
PyTorch's headers, so a build takes seconds.  Libraries go to
``build/srgan_tpu_torch/`` at the repository root, named by a hash of the
source and the flags, so a source is rebuilt only when it changes.  A failed
build raises with ``nvcc``'s error output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srgan_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 300

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every entry point, per source: name -> (argtypes, restype)
SIGNATURES = {
    "cbinorm": {
        "srgan_cbinorm_fwd": ((_P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _F, _I, _I, _P), _I),
        "srgan_cbinorm_bwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P), _I),
    },
    "histogram": {
        "srgan_soft_histogram_fwd": ((_P, _P, _I, _I, _I, _F, _F, _F, _F,
                                      _P), _I),
        "srgan_soft_histogram_bwd": ((_P, _P, _P, _I, _I, _I, _F, _F, _F,
                                      _F, _P), _I),
    },
    "diversification": {
        "srgan_diversification_fwd": ((_P, _P, _P, _P, _I, _I, _I, _I, _F,
                                       _F, _F, _F, _F, _P), _I),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of srgan_tpu_torch "
                       "need the CUDA toolkit to build")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> float:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    errors = []
    for name, so, tmp, proc in procs:
        try:
            out, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            errors.append(f"{name}.cu: nvcc timed out after "
                          f"{NVCC_TIMEOUT_S} s")
            continue
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n"
                          f"{err.decode(errors='replace')}"
                          f"{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)   # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use, with
    the argument and result types of its entry points declared."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build((name,))
    lib = ctypes.CDLL(str(_target(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = restype
    _LOADED[name] = lib
    return lib
