"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc`` into one shared
library with a plain C interface, under ``chan_vese_tpu_torch/_build/``,
and loaded with ``ctypes``. The library's name carries a hash of the
sources and flags, so an edit rebuilds it. Nothing is downloaded: the
build needs only the CUDA toolkit and the sources in this package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# the three kernel launchers share one signature apart from k
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_HEAD = [_P] * 6 + [_I, _I]                     # pointers, H, W
_TAIL = [_I, _I, _I] + [_F] * 9 + [_P]          # TH, TW, cap, params, stream
SIGNATURES = {
    "cv_fused_iteration": _HEAD + _TAIL,
    "cv_banded_chunk": _HEAD + [_I] + _TAIL,
    "cv_packed_banded_chunk": _HEAD + [_I] + _TAIL,
}


def sources():
    return sorted(_SRC.glob("*.cu")) + sorted(_SRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit on PATH or in /usr/local/cuda")
    return nvcc


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    lib = _OUT / f"libcv_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    _OUT.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *map(str, sorted(_SRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cv_error_string.argtypes = [ctypes.c_int]
    lib.cv_error_string.restype = ctypes.c_char_p
    return lib
