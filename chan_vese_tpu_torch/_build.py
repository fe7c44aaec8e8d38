"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc``, one process
per source and all started together, and the objects are linked into one
shared library with a plain C interface under ``chan_vese_tpu_torch/_build/``,
loaded with ``ctypes``. The library's name carries a hash of the sources
and flags, so an edit rebuilds it; ptxas's register and spill report of
the build is kept beside it (:func:`ptxas_report`). Nothing is downloaded:
the build needs only the CUDA toolkit and the sources in this package.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the band bodies' pointers phi, u0, cc, out, block_parts, parts and H, W
# (multichannel: and C; the per-channel weights travel with the means)
_HEAD = [_P] * 6 + [_I, _I]
_HEAD_MC = [_P] * 6 + [_I, _I, _I]
# shard-canvas launchers (redblack.cuh Shard): the launcher's arguments
# with parity, r0, r1, c0, c1 and the top, bottom, left, right flags
# before the stream
_SHARD = [_I] * 9 + [_P]
# resident launchers on the tile bodies (csrc/resident_tiles.cuh
# CV_TILE_RESIDENT_ARGS): 9 pointers; nblocks, N, H, W, C, iters, unroll,
# batch, nrow, TH, TW, GX, u0res, smem, frame groups; 9 params; stream.
# Each has a `_grid` twin (C, dynamic bytes, int* max co-resident blocks).
_TILE_RESIDENT = [_P] * 9 + [_I] * 15 + [_F] * 9 + [_P]
_TILE_GRID = [_I, _I, ctypes.POINTER(ctypes.c_int)]
RESIDENT_SYMBOLS = ("cv_resident_iterations", "cv_resident_iterations_mc",
                    "cv_packed_resident_iterations",
                    "cv_packed_resident_iterations_mc")
# 4-phase resident launchers on the tile body (csrc/mp2.cuh
# CV_MP2_TILE_ARGS): 7 pointers; nblocks, H, W, iters, unroll, TH, TW, GX,
# u0res, smem; 7 params; stream; `_grid` as above.
_MP2_TILE = [_P] * 7 + [_I] * 10 + [_F] * 7 + [_P]
MP2_RESIDENT_SYMBOLS = ("cv_mp2_resident_iterations",
                        "cv_packed_mp2_resident_iterations")
# frozen-means resident chunk launchers (csrc/resident_chunk.cu, K13) on
# the tile body: 8 pointers; nblocks, H, W, k, TH, TW, GX, u0res, smem; 9
# params; stream; `_grid` as the tile bodies'.
_TILE_CHUNK = [_P] * 8 + [_I] * 9 + [_F] * 9 + [_P]
CHUNK_SYMBOLS = ("cv_resident_chunk", "cv_packed_resident_chunk")
# parity pack and unpack (csrc/pack.cu, K15/K16): source, destination; N,
# H, W, vector width; stream
_PACK = [_P, _P] + [_I] * 4 + [_P]
# morphological launchers on the bit body (csrc/morph_bits.cuh through
# morph_band.cu, morph_fused.cu): pointers (K12: ls, u0, cc, out,
# block_parts, counter, parts); H, W, [kind], k, s, parity0, [balloon,
# thr_b], halo, TH, TW, WW, cap and the grid's block count; stream.
# Occupancy: [kind], cap, int* blocks per SM.
_MORPH = [_P] * 3 + [_I] * 7 + [_F] + [_I] * 6 + [_P]
# the shard kinds' launcher: the same with pt, pb, pcl, pcr and the top,
# bottom, left, right flags before the stream
_MORPH_SHARD = _MORPH[:-1] + [_I] * 8 + [_P]
_MORPH_FUSED = [_P] * 7 + [_I] * 11 + [_P]
# K2/K5 and K3/K6 on csrc/band.cuh: the scalar or multichannel launcher's
# pointers and sizes; k, TH, TW, PX, PY, cap; the params; [the shard ints];
# stream. Occupancy: [C], [shard], threads, dynamic bytes, int* blocks per
# SM. K9 on its band body (csrc/mp2_band.cu) the same, its seven ints TH,
# TW, fold, PX, PY, cap and the grid's block count.
_BAND = [_I] * 6 + [_F] * 9
_BAND_MC = [_I] * 6 + [_F] * 7
_MP2_BAND = [_I] * 7 + [_F] * 9
# K1 and K4 on csrc/sweep.cuh: pointers phi, u0, cc, out, block_parts,
# counters, parts; H, W, [N or C]; TH, TW, PX, PY, cap and the grid's block
# count; the params; [the shard ints]; stream. Occupancy: [shard or C],
# threads, dynamic bytes, int* blocks per SM.
_SWEEP = [_P] * 7 + [_I, _I]
_SWEEP_TAIL = [_I] * 6 + [_F] * 9
_SWEEP_OCC = [_I] * 3 + [ctypes.POINTER(ctypes.c_int)]
# the halo gather (csrc/halo_gather.cu, K14): the geometry, the pointer
# array, the element size, the device; stream. Peer access: device, peer.
_HALO_GATHER = [_P, _P, _I, _I, _P]
# the redistance (csrc/reinit.cu, R1) on the tile body: phi, buf0, buf1;
# B, H, W, steps, k, TH, TW, PX, PY, RS; dtau, h (double); f64; stream.
# Occupancy: f64, threads, dynamic bytes, int* blocks per SM.
_REINIT = [_P] * 3 + [_I] * 10 + [ctypes.c_double] * 2 + [_I, _P]
SIGNATURES = {
    "cv_fused_iteration": _SWEEP + _SWEEP_TAIL + [_P],
    "cv_fused_iteration_shard": _SWEEP + _SWEEP_TAIL + _SHARD,
    "cv_fused_iteration_batch": _SWEEP + [_I] + _SWEEP_TAIL + [_P],
    "cv_fused_sweep": _SWEEP + _SWEEP_TAIL + [_P],
    "cv_fused_sweep_shard": _SWEEP + _SWEEP_TAIL + _SHARD,
    "cv_fused_iteration_mc": _SWEEP + [_I] + _SWEEP_TAIL[:-2] + [_P],
    "cv_sweep_occupancy": _SWEEP_OCC,
    "cv_sweep_occupancy_force": _SWEEP_OCC,
    "cv_sweep_occupancy_mc": _SWEEP_OCC,
    "cv_mp2_iteration": _HEAD + _MP2_BAND + [_P],
    "cv_mp2_iteration_shard": _HEAD + _MP2_BAND + _SHARD,
    "cv_mp2_band_occupancy": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    "cv_banded_chunk": _HEAD + _BAND + [_P],
    "cv_banded_chunk_shard": _HEAD + _BAND + _SHARD,
    "cv_banded_chunk_mc": _HEAD_MC + _BAND_MC + [_P],
    "cv_banded_chunk_mc_shard": _HEAD_MC + _BAND_MC + _SHARD,
    "cv_band_occupancy": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    "cv_band_occupancy_mc": [_I] * 4 + [ctypes.POINTER(ctypes.c_int)],
    "cv_packed_banded_chunk": _HEAD + _BAND + [_P],
    "cv_packed_banded_chunk_shard": _HEAD + _BAND + _SHARD,
    "cv_packed_banded_chunk_mc": _HEAD_MC + _BAND_MC + [_P],
    "cv_packed_band_occupancy": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    "cv_packed_band_occupancy_mc": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
    **{s: _TILE_RESIDENT for s in RESIDENT_SYMBOLS},
    **{f"{s}_grid": _TILE_GRID for s in RESIDENT_SYMBOLS},
    **{s: _MP2_TILE for s in MP2_RESIDENT_SYMBOLS},
    **{f"{s}_grid": _TILE_GRID for s in MP2_RESIDENT_SYMBOLS},
    **{s: _TILE_CHUNK for s in CHUNK_SYMBOLS},
    **{f"{s}_grid": _TILE_GRID for s in CHUNK_SYMBOLS},
    "cv_pack_planes": _PACK,
    "cv_unpack_planes": _PACK,
    "cv_morph_chunk": _MORPH,
    "cv_morph_chunk_shard": _MORPH_SHARD,
    "cv_morph_fused_chunk": _MORPH_FUSED,
    "cv_morph_bits_occupancy": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "cv_morph_fused_bits_occupancy": [_I, ctypes.POINTER(ctypes.c_int)],
    "cv_halo_gather": _HALO_GATHER,
    "cv_halo_peer_access": [_I, _I],
    "cv_reinit": _REINIT,
    "cv_reinit_occupancy": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
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


def _lib_path() -> Path:
    return _OUT / f"libcv_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    lib = _lib_path()
    if lib.exists():
        return lib
    _OUT.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    work = Path(tempfile.mkdtemp(dir=_OUT))
    try:
        jobs = []
        for src in sorted(_SRC.glob("*.cu")):
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                   str(work / f"{src.stem}.o")]
            log = open(work / f"{src.stem}.log", "w+")
            jobs.append((cmd, log, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=log)))
        done = []
        for cmd, log, proc in jobs:  # wait for all before raising
            rc = proc.wait()
            log.seek(0)
            done.append((cmd, rc, log.read()))
            log.close()
        for cmd, rc, text in done:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                                   f"{text}")
        report = [text for _, _, text in done]
        tmp = work / lib.name
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *(str(work / f"{src.stem}.o")
                 for src in sorted(_SRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        lib.with_suffix(".ptxas").write_text("".join(report))
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def ptxas_report() -> str:
    """ptxas's per-kernel registers, shared memory and spills (the
    ``-Xptxas -v`` output) of the library for these sources."""
    return build().with_suffix(".ptxas").read_text()


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
