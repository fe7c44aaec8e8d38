"""Profiling and timing harness.

Counterpart of ``chan_vese_tpu/utils/profiling.py``:

- ``time_fn``: best-of-reps wall timing with warmup, synchronising every
  CUDA device the output lies on before the clock is read.
- ``trace``: context manager around ``torch.profiler.profile`` (CPU and,
  where present, CUDA activities) that writes a Chrome/Perfetto trace JSON
  into a directory. Around any driver call it holds, beside the device's
  kernels and copies and on their clock, the port's own spans
  (:mod:`..spans`): ``cv.drv.setup``, ``cv.drv.step``, ``cv.drv.means``,
  ``cv.drv.stop`` and ``cv.drv.finish`` in the banded and stack drivers,
  ``cv.launch.<wrapper>`` around each kernel wrapper that counts its
  launches, and ``cv.sync.<site>`` around each host wait on those routes
  (``n_pix``, ``region_n``, ``inf``, ``tol``, ``diverged``).
- ``roofline``: the memory-bound ceiling of the fused iteration on a given
  card, to sanity-check measured numbers (the sweep moves ~12 B per
  pixel-iteration: read phi, read u0, write phi, all f32).
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import torch

# the HBM3 rate of the NVIDIA H100 80GB HBM3 (SXM) in NVIDIA's data sheet,
# in GB/s
H100_SXM_HBM_GBPS = 3350.0


def _cuda_devices(out):
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists,
    dicts and named tuples)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in out))
    return set()


def _block_until_ready(out):
    devices = _cuda_devices(out)
    if not devices and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


def time_fn(fn, *args, warmup: int = 1, reps: int = 3, readback=None):
    """Best-of-reps wall time of ``fn(*args)`` (seconds) and its output.

    ``readback``: optional function of the output returning a scalar
    tensor, read to the host after each call to force full
    materialization. ``warmup=0`` measures cold (includes the kernels'
    first build and load).
    """
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args)
        _block_until_ready(out)
        if readback is not None:
            float(readback(out))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _block_until_ready(out)
        if readback is not None:
            float(readback(out))
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(log_dir=None):
    """torch.profiler trace of the block: CPU activity, and CUDA activity
    where a GPU is present. On exit the trace is written as
    ``<log_dir>/trace.json`` (Chrome trace format: open it in Perfetto or
    chrome://tracing). ``log_dir`` defaults to a new temporary directory;
    the context yields it."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(tempfile.mkdtemp(prefix="cv_trace_") if log_dir is None
                   else log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(log_dir)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def roofline(h: int, w: int, hbm_gbps: float = H100_SXM_HBM_GBPS,
             bytes_per_pixel_iter: float = 12.0) -> float:
    """Memory-bound ceiling in Mpixel-iters/s for the fused iteration; the
    default rate is the NVIDIA H100 80GB HBM3 (SXM) data sheet's 3350 GB/s
    (the ceiling does not depend on the image's size)."""
    pixels_per_sec = hbm_gbps * 1e9 / bytes_per_pixel_iter
    return pixels_per_sec / 1e6
