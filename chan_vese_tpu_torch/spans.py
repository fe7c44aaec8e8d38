"""Named spans of the port's work, in the profiler's own timeline.

``span(name)`` records a span while a torch profiler records, so the
spans land in the same Kineto trace as the device's kernels and copies, on
the same clock (as ``cpu_op`` events); otherwise it is one shared null
context, and a span costs a flag check. It records through torch's C++
record function (``torch._C._profiler._RecordFunctionFast``), not
``torch.profiler.record_function``, whose Python enter and exit cost about
20 us a span under the profiler on an H100 host: a quarter of a
host-paced call, and gaps between sibling spans that a trace cannot name.
Nothing else switches them on: ``utils.profiling.trace`` around a call
writes them into its Perfetto trace. Names are ``cv.<layer>.<what>``:

- ``cv.launch.<wrapper>``: the whole call of a kernel wrapper that counts
  its launches (``ops/packed_kernel.py``, ``ops/banded_kernel.py``,
  ``ops/resident_kernel.py``), its plain version on the CPU included;
- ``cv.drv.setup``, ``cv.drv.step``, ``cv.drv.means``, ``cv.drv.stop``,
  ``cv.drv.finish``: a driver's set-up, one pass of its loop, the means
  between chunks, the stop decision and the result;
- ``cv.sync.<site>``: a place where the host waits for the device (a read
  of a device number, a copy of a host number to the device).

This module imports nothing of the package, so any module may import it.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a span while a torch
    profiler records, and does nothing otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
