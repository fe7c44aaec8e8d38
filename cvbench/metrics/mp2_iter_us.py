"""The device time of the kernels launched inside the program's 4-phase
kernel wrappers (``cv.launch.*mp2*`` spans: K10's packs, launch and
unpack, or K9's), over the iterations of the calls that launched them, in
microseconds an iteration: the coupled tile body's cost per iteration.
Layer: the kernels. A call with no such span counts neither its time nor
its iterations; a trace without them reads nothing."""

import bisect

from .program_syncs_per_call import spanned
from ..trace import _union

WRAPPER, MP2 = "cv.launch.", "mp2"


def read(trace):
    if not trace.calls or not spanned(trace):
        return None
    wrappers = _union((s, e) for s, e, name in trace.host
                      if name.startswith(WRAPPER) and MP2 in name)
    if not wrappers:
        return None
    starts = [s for s, _ in wrappers]
    launch_t = {corr: t for t, _, corr in trace.api if corr is not None}
    kernel_s = [0.0] * len(trace.calls)
    launched = [False] * len(trace.calls)
    for start, end, cat, _, corr in trace.device:
        t = launch_t.get(corr) if cat == "kernel" else None
        i = None if t is None else trace.call_of(t)
        if i is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= wrappers[k][1]:
            kernel_s[i] += end - start
            launched[i] = True
    iters = sum(info["iters"] for info, hit
                in zip(trace.calls_info, launched) if hit)
    if not iters:
        return None
    return 1e6 * sum(kernel_s) / iters
