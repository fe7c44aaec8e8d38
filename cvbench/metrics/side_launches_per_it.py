"""Kernels launched inside a call's span from outside every kernel
wrapper's span (``cv.launch.*``), over the iterations the calls ran: the
torch operations of the drivers (set-up, the means between chunks, the
stop metric, the mask). Layer: launch. ``launches_per_it`` less this is
the wrappers' own share."""

import bisect

from .program_syncs_per_call import spanned
from ..trace import _union

WRAPPER = "cv.launch."


def read(trace):
    if not spanned(trace):
        return None
    iters = sum(info["iters"] for info in trace.calls_info)
    if not iters:
        return None
    wrappers = _union((s, e) for s, e, name in trace.host
                      if name.startswith(WRAPPER))
    starts = [s for s, _ in wrappers]
    launch_t = {corr: t for t, _, corr in trace.api if corr is not None}
    side = 0
    for _, _, cat, _, corr in trace.device:
        t = launch_t.get(corr) if cat == "kernel" else None
        if t is None or trace.call_of(t) is None:
            continue
        k = bisect.bisect_right(starts, t) - 1
        side += k < 0 or t > wrappers[k][1]
    return side / iters
