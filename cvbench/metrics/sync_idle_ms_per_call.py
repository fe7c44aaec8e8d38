"""The device's idle time in a call from the end of one of the program's
host waits (a ``cv.sync.*`` span) to the next device operation, in ms per
call, overlaps counted once: the device waiting for the host to come back
from reading it, decide and enqueue the next work. A wait that ends with
the device still busy counts nothing. Layer: the drivers."""

import bisect

from .program_syncs_per_call import SYNC, spanned
from ..trace import _union


def read(trace):
    if not trace.calls or not spanned(trace):
        return None
    busy = trace.busy_intervals()
    starts = [s for s, _ in busy]
    waits = []
    for start, end, name in trace.host:
        i = trace.call_of(start) if name.startswith(SYNC) else None
        if i is None:
            continue
        j = bisect.bisect_right(starts, end)
        if j and busy[j - 1][1] >= end:
            continue  # the device still busy when the host came back
        stop = min(starts[j] if j < len(busy) else end, trace.calls[i][1])
        if stop > end:
            waits.append((end, stop))
    return 1e3 * sum(e - s for s, e in _union(waits)) / len(trace.calls)
