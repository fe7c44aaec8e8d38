"""The program's own spans of its host waits (``cv.sync.<site>``: a read
of a device number, a copy of a host number to the device) that begin
inside a call's span, per call: the program's count of its host
synchronisations. Layer: the drivers. Where every synchronising host call
in a call lies in such a span, it equals ``host_syncs_per_call``."""

SYNC = "cv.sync."


def spanned(trace):
    """Whether ``trace`` holds a device and the program's ``cv.`` spans,
    which a program older than its spans does not emit."""
    return bool(trace.device) and any(name.startswith("cv.")
                                      for _, _, name in trace.host)


def read(trace):
    if not trace.calls or not spanned(trace):
        return None
    syncs = sum(trace.call_of(start) is not None
                for start, _, name in trace.host if name.startswith(SYNC))
    return syncs / len(trace.calls)
