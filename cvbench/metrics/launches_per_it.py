"""Kernels launched from inside a call's span, over the iterations the
calls ran. Layer: launch (the chunking, the packs and the means between
chunks)."""


def read(trace):
    if not trace.device:  # no device in the trace: nothing to read
        return None
    launches = trace.launches_by_call()
    iters = sum(info["iters"] for info in trace.calls_info)
    if not launches or not iters:
        return None
    return sum(len(k) for k in launches) / iters
