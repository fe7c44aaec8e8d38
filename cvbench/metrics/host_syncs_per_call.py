"""Host calls that wait for the device (stream, device and event
synchronises, synchronous copies) inside a call's span, the harness's own
closing synchronise left out, per call. Layer: the drivers (their
device-to-host reads and the copies of host numbers to the device)."""


def read(trace):
    if not trace.device:  # no device in the trace: nothing to read
        return None
    syncs = trace.syncs_by_call()
    return sum(syncs) / len(syncs) if syncs else None
