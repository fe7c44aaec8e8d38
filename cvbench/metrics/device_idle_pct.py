"""The share of the traced window in which no operation ran on the
device, in percent. Layer: the device, as the host's pace leaves it."""


def read(trace):
    if not trace.device:  # no device in the trace: nothing to read
        return None
    window = trace.window_s()
    if window <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / window)
