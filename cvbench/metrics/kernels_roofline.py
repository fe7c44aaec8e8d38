"""The calls' least time on the card (``cvbench.work``: the larger of
their operations at the f32 peak and their bytes at the HBM peak) over the
summed device time of the kernels they launched, in percent. Layer: the
kernels."""


def read(trace):
    if not trace.device:  # no device in the trace: nothing to read
        return None
    launches = trace.launches_by_call()
    kernel_s = sum(e - s for call in launches for s, e, _ in call)
    least_s = sum(info["least_s"] for info, call
                  in zip(trace.calls_info, launches) if call)
    if kernel_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / kernel_s
