"""The yardstick of the roofline shares: the operations and bytes a call
needs, and the published peaks of one H100 SXM.

A frozen copy of the repository's ``chip_smoke.py`` arithmetic (its
``OPS_*``, ``PEAK_*``, ``roofline`` and ``bound``): each input read once
and each output written once, the operations per pixel counted from the
shapes. Each trajectory class of the reference (``cvbench/reference``) sums a
call's work with these functions in its ``call_work``. The counts depend
only on the cell (its image shape and channels, its trajectory class and
chunk) and the iterations a call ran, never on how the program implements
them, so a fused or deeper kernel cannot push a share past 100%.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# HBM3 bandwidth
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# operations per cell update: 8 differences, 4 halvings, 4 face
# coefficients (2 squares, 2 adds, rsqrt, mu *), the Dirac factor
# (square, add, divide), num (4 products, 4 adds, 2) and den (3 adds, 2),
# the divide; rsqrt, divide and atan count as one operation
OPS_UPDATE = 55
# per pixel of the exact means, an iteration: the Heaviside (atan,
# divide, multiply, add) and its sum, plus a multiply and an add per
# channel; of a partials row: d, d^2 and its sum, the flips (2 compares,
# not-equal, sum), |d| and its sum
OPS_MEANS, OPS_MEANS_CHANNEL, OPS_ROW = 4, 2, 8


def roofline(nbytes, ops):
    """(seconds, "bytes" or "operations"): the larger of the two least
    times on an H100 SXM."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_work(h, w, k, channels, frames=1, rows=None):
    """(operations, bytes) of one launch's work at (h, w), k iterations,
    ``channels`` (0 = gray), on ``frames`` images: phi and every u0
    channel read once and phi written once, against k updates per pixel
    plus the data term (8 per channel) and the partials (14 + 2 per
    channel) once per pixel. ``rows`` given: an exact-means launch, which
    computes the data term and the means at every iteration and ``rows``
    partials rows."""
    c = max(channels, 1)
    nbytes = 4 * h * w * (2 + c) * frames
    if rows is None:
        per_pixel = OPS_UPDATE * k + 8 * c + 14 + 2 * c
    else:
        per_pixel = (k * (OPS_UPDATE + 8 * c + OPS_MEANS
                          + OPS_MEANS_CHANNEL * c) + rows * OPS_ROW)
    return h * w * frames * per_pixel, nbytes


def bound(h, w, k, channels, frames=1, rows=None):
    """(seconds, "bytes" or "operations"): the least time of one launch
    (:func:`launch_work`) on an H100 SXM."""
    ops, nbytes = launch_work(h, w, k, channels, frames, rows)
    return roofline(nbytes, ops)


def chunks(iters: int, k: int):
    """The chunk sizes of a frozen-means run: full chunks of k, then the
    remainder."""
    return [k] * (iters // k) + ([iters % k] if iters % k else [])


def io_bytes(values_in: int, pixels_out: int) -> int:
    """The bytes of one call: its input's float32 values read once, and a
    float32 level set and a one-byte mask written for each output
    pixel."""
    return 4 * values_in + 5 * pixels_out
