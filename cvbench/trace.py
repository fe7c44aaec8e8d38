"""The reduction of a ``torch.profiler`` Chrome trace to what the
per-layer metrics read.

The harness marks each timed call with the span ``cvbench.call`` (from the
hand-off of the input to the mask ready on the device) and its own closing
synchronise inside it with ``cvbench.close``. A device operation belongs
to the call whose span holds the host-side launch that the trace
correlates with it. Times are in seconds.
"""

from __future__ import annotations

import bisect
import json

CALL, CLOSE = "cvbench.call", "cvbench.close"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")
# host calls that wait for the device
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"})
# how far back the label of an idle gap is looked for among host events
_LABEL_LOOKBACK = 256


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list, cut to ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.strip()[:width]


def _union(intervals):
    """Sorted, merged [(start, end)] of ``intervals``."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


class Trace:
    """The calls, device operations and host events of a Chrome trace.

    ``calls_info``: one dict per timed call, in order, with the call's
    ``iters`` and ``least_s`` (its least time on the card,
    ``cvbench.work``)."""

    def __init__(self, events, calls_info):
        us = 1e-6
        spans = [e for e in events if e.get("ph") == "X"]
        calls = sorted((e["ts"] * us, (e["ts"] + e["dur"]) * us, e["tid"])
                       for e in spans if e.get("cat") == "user_annotation"
                       and e["name"] == CALL)
        self.host_tid = calls[0][2] if calls else None
        self.calls = [(s, t) for s, t, _ in calls]
        self.closes = sorted((e["ts"] * us, (e["ts"] + e["dur"]) * us)
                             for e in spans
                             if e.get("cat") == "user_annotation"
                             and e["name"] == CLOSE)
        self.calls_info = list(calls_info)[:len(self.calls)]
        self.api = sorted(
            (e["ts"] * us, e["name"], e.get("args", {}).get("correlation"))
            for e in spans if e.get("cat") in HOST_API_CATS)
        self.device = sorted(
            (e["ts"] * us, (e["ts"] + e["dur"]) * us, e["cat"],
             short_name(e["name"]), e.get("args", {}).get("correlation"))
            for e in spans if e.get("cat") in DEVICE_CATS)
        self.host = sorted(
            (e["ts"] * us, (e["ts"] + e["dur"]) * us, e["name"])
            for e in spans if e.get("tid") == self.host_tid
            and e.get("cat") in ("cpu_op", "user_annotation")
            + HOST_API_CATS)
        self.window = ((self.calls[0][0], self.calls[-1][1])
                       if self.calls else None)
        self._call_starts = [s for s, _ in self.calls]
        self._close_starts = [s for s, _ in self.closes]

    @classmethod
    def from_file(cls, path, calls_info):
        with open(path) as fh:
            return cls(json.load(fh)["traceEvents"], calls_info)

    def _index(self, starts, spans, t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= spans[i][1] else None

    def call_of(self, t):
        """The index of the call whose span holds host time ``t``."""
        return self._index(self._call_starts, self.calls, t)

    def in_close(self, t):
        return self._index(self._close_starts, self.closes, t) is not None

    def launches_by_call(self):
        """Per call, its kernels: [(start, end, name), ...]."""
        launch_t = {corr: t for t, _, corr in self.api if corr is not None}
        out = [[] for _ in self.calls]
        for start, end, cat, name, corr in self.device:
            if cat != "kernel" or corr not in launch_t:
                continue
            i = self.call_of(launch_t[corr])
            if i is not None:
                out[i].append((start, end, name))
        return out

    def syncs_by_call(self):
        """Per call, the host calls in its span that wait for the device,
        the benchmark's own closing synchronise left out."""
        out = [0] * len(self.calls)
        for t, name, _ in self.api:
            if name in SYNC_CALLS and not self.in_close(t):
                i = self.call_of(t)
                if i is not None:
                    out[i] += 1
        return out

    def busy_intervals(self):
        """The merged intervals in which a device operation ran, within
        the window."""
        if self.window is None:
            return []
        lo, hi = self.window
        return _union((max(s, lo), min(e, hi)) for s, e, *_ in self.device
                      if e > lo and s < hi)

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals())

    def window_s(self):
        return 0.0 if self.window is None else (self.window[1]
                                                - self.window[0])

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time
        in the window, summed by name."""
        if self.window is None:
            return []
        lo, hi = self.window
        total = {}
        for s, e, _, name, _ in self.device:
            if e > lo and s < hi:
                total[name] = total.get(name, 0.0) + min(e, hi) - max(s, lo)
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def _label(self, t):
        """What the host was doing at time ``t``: the innermost host event
        that holds it among the last few that began before it, else the
        call's own code or the harness between calls."""
        i = bisect.bisect_right(self.host, (t, float("inf"), "")) - 1
        best = None
        for j in range(i, max(i - _LABEL_LOOKBACK, -1), -1):
            start, end, name = self.host[j]
            if end >= t and (best is None or end - start < best[0]):
                best = (end - start, name)
        if best is None or best[1] == CALL:
            # no event within reach: the call's own code, or between calls
            return ("between calls" if self.call_of(t) is None
                    else "host code in the call")
        return best[1]

    def idle_gaps(self, top: int = 10):
        """[[label, seconds]]: the device's idle time in the window, cut
        at the calls' edges and summed by what the host was doing in each
        piece (at its middle), largest first."""
        busy = self.busy_intervals()
        if self.window is None:
            return []
        lo, hi = self.window
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        cuts = sorted(x for s, e in self.calls for x in (s, e))
        total = {}
        for start, end in zip(edges[::2], edges[1::2]):
            inner = [x for x in cuts[bisect.bisect_right(cuts, start):
                                     bisect.bisect_left(cuts, end)]]
            for a, b in zip([start] + inner, inner + [end]):
                if b > a:
                    label = self._label(0.5 * (a + b))
                    total[label] = total.get(label, 0.0) + b - a
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]
