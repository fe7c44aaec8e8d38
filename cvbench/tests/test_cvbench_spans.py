"""The readers of the program's own spans (``cv.sync.*``, ``cv.launch.*``,
``cv.drv.*``) on a small hand-made Chrome trace."""

import importlib
import json

import pytest

from cvbench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)

from cvbench.trace import Trace

BAND = "void cv::band_kernel<0, false, true>(float const*, float*, int)"
OP = "void at::native::vectorized_elementwise_kernel<4>(int)"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1 if tid else 0,
            "tid": tid, "ts": ts, "dur": dur, "args": args}


def _span(name, ts, dur):
    # the harness's spans are annotations, the program's are recorded as
    # operations (``chan_vese_tpu_torch/spans.py``)
    return _x("cpu_op" if name.startswith("cv.") else "user_annotation",
              name, ts, dur)


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 5, correlation=corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, tid=7, correlation=corr)


# Two calls of 8 iterations. Call 0: an upload of a host number in set-up,
# a chunk (the wrapper's launch, a means kernel), the stop test's read,
# the mask in the finish. Call 1: a read, two back-to-back waits, the
# stack wrapper with a pack nested in it, a kernel from outside any
# wrapper. Times in microseconds.
EVENTS = [
    _span("cvbench.call", 1000, 2000),
    _span("cv.drv.setup", 1010, 90),
    _span("cv.sync.n_pix", 1020, 40),
    _x("cuda_runtime", "cudaMemcpyAsync", 1025, 3, correlation=10),
    _x("cuda_runtime", "cudaStreamSynchronize", 1030, 25),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1040, 5, tid=7,
       correlation=10),
    _span("cv.drv.step", 1100, 900),
    _span("cv.launch.packed_banded_chunk", 1110, 40),
    _launch(1120, 1),
    _kernel(BAND, 1130, 470, 1),
    _span("cv.drv.means", 1150, 50),
    _launch(1160, 2),
    _kernel(OP, 1600, 50, 2),
    _span("cv.drv.stop", 1200, 600),
    _span("cv.sync.tol", 1210, 490),
    _launch(1215, 3),
    _kernel(OP, 1650, 10, 3),
    _x("cuda_runtime", "cudaMemcpyAsync", 1220, 3, correlation=4),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1660, 10, tid=7,
       correlation=4),
    _x("cuda_runtime", "cudaStreamSynchronize", 1225, 465),
    _span("cv.drv.finish", 2000, 700),
    _launch(2010, 5),
    _kernel(OP, 2050, 50, 5),
    _span("cvbench.close", 2800, 200),
    _x("cuda_runtime", "cudaDeviceSynchronize", 2850, 100),

    _span("cvbench.call", 3100, 900),
    _span("cv.sync.region_n", 3110, 40),
    _x("cuda_runtime", "cudaStreamSynchronize", 3120, 20),
    _span("cv.sync.diverged", 3151, 4),
    _x("cuda_runtime", "cudaStreamSynchronize", 3152, 2),
    _span("cv.launch.packed_resident_iterations_batch", 3155, 145),
    _span("cv.launch.pack_planes", 3156, 2),
    _launch(3160, 6),
    _kernel(BAND, 3170, 330, 6),
    _launch(3600, 7),
    _kernel(OP, 3610, 40, 7),
    _span("cvbench.close", 3800, 200),
    _x("cuda_runtime", "cudaDeviceSynchronize", 3850, 100),
    {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "args": {}},
]
INFO = [{"iters": 8, "least_s": 1e-4}, {"iters": 8, "least_s": 1e-4}]


def _trace(tmp_path, events=EVENTS):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_file(path, INFO)


def _read(name, trace):
    return importlib.import_module(f"cvbench.metrics.{name}").read(trace)


def test_program_syncs_per_call_equals_host_syncs(tmp_path):
    tr = _trace(tmp_path)
    # two waits a call, each synchronise in a cv.sync span, closes left out
    assert tr.syncs_by_call() == [2, 2]
    assert _read("program_syncs_per_call", tr) == 2.0
    assert _read("host_syncs_per_call", tr) == 2.0


def test_an_unnamed_wait_shows_as_a_difference(tmp_path):
    events = [e for e in EVENTS if e["name"] != "cv.sync.tol"]
    tr = _trace(tmp_path, events)
    assert _read("program_syncs_per_call", tr) == 1.5
    assert _read("host_syncs_per_call", tr) == 2.0


def test_sync_idle_ms_per_call(tmp_path):
    # call 0: 1060-1130 after the upload, 1700-2050 after the read; call
    # 1: 3150-3170 and 3155-3170 once
    want = (70 + 350 + 20) * 1e-3 / 2
    assert _read("sync_idle_ms_per_call", _trace(tmp_path)) == \
        pytest.approx(want)


def test_a_wait_ending_on_a_busy_device_counts_nothing(tmp_path):
    # the read returns while the band kernel still runs
    events = [dict(e, dur=300) if e["name"] == "cv.sync.tol" else e
              for e in EVENTS]
    assert _read("sync_idle_ms_per_call", _trace(tmp_path, events)) == \
        pytest.approx((70 + 20) * 1e-3 / 2)


def test_side_launches_per_it(tmp_path):
    tr = _trace(tmp_path)
    # the means, the stop test's compare, the mask and call 1's loose
    # kernel; the two in wrappers (the nested pack ended before the
    # launch) are not
    assert _read("side_launches_per_it", tr) == pytest.approx(4 / 16)
    assert _read("launches_per_it", tr) == pytest.approx(6 / 16)


@pytest.mark.parametrize("name", ["program_syncs_per_call",
                                  "sync_idle_ms_per_call",
                                  "side_launches_per_it"])
def test_readers_return_nothing_without_program_spans(tmp_path, name):
    events = [e for e in EVENTS if not e["name"].startswith("cv.")]
    tr = _trace(tmp_path, events)
    assert tr.device and _read("host_syncs_per_call", tr) == 2.0
    assert _read(name, tr) is None
