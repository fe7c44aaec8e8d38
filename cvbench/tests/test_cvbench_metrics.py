"""The per-layer readers and the breakdown on a small hand-made Chrome
trace, and the run path's imports."""

import ast
import json
import subprocess
import sys

import pytest

from cvbench_tiny import ROOT

from cvbench import spec
from cvbench.trace import Trace, short_name

BAND = ("void cv::(anonymous namespace)::band_kernel<0, false, true>"
        "(float const*, float*, int)")
REDUCE = "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1 if tid else 0,
            "tid": tid, "ts": ts, "dur": dur, "args": args}


# two calls of 8 iterations: call 0 launches two kernels and reads one
# number back; call 1 launches one kernel; each closes with the harness's
# synchronise. Times in microseconds.
EVENTS = [
    _x("user_annotation", "cvbench.call", 1000, 1000),
    _x("user_annotation", "cvbench.close", 1800, 200),
    _x("cuda_runtime", "cudaLaunchKernel", 1100, 10, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 1200, 10, correlation=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 1290, 5, correlation=3),
    _x("cuda_runtime", "cudaStreamSynchronize", 1300, 300),
    _x("cuda_runtime", "cudaDeviceSynchronize", 1850, 100),
    _x("kernel", BAND, 1150, 300, tid=7, correlation=1),
    _x("kernel", REDUCE, 1450, 100, tid=7, correlation=2),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1600, 50, tid=7,
       correlation=3),
    _x("gpu_user_annotation", "cvbench.call", 1100, 900, tid=7),
    _x("user_annotation", "cvbench.call", 2100, 1000),
    _x("user_annotation", "cvbench.close", 2900, 200),
    _x("cuda_runtime", "cudaLaunchKernel", 2200, 10, correlation=4),
    _x("kernel", BAND, 2250, 500, tid=7, correlation=4),
    _x("cpu_op", "aten::add", 2800, 50),
    _x("cuda_runtime", "cudaDeviceSynchronize", 2950, 100),
    {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "args": {}},
]
INFO = [{"iters": 8, "least_s": 1e-4}, {"iters": 8, "least_s": 1e-4}]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return Trace.from_file(path, INFO)


def _metric(name):
    import importlib
    return importlib.import_module(f"cvbench.metrics.{spec.quantity(name)}")


def test_calls_and_window(trace):
    assert len(trace.calls) == 2
    assert trace.window_s() == pytest.approx(2100e-6)
    # the union of kernels and the copy: 400 + 50 + 500 us
    assert trace.busy_s() == pytest.approx(950e-6)


def test_host_syncs_per_call(trace):
    # call 0's stream synchronise; both closing synchronises left out
    assert trace.syncs_by_call() == [1, 0]
    assert _metric("host_syncs_per_call").read(trace) == 0.5


def test_launches_per_it(trace):
    assert [len(k) for k in trace.launches_by_call()] == [2, 1]
    assert _metric("launches_per_it").read(trace) == pytest.approx(3 / 16)


def test_kernels_roofline(trace):
    # 2 x 0.1 ms of least time over 0.9 ms of kernels
    assert _metric("kernels_roofline").read(trace) == pytest.approx(
        100 * 2e-4 / 9e-4)


def test_device_idle_pct(trace):
    assert _metric("device_idle_pct").read(trace) == pytest.approx(
        100 * (1 - 950 / 2100))


def test_breakdown(trace):
    ops = dict(trace.device_ops())
    assert ops == pytest.approx({"cv::band_kernel<0, false, true>": 800e-6,
                                 "at::native::reduce_kernel<512, 1>": 100e-6,
                                 "Memcpy DtoH": 50e-6})
    gaps = dict(trace.idle_gaps())
    # 1000-1150 and 2100-2250 in the call's own code, 1550-1600 in call
    # 0's stream synchronise, 1650-2000 and 2750-3100 in the closes
    assert gaps == pytest.approx({"host code in the call": 300e-6,
                                  "cudaStreamSynchronize": 50e-6,
                                  "cvbench.close": 700e-6,
                                  "between calls": 100e-6})
    assert sum(gaps.values()) == pytest.approx(
        trace.window_s() - trace.busy_s())


def test_short_name():
    assert short_name(BAND) == "cv::band_kernel<0, false, true>"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def test_readers_return_nothing_without_a_device(tmp_path):
    path = tmp_path / "cpu.json"
    path.write_text(json.dumps({"traceEvents": [
        e for e in EVENTS if e.get("cat") in ("user_annotation",
                                              "cpu_op")]}))
    tr = Trace.from_file(path, INFO)
    bench = spec.benchmark(ROOT)
    for m in bench["per_layer"]:
        assert _metric(m["name"]).read(tr) is None


def test_every_per_layer_metric_has_a_reader():
    bench = spec.benchmark(ROOT)
    for m in bench["per_layer"]:
        assert callable(_metric(m["name"]).read)


FORBIDDEN = {"jax", "jaxlib", "flax", "chan_vese_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_run_path_imports_no_jax():
    files = [p for p in (ROOT / "cvbench").rglob("*.py")
             if "tests" not in p.parts]
    for path in files:
        for name in _imports(path):
            # the whole top-level name: chan_vese_tpu_torch is not
            # chan_vese_tpu
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_run_loads_no_jax():
    # everything a run imports, the program's entries among it
    code = ("import sys; sys.path.insert(0, '.');"
            "import cvbench.run, cvbench.harness, cvbench.calibrate;"
            "import chan_vese_tpu_torch.models.banded,"
            " chan_vese_tpu_torch.parallel.data_parallel,"
            " chan_vese_tpu_torch.parallel.mesh;"
            "from cvbench import harness;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
