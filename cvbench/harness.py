"""The harness core: one run of one cell.

Set-up builds the cell's entry, makes the pool of inputs from the seed
and warms the cell's one shape with a call. The window is a closed loop
with one caller: calls start until ``seconds`` have passed, each hands the
next pooled input to the program and ends when its mask is ready on the
device. After the window the device's peak memory is read, the program is
let go, and a sample of the calls, drawn from the seed, is compared with
the plain reference (:mod:`cvbench.check`).

The end-to-end quantities live here (a metric ``<quantity>.<cells>`` in
``BENCHMARK.json`` is the same quantity over other cells, with a bound of
its own):

- ``mpix_it_per_s``: the pixel-iterations that the window's calls
  completed over the whole window, in millions a second;
- ``mask_ms_p95``: the 95th percentile of the calls' times, from hand-off
  to the mask ready on the device;
- ``setup_s``: process start to the first timed call.

A traced run (``trace``) profiles the window (at most
:data:`TRACE_WINDOW_S`) and reports the cell's per-layer metrics, each
read by its module in :mod:`cvbench.metrics`, instead.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import random
import statistics
import sys
import tempfile
import time
import traceback

import torch

from . import check, reference, spec, traffic, work
from .trace import CALL, CLOSE, Trace

# the longest window a traced run profiles: its per-layer numbers are
# averages over calls, and a longer trace only costs time to export
TRACE_WINDOW_S = 5.0
# top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "chan_vese_tpu"})


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules():
    """The top-level names in ``sys.modules`` that a run may not load,
    compared whole (``chan_vese_tpu_torch`` is not ``chan_vese_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def launch_counters():
    """{name: count} of the program's launch counters (the ``launches``
    attribute its kernel wrappers carry)."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("chan_vese_tpu_torch.") or mod is None:
            continue
        for attr, obj in list(vars(mod).items()):
            count = getattr(obj, "launches", None)
            if isinstance(count, int) and getattr(
                    obj, "__module__", None) == mod_name:
                out[f"{mod_name.rsplit('.', 1)[-1]}.{attr}"] = count
    return out


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, random.Random(
            seed), [], 0

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values):
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=100)[94]


def _profile(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _read_trace(prof, calls_info):
    fd, path = tempfile.mkstemp(prefix="cvbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.from_file(path, calls_info)
    finally:
        os.remove(path)


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, bench=None, bench_dir=spec.HERE, program=None):
    """One run of ``workload``. Returns the result's dict (the keys the
    result line prints) and, apart, every compared number.

    ``program``: a stand-in for the entry's ``prepare`` (the control puts
    the reference computed in a lower precision there).

    Where the entry has ``route(u0, params)``, the program's routing of
    the cell's input ({name: value}, such as the chunk length ``k``) is
    compared with what the cell states, which the reference follows: each
    difference is a number ``<name>_gap`` held to 0."""
    bench = spec.benchmark() if bench is None else bench
    cell, cfg, mix = spec.load_cell(workload, bench_dir)
    params = spec.params_of(cell, cfg)
    entry = spec.module("entries", cell["entry"])
    traj = reference.trajectory(entry.TRAJECTORY)
    dtype = getattr(torch, cfg["dtype"])
    prepare = entry.prepare if program is None else program
    steps = [("start-up", time.perf_counter())]
    call = prepare(params, cell, device)
    steps.append(("entry", time.perf_counter()))
    inputs = traffic.pool(mix, seed, device)
    _sync(device)
    steps.append(("pool", time.perf_counter()))
    route = entry.route(inputs[0], params) if hasattr(entry, "route") else {}
    gaps = {f"{key}_gap": abs(value - cell[key])
            for key, value in route.items()}
    if route:
        stated = {key: cell[key] for key in route}
        log(f"cvbench: {workload} route: the program's {route}, the cell's "
            f"{stated}" + ("" if route == stated else
                           "; they differ, so the run is not correct"))
    before = launch_counters()
    call(inputs[0])
    _sync(device)
    steps.append(("warm call", time.perf_counter()))
    moved = {k: v - before.get(k, 0) for k, v in launch_counters().items()
             if v != before.get(k, 0)}
    log(f"cvbench: {workload} route (launches of the warm-up call): "
        f"{moved or 'none counted'}")
    marks = [t_start] + [t for _, t in steps]
    log("cvbench: set-up " + ", ".join(
        f"{name} {t1 - t0:.3f} s" for (name, _), t0, t1
        in zip(steps, marks, marks[1:])))

    sample = Reservoir(int(cell["sample"]), seed)
    times, calls_info, failures = [], [], []
    pix_it = 0
    limit_s = min(seconds, TRACE_WINDOW_S) if trace else seconds
    prof = _profile(device) if trace else contextlib.nullcontext()
    setup_s = time.perf_counter() - t_start
    with prof:
        first = time.perf_counter()
        end = first
        i = 0
        while end - first < limit_s or i == 0:
            x = inputs[i % len(inputs)]
            t0 = time.perf_counter()
            with torch.profiler.record_function(CALL):
                try:
                    out = call(x)
                except Exception:  # a call that raises is a failed call
                    failures.append(traceback.format_exc())
                    out = None
                with torch.profiler.record_function(CLOSE):
                    _sync(device)
            end = time.perf_counter()
            if out is not None:
                times.append(end - t0)
                ops, nbytes, done = traj.call_work(tuple(x.shape), out[2],
                                                   cell)
                pix_it += done
                calls_info.append({"iters": out[2], "least_s":
                                   work.roofline(nbytes, ops)[0]})
                sample.offer((i % len(inputs), out))
            i += 1
            out = None
    window_s = end - first
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if failures:
        log(f"cvbench: {len(failures)} of {i} calls raised; the first:\n"
            f"{failures[0]}")

    result = {"correct": False, "attempted": i, "failed": len(failures)}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if trace:
        tr = _read_trace(prof, calls_info)
        for m in spec.metrics_of(bench, "per_layer", workload):
            value = spec.module("metrics", spec.quantity(m["name"])).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s()
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        del tr
    else:
        values = {"mpix_it_per_s": pix_it / window_s / 1e6,
                  "mask_ms_p95": p95(times) * 1e3 if times else math.inf,
                  "setup_s": setup_s}
        for m in spec.metrics_of(bench, "end_to_end", workload):
            metrics[m["name"]] = {"value": values[spec.quantity(m["name"])],
                                  "unit": m["unit"]}
    del prof, call, prepare
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers = _compare(sample.items, inputs, params, cell, traj, dtype)
    numbers.update(gaps)
    log(f"cvbench: {workload} set-up {setup_s:.3f} s, window {window_s:.3f} "
        f"s ({i} calls, {window_s - sum(times):.4f} s of it between "
        f"calls), reference of {len(sample.items)} calls "
        f"{time.perf_counter() - t_ref:.3f} s")
    ok, held = check.judge(numbers, {**cell["limits"],
                                     **{name: 0 for name in gaps}})
    result["correct"] = bool(ok and not failures and sample.items)
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = held
    return result, numbers


def _compare(items, inputs, params, cell, traj, dtype):
    """The worst numbers of the sampled calls against the reference of
    trajectory class ``traj``, which runs once for each pooled input the
    sample holds."""
    compare = getattr(traj, "compare", check.compare)
    refs, results = {}, []
    for idx, out in sorted(items, key=lambda item: item[0]):
        if idx not in refs:
            refs.clear()  # one reference in memory at a time
            refs[idx] = traj.run(inputs[idx], params, cell, dtype)
        results.append(compare(out, refs[idx]))
    return check.worst(results)
