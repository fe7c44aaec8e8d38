"""The harness driven on the CPU, its look for a chip skipped: the small
cells come out correct, a cell file added to a copy is run without an
edit to any other file (and so is a cell on a new entry, trajectory class
and traffic generator), and a timed path broken underneath, or routed
another way than the cell states, comes out not correct, once for each
fault a cell can have."""

import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from cvbench_tiny import CELLS, ROOT, make_bench, tiny

from cvbench import harness, spec


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("bench"))


def _run(bench_dir, name, seconds=0.3, trace=False, seed=2**33 + 17):
    bench = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
    return harness.run(name, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), bench=bench, bench_dir=bench_dir)


@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_is_correct(bench_dir, cell):
    result, numbers = _run(bench_dir, tiny(cell))
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {spec.quantity(m) for m in result["metrics"]} == {
        "mpix_it_per_s", "mask_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    stated = json.loads((bench_dir / "workloads" / f"{cell}.json")
                        .read_text())
    # the banded cells' chunk length is held against the program's route
    routed = {"k_gap"} if "k" in stated else set()
    assert set(result["checks"]) == set(stated["limits"]) | routed
    assert all(result["checks"][name]["limit"] == 0 for name in routed)


def test_traced_small_cell_reads_no_device_metric_on_the_cpu(bench_dir):
    result, _ = _run(bench_dir, tiny("gray4k-fixed800"), trace=True)
    assert result["correct"]
    # no device in a CPU trace: every per-layer reader returns nothing
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_added_cell_file_is_found_by_name(bench_dir):
    cell = json.loads((bench_dir / "workloads"
                       / f"{tiny('gray4k-fixed800')}.json").read_text())
    cell["iters"] = 12
    before = {p: p.read_bytes() for p in bench_dir.rglob("*")
              if p.is_file()}
    new = bench_dir / "workloads" / "added-cell.json"
    new.write_text(json.dumps(cell))
    try:
        result, _ = _run(bench_dir, "added-cell")
        assert result["correct"]
        assert all(p.read_bytes() == data for p, data in before.items())
    finally:
        new.unlink()


# a cell on an entry, a trajectory class and a traffic generator that the
# benchmark does not have: one image through the program's fused driver,
# means exact at every iteration, on rings of a generator of its own
NEW_FILES = {
    "entries/fused_fixed.py": '''
        from . import port_params

        TRAJECTORY = "exact_means_image"


        def prepare(params, cell, device):
            from chan_vese_tpu_torch.models.fused import segment_fused_fixed

            p, _ = port_params(params)

            def call(u0):
                phi, mask = segment_fused_fixed(u0, p, cell["iters"])
                return phi, mask, cell["iters"]
            return call
        ''',
    "reference/exact_means_image.py": '''
        from .. import check
        from . import exact_means


        def run(u0, params, cell, dtype):
            phi, mask, n = exact_means.run(u0[None], params, cell, dtype)
            return phi[0], mask[0], n


        def call_work(shape, iters, cell):
            return exact_means.call_work((1, *shape), iters, cell)


        def compare(out, ref):
            return {"mask_diff": check.compare(out, ref)["mask_diff"]}
        ''',
    "traffic/rings.py": '''
        import torch


        def pool(mix, seed, device):
            h, w = mix["size"]
            gen = torch.Generator(device=device)
            gen.manual_seed(seed % (1 << 63))
            yy = torch.arange(h, device=device)[:, None] - h / 2
            xx = torch.arange(w, device=device)[None, :] - w / 2
            r = torch.sqrt(yy * yy + xx * xx)
            out = []
            for _ in range(mix["pool"]):
                r0 = float(torch.rand((), generator=gen, device=device))
                ring = (r - (0.2 + 0.1 * r0) * h).abs() < 0.1 * h
                noise = torch.randn((h, w), generator=gen, device=device)
                out.append(200.0 * ring + mix["noise"] * noise)
            return out
        ''',
    "traffic/rings.json": {"generator": "rings", "size": [32, 128],
                           "pool": 2, "noise": 5.0},
    "workloads/fused-rings.json": {
        "config": "cv-gray", "traffic": "rings", "entry": "fused_fixed",
        "iters": 12, "sample": 2, "chips": 1, "why": "a test cell",
        "limits": {"mask_diff": 0.01}},
}


def test_cell_on_new_modules_runs_without_an_edit(tmp_path):
    bench_dir = make_bench(tmp_path)
    before = {p: p.read_bytes() for p in bench_dir.rglob("*")
              if p.is_file()}
    for name, body in NEW_FILES.items():
        text = (textwrap.dedent(body) if isinstance(body, str)
                else json.dumps(body))
        (bench_dir / name).write_text(text)
    bench_file = tmp_path / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    for m in bench["end_to_end"]:
        if m["name"] in ("mpix_it_per_s", "mask_ms_p95"):
            m["workloads"].append("fused-rings")
    bench_file.write_text(json.dumps(bench))
    # a process of its own, whose cvbench is the copy
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
        import torch
        import cvbench
        from cvbench import harness
        assert cvbench.__file__.startswith({str(tmp_path)!r})
        result, numbers = harness.run("fused-rings", 2**33 + 1, 0.3, False,
                                      torch.device("cpu"),
                                      time.perf_counter())
        print(json.dumps([result["correct"], numbers,
                          sorted(result["metrics"])]))
        """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    correct, numbers, metrics = json.loads(proc.stdout.splitlines()[-1])
    assert correct, numbers
    assert set(numbers) == {"mask_diff"}
    assert metrics == ["mask_ms_p95", "mpix_it_per_s", "setup_s"]
    assert all(p.read_bytes() == data for p, data in before.items())


def test_another_chunk_length_is_caught(bench_dir, monkeypatch):
    # the program's router picks another k than the cell states, which
    # the reference follows: the run names the route and is not correct
    from chan_vese_tpu_torch.models import banded
    real, real_mc = banded.auto_config, banded.auto_config_mc
    monkeypatch.setattr(banded, "auto_config",
                        lambda H, W, k=None, *a, **kw: real(H, W, 16, *a,
                                                            **kw))
    monkeypatch.setattr(banded, "auto_config_mc",
                        lambda H, W, C, k=None, *a, **kw: real_mc(
                            H, W, C, 16, *a, **kw))
    for cell in ("gray4k-fixed800", "rgb4k-fixed800", "gray4k-disk-tol"):
        result, numbers = _run(bench_dir, tiny(cell))
        assert not result["correct"], (cell, numbers)
        # k = 16, or the fused driver's 1 where the small image is off
        # the banded envelope at 16
        held = result["checks"]["k_gap"]
        assert held["value"] > 0 and held["limit"] == 0


def _unchanged(real):
    """A chunk that returns its state as it came in (with the partials
    of a real step)."""
    def chunk(phi, *args, **kw):
        return phi, real(phi, *args, **kw)[1]
    return chunk


def test_state_left_unchanged_is_caught(bench_dir, monkeypatch):
    from chan_vese_tpu_torch.ops import banded_kernel
    monkeypatch.setattr(banded_kernel, "banded_chunk",
                        _unchanged(banded_kernel.banded_chunk))
    monkeypatch.setattr(banded_kernel, "banded_chunk_mc",
                        _unchanged(banded_kernel.banded_chunk_mc))
    for cell in ("gray4k-fixed800", "rgb4k-fixed800", "gray4k-disk-tol"):
        result, numbers = _run(bench_dir, tiny(cell))
        assert not result["correct"], (cell, numbers)


def test_stack_state_left_unchanged_is_caught(bench_dir, monkeypatch):
    from chan_vese_tpu_torch.ops import packed_kernel, resident_kernel
    for mod, name in ((resident_kernel, "resident_iterations_batch"),
                      (packed_kernel, "packed_resident_iterations_batch")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda phis, u0s, *a, _r=real, **k:
                            (phis.clone(), _r(phis, u0s, *a, **k)[1]))
    result, numbers = _run(bench_dir, tiny("stack256x512-fixed30"))
    assert not result["correct"], numbers


def test_half_the_batch_left_out_is_caught(bench_dir, monkeypatch):
    from chan_vese_tpu_torch.ops import packed_kernel, resident_kernel

    def half(real):
        # the first half of the frames run; the rest keep their start
        def run(phis, u0s, *a, **k):
            n = phis.shape[0] // 2
            out, parts = real(phis[:n], u0s[:n], *a, **k)
            return torch.cat([out, phis[n:]]), parts
        return run
    monkeypatch.setattr(resident_kernel, "resident_iterations_batch",
                        half(resident_kernel.resident_iterations_batch))
    monkeypatch.setattr(packed_kernel, "packed_resident_iterations_batch",
                        half(packed_kernel.packed_resident_iterations_batch))
    result, numbers = _run(bench_dir, tiny("stack256x512-fixed30"))
    assert not result["correct"], numbers


def test_answer_altered_where_produced_is_caught(bench_dir, monkeypatch):
    from chan_vese_tpu_torch.models import banded
    from chan_vese_tpu_torch.parallel import data_parallel

    def altered_fixed(real):
        # one answer turned over where the driver hands it back: the
        # image's level set, or a stack's first frame
        def run(u0, *a, **k):
            phi, mask = real(u0, *a, **k)
            phi = phi.clone()
            if phi.dim() == 3:
                phi[0] = -phi[0]
            else:
                phi = -phi
            return phi, phi >= 0
        return run

    def altered_tol(u0, *a, _real=banded.segment_banded, **k):
        # the stop moved eight chunks on
        res = _real(u0, *a, **k)
        return res._replace(iters=res.iters + 64)

    monkeypatch.setattr(banded, "segment_banded_fixed",
                        altered_fixed(banded.segment_banded_fixed))
    monkeypatch.setattr(data_parallel, "segment_stack_sharded",
                        altered_fixed(data_parallel.segment_stack_sharded))
    monkeypatch.setattr(banded, "segment_banded", altered_tol)
    for cell in CELLS:
        result, numbers = _run(bench_dir, tiny(cell))
        assert not result["correct"], (cell, numbers)


def test_a_call_that_raises_is_not_correct(bench_dir, monkeypatch):
    from chan_vese_tpu_torch.models import banded

    calls = []

    def flaky(u0, *a, _real=banded.segment_banded_fixed, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("a fault of the program")
        return _real(u0, *a, **k)
    monkeypatch.setattr(banded, "segment_banded_fixed", flaky)
    result, _ = _run(bench_dir, tiny("gray4k-fixed800"))
    assert result["failed"] == 1 and not result["correct"]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "cvbench" / "run.py"), "--workload",
         "gray4k-fixed800", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is visible to this process")
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    # a checkout that holds only BENCHMARK.json and the benchmark's files
    import shutil
    shutil.copytree(ROOT / "cvbench", tmp_path / "cvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "cvbench/run.py", "--workload", "gray4k-fixed800",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
