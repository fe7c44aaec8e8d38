"""Small copies of the benchmark's cells for the CPU tests: the same
configurations, entries, trajectories, samples and limits, on images a
test run can hold, in a copy of ``cvbench/`` under a temporary
directory."""

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("gray4k-fixed800", "rgb4k-fixed800", "stack256x512-fixed30",
         "gray4k-disk-tol")
# per cell: the image of its traffic, its shapes' radii (or listed
# disks) and, where a smaller image needs fewer, its iterations
SMALL = {
    "gray4k-fixed800": dict(size=[64, 256], radius=[5, 25], iters=40),
    "rgb4k-fixed800": dict(size=[64, 256], radius=[5, 25], iters=40),
    "stack256x512-fixed30": dict(size=[32, 128], radius=[4, 12], frames=4),
    "gray4k-disk-tol": dict(size=[64, 256], dealt=[[19, -3, 4], [23, 4, -2]]),
}


def tiny(name):
    return f"tiny-{name}"


def make_bench(tmp: Path) -> Path:
    """A copy of ``cvbench/`` with a small cell ``tiny-<cell>`` beside each
    cell, and a ``BENCHMARK.json`` that gives the small cells the cells'
    metrics. Returns the copy's ``cvbench`` directory."""
    bench_dir = tmp / "cvbench"
    shutil.copytree(ROOT / "cvbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, small in SMALL.items():
        cell = json.loads((bench_dir / "workloads" / f"{name}.json")
                          .read_text())
        mix = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
        mix["size"], mix["pool"] = small["size"], 2
        if "frames" in small:
            mix["frames"] = small["frames"]
            # the CPU mesh runs the kernels' plain versions through the
            # resident stack driver, as the card's route runs the kernels
            cell["use_pallas"] = True
        for group in mix["shapes"]:
            if "dealt" in group:
                group["dealt"] = small["dealt"]
            else:
                group["radius"] = small["radius"]
        if "iters" in small:
            cell["iters"] = small["iters"]
        cell["traffic"] = tiny(name)
        (bench_dir / "traffic" / f"{tiny(name)}.json").write_text(
            json.dumps(mix))
        (bench_dir / "workloads" / f"{tiny(name)}.json").write_text(
            json.dumps(cell))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if "workloads" in m:
                m["workloads"] += [tiny(n) for n in m["workloads"]
                                   if n in SMALL]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir
