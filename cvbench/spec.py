"""Finding a cell's files by name.

A cell is ``workloads/<name>.json``; it names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``,
which may name its generator, ``traffic/<generator>.py``) and its entry
(``entries/<entry>.py``), whose ``TRAJECTORY`` names the reference's
module (``reference/<trajectory>.py``). ``BENCHMARK.json`` at the root of
the checkout says which metrics a cell reports. Nothing here lists the
cells: a later change adds one by adding its files.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
MODULE = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")


def _load(path: Path):
    with open(path) as fh:
        return json.load(fh)


def _named(kind: str, name: str) -> str:
    """``name``, where it is a valid name of a ``kind`` of file."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def load_cell(name: str, bench_dir: Path = HERE):
    """(cell, configuration, traffic mix) of workload ``name``, each the
    parsed JSON of its file under ``bench_dir``."""
    cell = _load(bench_dir / "workloads" / f"{_named('workload', name)}.json")
    cfg = _load(bench_dir / "configs"
                / f"{_named('config', cell['config'])}.json")
    mix = _load(bench_dir / "traffic"
                / f"{_named('traffic', cell['traffic'])}.json")
    module_name("entry", cell["entry"])
    return cell, cfg, mix


def module_name(kind: str, name: str) -> str:
    """``name``, where it is a valid name of a ``kind`` of module."""
    if not isinstance(name, str) or not MODULE.fullmatch(name):
        raise ValueError(f"bad {kind} module name {name!r}")
    return name


def module(package: str, name: str):
    """The module ``cvbench.<package>.<name>``: an entry, a per-layer
    metric's reader, a trajectory class of the reference or a traffic
    generator, found by the name a file of data gives it."""
    return importlib.import_module(
        f"{__package__}.{package}.{module_name(package, name)}")


def params_of(cell, cfg):
    """The parameters a cell runs: its configuration's, then the cell's
    own settings of the solver (a start, a tolerance) over them."""
    return {**cfg["params"], **cell.get("params", {})}


def benchmark(root: Path = HERE.parent):
    """The parsed ``BENCHMARK.json`` at the root of the checkout."""
    return _load(root / "BENCHMARK.json")


def metrics_of(bench, section: str, workload: str):
    """The entries of ``bench[section]`` that workload reports: those
    that list it under ``workloads`` and those that list no workloads."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def quantity(metric: str) -> str:
    """What a metric measures: its name up to the first dot. A quantity
    whose cells differ in kind (the tolerance cell's host-paced calls
    against the fixed cells') is split into metrics ``<quantity>`` and
    ``<quantity>.<kind>``, each with its own cells and bound, and one
    reader."""
    return metric.split(".", 1)[0]
