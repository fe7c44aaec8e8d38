"""Run one cell of the benchmark once and print its result line.

    python3 cvbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the program under test
(``chan_vese_tpu_torch``) beside ``cvbench/`` and ``BENCHMARK.json``, on a
machine with as many CUDA devices as the cell asks for. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each compared number with its limit); the compared
numbers are also the last lines of standard error. Without a device, with
too few, or where JAX or the JAX package got loaded, it prints no result
and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _plain(value):
    """A JSON-safe number: a non-finite one as its name."""
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cvbench import harness, spec

    cell, _, _ = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        harness.log("cvbench: no CUDA device; no result")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"cvbench: {args.workload} needs {cell['chips']} CUDA "
                    f"devices, have {torch.cuda.device_count()}; no result")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, _ = harness.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"cvbench: the run loaded {found}; no result")
        return 3
    for m in result["metrics"].values():
        m["value"] = _plain(m["value"])
    for name, held in result["checks"].items():
        held["value"] = _plain(held["value"])
        harness.log(f"check {name} {held['value']} limit {held['limit']}")
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
