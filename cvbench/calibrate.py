"""The readings a cell's limits are set from, on the chip, in one process.

    python3 cvbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 2] [--control-seconds 6] \
        [--out file.jsonl]

Each seed is a short run of the cell through the harness (set-up, a
window of ``--seconds``, the comparison with the reference). The program's
runs give the lower reading: the worst of each compared number over the
seeds. The control's runs put the reference in the program's place,
computed in the precision below the configuration's (bfloat16 for
float32), and give the upper reading: the least of each number over its
seeds. A line of JSON a run, then one summary line.
The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the precision below each configuration's
LOWER = {"float32": "bfloat16"}


def control(trajectory: str, dtype):
    """A stand-in for an entry's ``prepare``: the reference of trajectory
    class ``trajectory`` in ``dtype``, its level set handed back in
    float32 as the program's would be."""
    from cvbench import reference

    traj = reference.trajectory(trajectory)

    def prepare(params, cell, device):
        def call(u0):
            phi, mask, n = traj.run(u0, params, cell, dtype)
            return phi.float(), mask, n
        return call
    return prepare


def readings(workload, seeds, control_seeds, seconds, control_seconds,
             device, emit):
    """Run the program on ``seeds`` and the control on ``control_seeds``;
    returns the summary {"lower": ..., "upper": ...}."""
    import torch

    from cvbench import harness, spec

    cell, cfg, _ = spec.load_cell(workload)
    entry = spec.module("entries", cell["entry"])
    low = getattr(torch, LOWER[cfg["dtype"]])
    lower, upper = {}, {}
    runs = [("program", s, None, seconds) for s in seeds]
    runs += [("control", s, control(entry.TRAJECTORY, low), control_seconds)
             for s in control_seeds]
    for kind, seed, program, secs in runs:
        result, numbers = harness.run(workload, seed, secs, False, device,
                                      time.perf_counter(), program=program)
        emit({"workload": workload, "kind": kind, "seed": seed,
              "correct": result["correct"],
              "attempted": result["attempted"], "numbers": numbers})
        into = lower if kind == "program" else upper
        pick = max if kind == "program" else min
        for key, value in numbers.items():
            into[key] = pick(into.get(key, value), value)
    return {"workload": workload, "lower": lower, "upper": upper,
            "limits": cell["limits"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seconds", type=float, default=6.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = open(args.out, "a") if args.out else None

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    try:
        emit(readings(args.workload, ints(args.seeds),
                      ints(args.control_seeds), args.seconds,
                      args.control_seconds, device, emit))
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
