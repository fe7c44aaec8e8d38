"""The plain reference held against the program's plain CPU route at
small sizes, in both trajectory classes, and the control (the reference
in bfloat16) failing each cell's limits."""

import json

import pytest
import torch

from cvbench_tiny import ROOT, SMALL, make_bench, tiny

from cvbench import check, reference, spec, traffic


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("bench"))


def _inputs(bench_dir, cell_name, seed=7):
    cell, cfg, mix = spec.load_cell(cell_name, bench_dir)
    params = spec.params_of(cell, cfg)
    return cell, params, traffic.pool(mix, seed, torch.device("cpu"))


def _program(cell, params, device=torch.device("cpu")):
    entry = spec.module("entries", cell["entry"])
    return (entry.prepare(params, cell, device),
            reference.trajectory(entry.TRAJECTORY))


@pytest.mark.parametrize("cell_name", list(SMALL))
def test_reference_matches_the_plain_route(bench_dir, cell_name):
    cell, params, inputs = _inputs(bench_dir, tiny(cell_name))
    call, traj = _program(cell, params)
    for u0 in inputs:
        out = call(u0)
        ref = traj.run(u0, params, cell, torch.float32)
        numbers = check.compare(out, ref)
        # the same scheme and stops. The reference sums the means in
        # float64, the plain route in float32, and the runs from the
        # checkerboard start amplify such rounding: the plain route lies
        # no farther from the reference than the reference run in float64
        # does (twice that, or rounding's own size). One chunk is held to
        # rounding below.
        wide = check.compare(traj.run(u0.double(), params, cell,
                                      torch.float64), ref)
        assert numbers["iters_gap"] == 0.0, numbers
        assert numbers["mask_diff"] <= max(2 * wide["mask_diff"], 1e-3), (
            numbers, wide)
        assert numbers["phi_gap"] <= max(2 * wide["phi_gap"], 1e-3), (
            numbers, wide)


@pytest.mark.parametrize("cell_name", list(SMALL))
def test_reference_agrees_to_rounding_over_a_chunk(bench_dir, cell_name):
    cell, params, inputs = _inputs(bench_dir, tiny(cell_name))
    if cell["iters"] is None:
        params = dict(params, max_iter=cell["k"])
    cell = dict(cell, iters=cell.get("k", 1) if cell["iters"] else None)
    call, traj = _program(cell, params)
    for u0 in inputs:
        numbers = check.compare(call(u0), traj.run(u0, params, cell,
                                                   torch.float32))
        # a cell of the checkerboard's zero lines may take either sign
        assert numbers["mask_diff"] <= 1e-3, numbers
        assert numbers["phi_gap"] <= 1e-4, numbers


def test_tolerance_mode_stops_where_the_program_stops(bench_dir):
    cell, params, inputs = _inputs(bench_dir, tiny("gray4k-disk-tol"))
    call, traj = _program(cell, params)
    for u0 in inputs:
        n = call(u0)[2]
        assert n % cell["k"] == 0 and 0 < n < params["max_iter"]
        assert traj.run(u0, params, cell, torch.float32)[2] == n


def test_fixed_runs_take_their_chunks_and_remainder(bench_dir):
    cell, params, inputs = _inputs(bench_dir, tiny("gray4k-fixed800"))
    for iters in (3, 8, 13):
        c = dict(cell, iters=iters)
        call, traj = _program(c, params)
        out = call(inputs[0])
        ref = traj.run(inputs[0], params, c, torch.float32)
        assert out[2] == ref[2] == iters
        assert torch.equal(out[1], ref[1])


@pytest.mark.parametrize("cell_name", list(SMALL))
def test_control_fails_the_cells_limits(bench_dir, cell_name):
    # the reference put in the program's place in bfloat16, compared as a
    # run compares the program: it has to come out not correct
    cell, params, inputs = _inputs(bench_dir, tiny(cell_name), seed=2**35)
    limits = json.loads((ROOT / "cvbench" / "workloads"
                         / f"{cell_name}.json").read_text())["limits"]
    traj = _program(cell, params)[1]
    results = []
    for u0 in inputs:
        phi, mask, n = traj.run(u0, params, cell, torch.bfloat16)
        ref = traj.run(u0, params, cell, torch.float32)
        results.append(check.compare((phi.float(), mask, n), ref))
    ok, held = check.judge(check.worst(results), limits)
    assert not ok, held


def test_reference_rejects_what_it_does_not_compute():
    u0 = torch.zeros(16, 128)
    p = json.loads((ROOT / "cvbench" / "configs" / "cv-gray.json")
                   .read_text())["params"]
    for bad in ({"order": "jacobi"}, {"reinit_every": 10},
                {"conv_norm": "rms"}):
        with pytest.raises(ValueError):
            reference.trajectory("frozen_chunks").frozen_chunks(
                u0, {**p, **bad}, 8, 8)
