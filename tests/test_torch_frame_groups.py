"""K7/K8 batch on frame groups (``csrc/resident_tiles.cuh``, the groups
from ``ops/_cuda.py::frame_groups``) on the card: a stack in one launch,
its frames dealt to groups of blocks that run side by side, held against
each frame launched alone (one group on the whole grid, the single-image
plan and schedule).

The CPU twin of the grouped schedule and the rule's geometry are in
``test_torch_resident_tiles.py``. This file imports no JAX, so its
``cuda``-marked tests run on a machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_frame_groups.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import chan_vese_tpu_torch as ct
from chan_vese_tpu_torch.ops import _cuda
from chan_vese_tpu_torch.ops import packed_kernel as pk
from chan_vese_tpu_torch.ops import resident_kernel as rk
from chan_vese_tpu_torch.utils.init_phi import init_phi

P = ct.CVParams()
# (the stack launch, the single-image launch)
MODES = {
    "K7 batch": (rk.resident_iterations_batch, rk.resident_iterations),
    "K8 batch": (pk.packed_resident_iterations_batch,
                 pk.packed_resident_iterations),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _stack(n, h, w, dev):
    """n frames of two disks in noise, each its own scene, and starts that
    alternate between the checkerboard and the circle."""
    rng = np.random.default_rng(n)
    i, j = np.mgrid[0:h, 0:w]
    frames, starts = [], []
    for f in range(n):
        cy, cx = rng.uniform(0.3, 0.7, 2)
        disk = np.hypot(i - cy * h, j - cx * w) < rng.uniform(0.1, 0.3) * h
        frames.append(np.where(disk, 200.0, 50.0)
                      + 10.0 * rng.standard_normal((h, w)))
        starts.append(init_phi((h, w), "circle" if f % 2 else "checkerboard",
                               torch.float32))
    u0s = torch.from_numpy(np.stack(frames)).to(torch.float32)
    return torch.stack(starts).to(dev), u0s.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODES))
@pytest.mark.parametrize("n,h,w", [(9, 256, 256), (24, 512, 512)])
def test_grouped_batch_matches_frames_launched_alone(name, n, h, w):
    """phi bitwise each frame's own launch wherever the f32 means agree
    (the f64 sums behind them are added over other tiles), else within
    the batch bars of test_tiles_cuda_two_phase_match_v1_and_plain; each
    frame's row within those bars, its flips equal where phi is; a second
    launch bitwise; one grouped launch counted, none for the frames
    alone."""
    dev = _card()
    batch, single = MODES[name]
    phis, u0s = _stack(n, h, w, dev)
    g = _cuda.frame_groups(n, h, w, 0, _cuda._sm_count(dev.index))[0]
    assert g > 1
    iters = 10
    before = _cuda.group_plan.launches
    new, parts = batch(phis, u0s, P, iters)
    assert _cuda.group_plan.launches == before + 1
    again, parts2 = batch(phis, u0s, P, iters)
    alone = [single(phi, u, P, iters) for phi, u in zip(phis, u0s)]
    torch.cuda.synchronize()
    assert _cuda.group_plan.launches == before + 2
    assert torch.equal(new, again) and torch.equal(parts, parts2)
    same = 0
    for f, (phi, rows) in enumerate(alone):
        if torch.equal(new[f], phi):
            same += 1
            assert torch.equal(parts[f, 3], rows[-1, 3])  # the flips
        else:
            torch.testing.assert_close(new[f], phi, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(parts[f], rows[-1], rtol=1e-4, atol=16.0)
    assert same >= n // 2, f"{same} of {n} frames bitwise"


@pytest.mark.cuda
def test_grouped_launch_names_its_groups_in_the_trace():
    """A grouped launch records ``cv.tile.groups.G<g>xB<b>`` (the rule's G
    and its blocks a group) inside its wrapper's ``cv.launch`` span; a
    single image records none."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    phis, u0s = _stack(9, 256, 256, dev)
    g, geo = _cuda.frame_groups(9, 256, 256, 0, _cuda._sm_count(dev.index))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pk.packed_resident_iterations_batch(phis, u0s, P, 2)
        pk.packed_resident_iterations(phis[0], u0s[0], P, 2)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.name.startswith("cv.")]
    groups = [s for s in spans if s[2].startswith("cv.tile.groups.")]
    name = f"cv.tile.groups.G{g}xB{geo[2] * geo[3]}"
    assert [s[2] for s in groups] == [name]
    outer = [s for s in spans
             if s[2] == "cv.launch.packed_resident_iterations_batch"]
    assert len(outer) == 1
    assert outer[0][0] <= groups[0][0] and groups[0][1] <= outer[0][1]
