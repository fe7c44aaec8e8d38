"""R1 (csrc/reinit.cu), the redistance kernel, against its plain version
``ops.reinit.reinit_reference`` on the card: bitwise in f32 and f64, on a
single level set and a stack (each frame its own), at odd shapes and at
the steps the drivers use; the tile body also bitwise the first body's
recorded output (tests/card_digests.json) at the 4K pyramid's five level
shapes, a ragged shape and a stack, on a second launch and a second
stream, its input left as it was. The tests are ``cuda``-marked and skip
without a GPU; on the CPU ``reinit`` runs the plain version itself
(tests/test_torch_reinit.py holds that against the reference, and
tests/test_torch_reinit_tiling.py the tile body's schedule)."""

import numpy as np
import pytest
import torch

from chan_vese_tpu_torch.ops import _cuda
from chan_vese_tpu_torch.ops import reinit as reinit_fn
from chan_vese_tpu_torch.ops.reinit import reinit_reference
from torch_port_helpers import assert_digest


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (R1 has no CPU mode)")
    return torch.device("cuda", 0)


def _level_sets(n, h, w, seed=0):
    """Noisy disk SDFs of slope 3 with exact zeros: crossing cells, clipped
    subcell estimates and both Godunov branches."""
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for m in range(n):
        r = np.hypot(i - (0.3 + 0.1 * m) * h, j - 0.45 * w)
        phi = 3.0 * (0.25 * min(h, w) - r) + rng.standard_normal((h, w))
        phi[h // 3, : w // 4] = 0.0
        out.append(phi)
    return np.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 135, 240), (1, 257, 131), (3, 64, 96)])
@pytest.mark.parametrize("steps", [1, 20])
def test_r1_is_its_plain_version_bitwise(dtype, shape, steps):
    dev = _card()
    phi = torch.from_numpy(_level_sets(*shape)).to(dev, dtype)
    x = phi[0] if shape[0] == 1 else phi
    before = reinit_fn.launches
    got = reinit_fn(x, steps)
    want = reinit_reference(x, steps)
    torch.cuda.synchronize()
    assert reinit_fn.launches == before + _passes(x, steps)  # a pass each
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(x, phi[0] if shape[0] == 1 else phi)  # input kept


@pytest.mark.cuda
def test_r1_stack_frames_are_their_own_launches():
    dev = _card()
    phi = torch.from_numpy(_level_sets(3, 72, 80, seed=1)).to(dev,
                                                              torch.float32)
    got = reinit_fn(phi, 9)
    for m in range(3):
        assert torch.equal(got[m], reinit_fn(phi[m], 9))


@pytest.mark.cuda
def test_r1_refuses_what_it_does_not_take():
    dev = _card()
    with pytest.raises(TypeError, match="float32 or float64"):
        reinit_fn(torch.zeros(8, 8, device=dev, dtype=torch.float16), 2)
    with pytest.raises(ValueError, match="takes"):
        reinit_fn(torch.zeros(2, 2, 8, 8, device=dev), 2)


def _passes(x, steps):
    b, h, w = (1, *x.shape) if x.ndim == 2 else x.shape
    return -(-steps // _cuda.reinit_geometry(b, h, w, steps,
                                             x.element_size())[0])


# the 4K pyramid's five level shapes, a ragged shape and a stack
TILE_SHAPES = [(1, 135, 240), (1, 270, 480), (1, 540, 960), (1, 1080, 1920),
               (1, 2160, 3840), (1, 257, 131), (2, 1080, 1920)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("steps", [1, 9, 20])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tile_body_is_its_first_body_and_plain_version(shape, steps, dtype):
    dev = _card()
    phi = torch.from_numpy(_level_sets(*shape, seed=steps)).to(dev, dtype)
    x = phi[0] if shape[0] == 1 else phi
    kept = x.clone()
    before = reinit_fn.launches
    got = reinit_fn(x, steps)
    assert reinit_fn.launches == before + _passes(x, steps)
    want = reinit_reference(x, steps)
    torch.cuda.synchronize()
    assert_digest(f"R1 {shape} steps={steps} {dtype}", got)
    assert torch.equal(got, want)
    assert torch.equal(x, kept)  # the input left as it was


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_body_second_launch_and_stream_are_the_first(dtype):
    dev = _card()
    x = torch.from_numpy(_level_sets(2, 540, 960, seed=5)).to(dev, dtype)
    first = reinit_fn(x, 20)
    again = reinit_fn(x, 20)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        other = reinit_fn(x, 20)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(again, first)
    assert torch.equal(other, first)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", list(_cuda.REINIT_DEPTHS))
def test_tile_body_is_bitwise_at_every_depth(depth):
    """Each pass depth the geometry chooses among, under a small tile (so
    every window is cut), against the first body's recorded output and
    the plain version."""
    dev = _card()
    x = torch.from_numpy(_level_sets(1, 257, 131, seed=depth)[0]).to(
        dev, torch.float32)
    for steps in (1, 9, 20):
        k = min(depth, steps)
        geo = (k, 64 - 2 * k, 64 - 2 * k, 64, 8, 8)
        got = _cuda.launch_reinit(x, steps, 0.5, 1.0, geometry=geo)
        want = reinit_reference(x, steps)
        torch.cuda.synchronize()
        assert_digest(f"R1 (257, 131) steps={steps} depth={depth}", got)
        assert torch.equal(got, want), (depth, steps)
