"""The tiling of R1's tile body (``csrc/reinit.cu`` reinit_tile) checked
on the CPU through a plain windowed twin.

The kernel cuts each frame into TH x TW tiles and runs a pass of up to k
steps on each tile's window, the tile plus k cells each way cut at the
image, with clamped reads at the window's sides: the prepass on phi0's
window, then step n updating only the cells n or more from a cut side
(the others hold older values, which no exact cell reads: the twin keeps
the last ones), then the tile's cells stored. The
ceil(steps / k) passes chain through a buffer, each starting from the last
one's psi and recomputing the prepass from phi0. The twin does the same
with the plain version's expressions (``ops.reinit``'s shifts,
``_godunov_grad`` and ``crossings``) and is held bitwise equal to
``reinit_reference`` in f32 and f64, at ragged shapes and on a stack, at
steps 1, 9 and 20 and at every pass depth the geometry can pick; once
against the JAX package's ``reinit`` at 1e-10. A twin with one cell less
of halo is shown to differ, so the reach is tight.

The remaining cases check ``_cuda.reinit_geometry``: every window fits
the block and the shared memory it names, the 4K and 1080p shapes hold
two blocks an SM in f32, and the launcher's C declarations match their
ctypes signatures.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu_torch import _build
from chan_vese_tpu_torch.ops import _cuda
from torch_port_helpers import assert_rel, to_torch

treinit = importlib.import_module("chan_vese_tpu_torch.ops.reinit")
jreinit = importlib.import_module("chan_vese_tpu.ops.reinit")

DTYPES = {"f32": np.float32, "f64": np.float64}


def level_sets(b, h, w, seed=0):
    """Noisy disk distance functions of slope 3 with exact zeros: crossing
    cells, clipped subcell estimates and both Godunov branches."""
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for m in range(b):
        r = np.hypot(i - (0.3 + 0.1 * m) * h, j - 0.45 * w)
        phi = 3.0 * (0.25 * min(h, w) - r) + rng.standard_normal((h, w))
        phi[h // 3, : w // 4] = 0.0
        out.append(phi)
    return np.stack(out)


def twin_pass(phi0, psi, steps, cuts, dtau=0.5, h=1.0):
    """One pass on a window: the prepass on ``phi0``'s window and
    ``steps`` steps from ``psi``, step n updating the cells n or more from
    each cut side of ``cuts`` = (top, bottom, left, right)."""
    gx = 0.5 * (treinit._down(phi0) - treinit._up(phi0))
    gy = 0.5 * (treinit._right(phi0) - treinit._left(phi0))
    gn2 = gx * gx + gy * gy
    sgn = phi0 / torch.sqrt(phi0 * phi0 + gn2 * (h * h) + 1e-30)
    crosses = treinit.crossings(phi0)
    dist0 = torch.clamp(h * phi0 / torch.clamp(torch.sqrt(gn2), min=1e-12),
                        -1.5 * h, 1.5 * h)
    wh, ww = phi0.shape[-2:]
    rows, cols = torch.arange(wh)[:, None], torch.arange(ww)[None, :]
    top, bottom, left, right = cuts
    for n in range(1, steps + 1):
        g = treinit._godunov_grad(psi, phi0)
        pde = psi - dtau * sgn * (g - 1.0)
        sub = psi - (dtau / h) * (torch.sign(phi0) * torch.abs(psi) - dist0)
        new = torch.where(crosses, sub, pde)
        live = ((rows >= (n if top else 0))
                & (rows < wh - (n if bottom else 0))
                & (cols >= (n if left else 0))
                & (cols < ww - (n if right else 0)))
        psi = torch.where(live, new, psi)
    return psi


def twin(phi, steps, k, tile, halo=None):
    """R1's tile body computed tile by tile on a (B, H, W) stack:
    ``tile`` = (TH, TW), passes of at most k steps, windows of ``halo``
    cells (default k) each way."""
    _, h, w = phi.shape
    th, tw = tile
    halo = k if halo is None else halo
    src = phi
    for n in _cuda.reinit_passes(steps, k):
        out = torch.empty_like(phi)
        for tr0 in range(0, h, th):
            for tc0 in range(0, w, tw):
                tr1, tc1 = min(tr0 + th, h), min(tc0 + tw, w)
                wr0, wr1 = max(tr0 - halo, 0), min(tr1 + halo, h)
                wc0, wc1 = max(tc0 - halo, 0), min(tc1 + halo, w)
                cuts = (wr0 > 0, wr1 < h, wc0 > 0, wc1 < w)
                win = (slice(None), slice(wr0, wr1), slice(wc0, wc1))
                cur = twin_pass(phi[win], src[win], n, cuts)
                out[:, tr0:tr1, tc0:tc1] = cur[:, tr0 - wr0:tr1 - wr0,
                                               tc0 - wc0:tc1 - wc0]
        src = out
    return src


def _geometry_tile(b, h, w, steps, dtype):
    k, th, tw, *_ = _cuda.reinit_geometry(b, h, w, steps,
                                          np.dtype(DTYPES[dtype]).itemsize)
    return k, (th, tw)


# 257 x 131 and 135 x 240 (the pyramid's coarsest 4K level) under the
# tiles the geometry gives them, and a stack of 3: ragged last tiles
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("steps", [1, 9, 20])
@pytest.mark.parametrize("shape", [(1, 257, 131), (1, 135, 240),
                                   (3, 72, 80)])
def test_twin_at_the_geometry_is_bitwise_the_plain_version(shape, steps,
                                                           dtype):
    phi = to_torch(level_sets(*shape, seed=steps), DTYPES[dtype])
    k, tile = _geometry_tile(*shape, steps, dtype)
    assert torch.equal(twin(phi, steps, k, tile),
                       treinit.reinit_reference(phi, steps))


# every depth the geometry chooses among (steps below the depth take one
# pass of all of them), on small tiles so that every window is cut
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("steps", [1, 9, 20])
@pytest.mark.parametrize("k", _cuda.REINIT_DEPTHS)
def test_twin_is_bitwise_at_every_pass_depth(k, steps, dtype):
    phi = to_torch(level_sets(2, 97, 83, seed=k), DTYPES[dtype])
    k = min(k, steps)
    assert torch.equal(twin(phi, steps, k, (23, 29)),
                       treinit.reinit_reference(phi, steps))


def test_every_depth_the_geometry_picks_is_checked():
    picked = {_cuda.reinit_geometry(b, h, w, s, it)[0]
              for b, h, w in [(1, 135, 240), (1, 270, 480), (1, 540, 960),
                              (1, 1080, 1920), (1, 2160, 3840),
                              (2, 1080, 1920), (4, 64, 96), (1, 257, 131)]
              for s in (1, 9, 20) for it in (4, 8)}
    assert picked <= {min(d, s) for d in _cuda.REINIT_DEPTHS
                      for s in (1, 9, 20)}


@pytest.mark.parametrize("k", [5, 10])
def test_one_cell_less_of_halo_differs(k):
    phi = to_torch(level_sets(1, 97, 83, seed=3))
    want = treinit.reinit_reference(phi, 20)
    assert torch.equal(twin(phi, 20, k, (23, 29)), want)
    assert not torch.equal(twin(phi, 20, k, (23, 29), halo=k - 1), want)


def test_twin_matches_the_jax_package():
    x = level_sets(1, 61, 77, seed=4)
    k, tile = _geometry_tile(1, 61, 77, 20, "f64")
    got = twin(to_torch(x), 20, k, tile)[0]
    want = jreinit.reinit(jnp.asarray(x[0]), 20)
    assert_rel(got, np.asarray(want), 1e-10)


def test_passes_split_the_steps_evenly():
    assert _cuda.reinit_passes(20, 20) == [20]
    assert _cuda.reinit_passes(20, 10) == [10, 10]
    assert _cuda.reinit_passes(20, 5) == [5, 5, 5, 5]
    assert _cuda.reinit_passes(9, 5) == [5, 4]
    assert _cuda.reinit_passes(1, 5) == [1]
    for steps in range(1, 41):
        for k in range(1, 21):
            n = _cuda.reinit_passes(steps, k)
            assert sum(n) == steps and max(n) <= k
            assert len(n) == -(-steps // k) and max(n) - min(n) <= 1


# the geometry ---------------------------------------------------------------

SHAPES = [(1, 135, 240), (1, 270, 480), (1, 540, 960), (1, 1080, 1920),
          (1, 2160, 3840), (2, 1080, 1920), (2, 2160, 3840), (1, 1, 1),
          (1, 3, 700), (5, 24 + 40, 32 + 40), (1, 257, 131)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("steps", [1, 9, 20])
@pytest.mark.parametrize("shape", SHAPES)
def test_every_window_fits_its_block(shape, steps, itemsize):
    b, h, w = shape
    k, th, tw, px, py, rs = _cuda.reinit_geometry(b, h, w, steps, itemsize)
    assert 1 <= k <= steps and k in {min(d, steps)
                                     for d in _cuda.REINIT_DEPTHS}
    assert 1 <= rs <= _cuda.REINIT_ROWS
    assert px * py <= _cuda.REINIT_THREADS
    assert 1 <= th <= h and 1 <= tw <= w
    # the largest window (an interior one) and so every window
    assert min(th + 2 * k, h) <= py * rs and min(tw + 2 * k, w) <= px
    smem = _cuda.reinit_smem(h, w, k, th, tw, itemsize)
    assert smem <= _cuda.SMEM_LIMIT
    assert _cuda.reinit_blocks_per_sm(px * py, smem, itemsize) >= 1


@pytest.mark.parametrize("shape", [(1, 2160, 3840), (1, 1080, 1920),
                                   (2, 1080, 1920)])
def test_the_main_path_shapes_hold_two_blocks_an_sm_in_f32(shape):
    k, th, tw, px, py, rs = _cuda.reinit_geometry(*shape, 20, 4)
    smem = _cuda.reinit_smem(*shape[1:], k, th, tw, 4)
    assert _cuda.reinit_blocks_per_sm(px * py, smem, 4) >= 2


def test_reinit_launchers_have_their_signatures():
    src = (Path(_build._SRC) / "reinit.cu").read_text()
    decl = dict(re.findall(r'extern "C" cudaError_t (\w+)\(([^)]*)\)', src,
                           re.S))
    assert set(decl) == {"cv_reinit", "cv_reinit_occupancy"}
    for name, args in decl.items():
        assert len(args.split(",")) == len(_build.SIGNATURES[name]), name
