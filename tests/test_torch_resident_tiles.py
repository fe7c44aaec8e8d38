"""The tile bodies of the resident kernels (``csrc/resident_tiles.cuh``:
K7, K8 in every mode, and K13, its frozen-means mode; ``csrc/mp2.cuh``
``mp2_tile_kernel``: K9's resident mode, K10) checked on the CPU through a
plain PyTorch twin of their schedule, and on the card against their first
bodies' recorded outputs and their plain versions.

The kernel cuts the image into the tiles of
``_cuda.resident_tile_geometry``, one block each. A block keeps its tile,
padded by a one-cell ring, for the whole launch; a half-sweep writes the
active colour's new values to a second buffer and commits them after a
barrier; after each commit the block stores the new border cells in its
rim (one buffer per parity of the iteration); before the black half-sweep
it reads its four side neighbours' new red border cells into its ring, and
after the grid-wide step (the means) it fills the whole ring (sides and
the nw, ne, sw corners) from the rims. The twin does the same on tensors:
rims start as NaN (a read of a cell not yet published shows), blocks run
each phase one after another in block order (a legal interleaving of the
kernel's, in which a block that is ahead has already published its next
colour), reads clamp at the image edges through the padded tile, and the
means are the plain version's, from the tiles put together. It is held
bitwise against ``resident_iterations(_batch, _mc)_reference`` and
``mp2_resident_iterations_reference`` in the flat and the plane layout
(tiles loaded and stored at ``_cuda.plane_offset``), at ragged tilings; an
in-place half-sweep (the diagonals read after their update) is not
bitwise. K13's frozen mode has no grid-wide step before its last
iteration: after each black commit a block fills its whole ring from the
rims of the iteration, and the twin of that schedule is held bitwise
against ``packed_chunk_reference`` (f32 and f64, k = 1, 3, 8, both
layouts). A stack's frame groups (K7/K8 batch: group g of G runs frames g,
g + G, ... on its own tiles, rims, ticket, words and slots, the groups side
by side) have a twin held bitwise against the batch references with N not
a multiple of G, which notices a group on another group's rims or ticket.
The geometry is checked over the routing envelopes: every cell in
one tile, the shared-memory budget at one block an SM, u0 out of shared
memory exactly where the budget demands it; ``_cuda.frame_groups`` keeps a
single image on one group and fits a stack's groups to the card. The
``cuda``-marked tests hold
each body against its first body's recorded output
(tests/card_digests.json), its plain version, a second launch and a launch
on a second stream.
"""

import itertools

import numpy as np
import pytest
import torch

import chan_vese_tpu_torch as ct
from chan_vese_tpu_torch.models import multiphase as mpm
from chan_vese_tpu_torch.ops import _cuda
from chan_vese_tpu_torch.ops import multiphase_kernel as mk
from chan_vese_tpu_torch.ops import packed_kernel as pk
from chan_vese_tpu_torch.ops import resident_kernel as rk
from chan_vese_tpu_torch.ops.fused_kernel_mc import data_term_mc
from chan_vese_tpu_torch.ops.numerics import heaviside
from chan_vese_tpu_torch.ops.reductions import (data_term, means_from_sums,
                                                phase_means, region_means)
from chan_vese_tpu_torch.ops.sweep import _update_all
from chan_vese_tpu_torch.utils.init_phi import init_phi
from torch_port_helpers import assert_digest, cuda_device

SMS = _cuda.SMS


# the twin ------------------------------------------------------------------

class Tiles:
    """The schedule's state for an (h, w) image cut into th x tw tiles:
    each tile padded by a one-cell ring (NaN where unset), and the rims,
    (level sets, 2 parities, blocks, 2 (TH + TW)) floats, NaN until
    published."""

    def __init__(self, h, w, th, tw, levels, dtype):
        self.h, self.w, self.TH, self.TW = h, w, th, tw
        self.gy, self.gx = -(-h // th), -(-w // tw)
        self.len = 2 * (th + tw)
        nb = self.gy * self.gx
        self.rims = torch.full((levels, 2, nb, self.len), float("nan"),
                               dtype=dtype)
        self.tiles = []
        for b in range(nb):
            by, bx = divmod(b, self.gx)
            r0, c0 = by * th, bx * tw
            r1, c1 = min(r0 + th, h), min(c0 + tw, w)
            self.tiles.append(self._plan(b, by, bx, r0, r1, c0, c1, levels,
                                         dtype))

    def _plan(self, b, by, bx, r0, r1, c0, c1, levels, dtype):
        TH, TW = self.TH, self.TW
        t = dict(b=b, r0=r0, r1=r1, c0=c0, c1=c1)
        tr, tc = r1 - r0, c1 - c0
        t["S"] = [torch.full((tr + 2, tc + 2), float("nan"), dtype=dtype)
                  for _ in range(levels)]
        gi = torch.arange(r0, r1)[:, None].expand(tr, tc)
        gj = torch.arange(c0, c1)[None, :].expand(tr, tc)
        t["gi"], t["gj"] = gi, gj
        t["red"] = (gi + gj) % 2 == 0
        # the border: (tile cell, rim slot) pairs, a cell in every border
        # it lies on
        cells, slots = [], []
        for lr in range(tr):
            for lc in range(tc):
                for hit, slot in ((lr == 0, lc), (lr == tr - 1, TW + lc),
                                  (lc == 0, 2 * TW + lr),
                                  (lc == tc - 1, 2 * TW + TH + lr)):
                    if hit:
                        cells.append(lr * tc + lc)
                        slots.append(b * self.len + slot)
        t["border"] = (torch.tensor(cells), torch.tensor(slots))
        # the ring: (padded cell, the owner's rim slot, side, red)
        ring = []
        for k in range(tc):
            ring.append((-1, k, -1, 0, TW + k))
            ring.append((tr, k, 1, 0, k))
        for r in range(tr):
            ring.append((r, -1, 0, -1, 2 * TW + TH + r))
            ring.append((r, tc, 0, 1, 2 * TW + r))
        ring += [(-1, -1, -1, -1, 2 * TW - 1), (-1, tc, -1, 1, TW),
                 (tr, -1, 1, -1, TW - 1)]
        pos, src, side, red = [], [], [], []
        for lr, lc, dy, dx, off in ring:
            ny, nx = by + dy, bx + dx
            if not (0 <= ny < self.gy and 0 <= nx < self.gx):
                continue
            pos.append((lr + 1) * (tc + 2) + lc + 1)
            src.append((ny * self.gx + nx) * self.len + off)
            side.append(dy == 0 or dx == 0)
            red.append((r0 + lr + c0 + lc) % 2 == 0)
        t["ring"] = (torch.tensor(pos, dtype=torch.long),
                     torch.tensor(src, dtype=torch.long),
                     torch.tensor(side, dtype=torch.bool),
                     torch.tensor(red, dtype=torch.bool))
        # the clamped reads: padded row/col -> the padded tile's own index
        ri = torch.arange(r0 - 1, r1 + 1).clamp(0, self.h - 1) - (r0 - 1)
        ci = torch.arange(c0 - 1, c1 + 1).clamp(0, self.w - 1) - (c0 - 1)
        t["clamp"] = (ri, ci)
        return t

    # loads, stores, the image put together ---------------------------------

    def load(self, level, flat, packed):
        """Tile cells from a flat or plane-layout buffer; borders into the
        parity-1 rims (iteration 0's ring)."""
        for t in self.tiles:
            g = _gaddr(t["gi"], t["gj"], self.h, self.w, packed)
            t["S"][level][1:-1, 1:-1] = flat[g]
            self.publish(level, 1, t, torch.ones_like(t["red"]))

    def store(self, level, flat, packed):
        for t in self.tiles:
            g = _gaddr(t["gi"], t["gj"], self.h, self.w, packed)
            flat[g] = t["S"][level][1:-1, 1:-1]

    def image(self, level):
        out = torch.empty((self.h, self.w), dtype=self.rims.dtype)
        for t in self.tiles:
            out[t["r0"]:t["r1"], t["c0"]:t["c1"]] = t["S"][level][1:-1, 1:-1]
        return out

    # the rims ---------------------------------------------------------------

    def publish(self, level, par, t, mask):
        cells, slots = t["border"]
        keep = mask.reshape(-1)[cells]
        tile = t["S"][level][1:-1, 1:-1].reshape(-1)
        self.rims[level, par].view(-1)[slots[keep]] = tile[cells[keep]]

    def fill(self, level, par, t, red_only):
        pos, src, side, red = t["ring"]
        keep = side & red if red_only else torch.ones_like(side)
        t["S"][level].view(-1)[pos[keep]] = (
            self.rims[level, par].view(-1)[src[keep]])

    # a half-sweep -------------------------------------------------------------

    def padded(self, level, t, field=None):
        """The padded tile (or the image-sized ``field``'s window) with
        every out-of-image cell read clamped to the image."""
        ri, ci = t["clamp"]
        if field is not None:
            rows = (ri + t["r0"] - 1)
            cols = (ci + t["c0"] - 1)
            return field[rows][:, cols]
        return t["S"][level][ri][:, ci]

    def sweep(self, level, t, force, p, colour, inplace=False):
        """New values of the colour's cells (0 red, 1 black) from the
        padded tile, force ``force`` (image-sized); returns the tile with
        them, the tile itself untouched (the commit comes after). In
        place: row by row, each row's new values visible to the next."""
        mask = t["red"] if colour == 0 else ~t["red"]
        f = self.padded(level, t, force)
        if not inplace:
            upd = _update_all(self.padded(level, t), f, p.mu, p.dt, p.eps,
                              p.eta2)[1:-1, 1:-1]
            return torch.where(mask, upd, t["S"][level][1:-1, 1:-1])
        saved = t["S"][level].clone()
        for r in range(mask.shape[0]):
            upd = _update_all(self.padded(level, t), f, p.mu, p.dt, p.eps,
                              p.eta2)[1:-1, 1:-1]
            row = t["S"][level][1 + r, 1:-1]
            row[:] = torch.where(mask[r], upd[r], row)
        new = t["S"][level][1:-1, 1:-1].clone()
        t["S"][level] = saved
        return new

    def commit(self, level, par, t, new, colour):
        mask = t["red"] if colour == 0 else ~t["red"]
        t["S"][level][1:-1, 1:-1] = torch.where(
            mask, new, t["S"][level][1:-1, 1:-1])
        self.publish(level, par, t, mask)


def _gaddr(i, j, h, w, packed):
    return _cuda.plane_offset(i, j, h, w) if packed else i * w + j


def _layout(x, packed):
    return pk.pack_planes_reference(x).reshape(-1) if packed \
        else x.reshape(-1).clone()


def _unlayout(flat, h, w, packed):
    if packed:
        return pk.unpack_planes_reference(flat.reshape(2, 2, h // 2, w // 2))
    return flat.reshape(h, w)


def twin_two_phase(phi, channels, force, p, iters, unroll, nout, tiling,
                   packed=False, inplace=False):
    """The two-phase tile schedule on one image: phi (H, W), ``channels``
    the (H, W) image channels, ``force(c1, c2)`` the data term from (C,)
    means; returns (phi, rows (iters // unroll, nout)), the contract of
    ``resident_kernel.exact_iterations``."""
    h, w = phi.shape
    T = Tiles(h, w, *tiling, 1, phi.dtype)
    T.load(0, _layout(phi, packed), packed)
    n = torch.tensor(phi.numel(), dtype=phi.dtype)
    sum_u = torch.stack([torch.sum(u) for u in channels])
    zero = torch.zeros((), dtype=phi.dtype)
    rows = []
    for it in range(iters):
        par = it & 1
        old = T.image(0)
        hh = heaviside(old, p.eps)
        s_uh = [torch.sum(u * hh) for u in channels]
        s_h = torch.sum(hh)
        c1, c2 = means_from_sums(torch.stack(s_uh), s_h, sum_u, n)
        f = force(c1, c2)
        for colour in (0, 1):
            for t in T.tiles:  # each block in turn: its ring, sweep, commit
                T.fill(0, par ^ colour ^ 1, t, red_only=colour == 1)
                new = T.sweep(0, t, f, p, colour, inplace)
                T.commit(0, par, t, new, colour)
        new = T.image(0)
        if it % unroll == unroll - 1:
            d = new - old
            sums = s_uh + [s_h, torch.sum(d * d),
                           torch.sum(((new >= 0) != (old >= 0))
                                     .to(phi.dtype)),
                           torch.sum(torch.abs(d))]
            rows.append(torch.stack(sums + [zero] * (nout - len(sums))))
    out = torch.empty(h * w, dtype=phi.dtype)
    T.store(0, out, packed)
    return _unlayout(out, h, w, packed), torch.stack(rows)


def twin_mp2(phis, u0, p, iters, unroll, tiling, packed=False):
    """The 4-phase tile schedule (phi0 red; phi0 black with phi1 red; phi1
    black; the step), the contract of ``mp2_resident_iterations``."""
    h, w = u0.shape
    T = Tiles(h, w, *tiling, 2, u0.dtype)
    for m in (0, 1):
        T.load(m, _layout(phis[m], packed), packed)
    zero = torch.zeros((), dtype=u0.dtype)
    rows = []

    def forces(cs):
        d0, d1, d2, d3 = [(u0 - cs[s]) ** 2 for s in range(4)]
        return (lambda ph1: -p.nu + (1.0 - heaviside(ph1, p.eps)) * (d0 - d1)
                + heaviside(ph1, p.eps) * (d2 - d3),
                lambda ph0n: -p.nu + (1.0 - heaviside(ph0n, p.eps))
                * (d0 - d2) + heaviside(ph0n, p.eps) * (d1 - d3))

    for it in range(iters):
        par = it & 1
        old0, old1 = T.image(0), T.image(1)
        cs = torch.stack(phase_means(u0, (old0, old1), p.eps))
        f0_of, f1_of = forces(cs)
        f0 = f0_of(old1)
        for t in T.tiles:  # (b) phi0 red
            T.fill(0, par ^ 1, t, False)
            T.fill(1, par ^ 1, t, False)
            T.commit(0, par, t, T.sweep(0, t, f0, p, 0), 0)
        for t in T.tiles:  # (c) phi0 black, phi1 red
            T.fill(0, par, t, True)
            new0 = T.sweep(0, t, f0, p, 1)
            # phi1's force from the tile's new red phi0 (pointwise)
            new1 = T.sweep(1, t, f1_of(T.image(0)), p, 0)
            T.commit(0, par, t, new0, 1)
            T.commit(1, par, t, new1, 0)
        new0 = T.image(0)
        f1 = f1_of(new0)
        for t in T.tiles:  # (d) phi1 black
            T.fill(1, par, t, True)
            T.commit(1, par, t, T.sweep(1, t, f1, p, 1), 1)
        new1 = T.image(1)
        if it % unroll == unroll - 1:
            d0, d1 = new0 - old0, new1 - old1
            rows.append(torch.stack(
                [mk.label_flips(new0, new1, old0, old1),
                 torch.sum(d0 * d0 + d1 * d1)] + [zero] * 6))
    out = torch.empty(2 * h * w, dtype=u0.dtype)
    for m in (0, 1):
        T.store(m, out[m * h * w:(m + 1) * h * w], packed)
    return (torch.stack([_unlayout(out[m * h * w:(m + 1) * h * w], h, w,
                                   packed) for m in (0, 1)]),
            torch.stack(rows))


class ScheduleFault(AssertionError):
    """A block of the grouped twin read its group's words under another
    tag than the step it waits for: the kernel would spin there."""


def twin_grouped(phis, u0s, p, iters, tiling, groups, packed=False,
                 fault=None):
    """K7/K8 batch's frame-group schedule: the stack's frames dealt to
    ``groups`` groups (group g runs frames g, g + G, ...), each group's
    blocks on the tiles of one frame with the group's own rims, ticket,
    words and slots. The groups run side by side: their phases (a frame's
    load, a half-sweep, a step) interleave round-robin and no group waits
    on another. At a step each block posts its tile to its slot and takes
    the group's ticket; the block that takes it last puts the frame
    together from the slots in block order, computes the next means and
    the frame's row, and publishes them tagged with the step; the others
    read them, and a read under another tag is a ScheduleFault. ``fault``:
    'rims' (group 0 reads and writes group 1's rims) or 'ticket' (one
    ticket for every group). Returns (phis, rows (N, 8)), the contract of
    ``resident_iterations_batch_reference``."""
    n, h, w = phis.shape
    T = [Tiles(h, w, *tiling, 1, phis.dtype) for _ in range(groups)]
    if fault == "rims":
        T[0].rims = T[1].rims
    nb = len(T[0].tiles)
    tickets = [0] * groups
    words = [(0, None)] * groups
    slots = [[None] * nb for _ in range(groups)]
    outs, rows = [None] * n, [None] * n
    zero = torch.zeros((), dtype=phis.dtype)
    n_pix = torch.tensor(h * w, dtype=phis.dtype)

    def step(g, k, u, old, last):
        """Step k of group g: the means of the frame's phi and, where
        ``last``, the row of the iteration that left it (from ``old``)."""
        for b, t in enumerate(T[g].tiles):
            slots[g][b] = t["S"][0][1:-1, 1:-1].clone()
            q = 0 if fault == "ticket" else g
            tickets[q] += 1
            if tickets[q] != (k + 1) * nb:
                continue
            new = torch.empty((h, w), dtype=phis.dtype)
            for tb, sl in zip(T[g].tiles, slots[g]):
                new[tb["r0"]:tb["r1"], tb["c0"]:tb["c1"]] = sl
            hh = heaviside(new, p.eps)
            sums = [torch.sum(u * hh), torch.sum(hh)]
            c1, c2 = means_from_sums(sums[0].reshape(1), sums[1],
                                     torch.sum(u).reshape(1), n_pix)
            row = None
            if last:
                d = new - old
                row = [torch.sum(d * d),
                       torch.sum(((new >= 0) != (old >= 0)).to(phis.dtype)),
                       torch.sum(torch.abs(d))]
            words[g] = (k + 1, (c1, c2, sums, row))

    def read(g, k):
        tag, value = words[g]
        if tag != k + 1:
            raise ScheduleFault(f"group {g} waits for step {k}, reads {tag}")
        return value

    def group(g):
        k = 0
        for fr in range(g, n, groups):
            u = u0s[fr]
            T[g].load(0, _layout(phis[fr], packed), packed)
            step(g, k, u, None, False)
            yield
            for it in range(iters):
                par = it & 1
                c1, c2, carry, _ = read(g, k)
                k += 1
                f = data_term(u, c1[0], c2[0], p.nu, p.lambda1, p.lambda2)
                old = T[g].image(0)
                for colour in (0, 1):
                    for t in T[g].tiles:
                        T[g].fill(0, par ^ colour ^ 1, t,
                                  red_only=colour == 1)
                        T[g].commit(0, par, t, T[g].sweep(0, t, f, p, colour),
                                    colour)
                    yield
                step(g, k, u, old, it == iters - 1)
                yield
            row = read(g, k)[3]
            k += 1
            rows[fr] = torch.stack(carry + row + [zero] * 3)
            out = torch.empty(h * w, dtype=phis.dtype)
            T[g].store(0, out, packed)
            outs[fr] = _unlayout(out, h, w, packed)

    running = [group(g) for g in range(groups)]
    while running:
        for gen in list(running):
            try:
                next(gen)
            except StopIteration:
                running.remove(gen)
    return torch.stack(outs), torch.stack(rows)


def twin_frozen(phi, u, c1, c2, p, k, tiling, packed=False):
    """K13's schedule (the frozen-means mode): the force from the fixed
    means, k iterations of the two barriered half-sweeps, the red-only
    ring before the black one, the whole ring from the iteration's rims
    after its black commit (no grid-wide step), and the partials of the
    last iteration; the contract of ``packed_chunk``."""
    h, w = phi.shape
    T = Tiles(h, w, *tiling, 1, phi.dtype)
    T.load(0, _layout(phi, packed), packed)
    f = data_term(u, c1, c2, p.nu, p.lambda1, p.lambda2)
    for it in range(k):
        par = it & 1
        old = T.image(0)
        for colour in (0, 1):
            for t in T.tiles:
                T.fill(0, par ^ colour ^ 1, t, red_only=colour == 1)
                T.commit(0, par, t, T.sweep(0, t, f, p, colour), colour)
    new = T.image(0)
    hh, d = heaviside(new, p.eps), new - old
    zero = torch.zeros((), dtype=phi.dtype)
    row = torch.stack([torch.sum(u * hh), torch.sum(hh), torch.sum(d * d),
                       torch.sum(((new >= 0) != (old >= 0)).to(phi.dtype)),
                       torch.sum(torch.abs(d))] + [zero] * 3)
    out = torch.empty(h * w, dtype=phi.dtype)
    T.store(0, out, packed)
    return _unlayout(out, h, w, packed), row


# inputs --------------------------------------------------------------------

def _image(h, w, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w]
    img = np.where(np.hypot(i - 0.4 * h, j - 0.55 * w) < 0.3 * min(h, w),
                   200.0, 50.0) + 10.0 * rng.standard_normal((h, w))
    return torch.from_numpy(img).to(dtype)


P = ct.CVParams()
# ragged tilings of a 24 x 40 image (rows 7+7+7+3, cols 12+12+12+4), square
# and one-row tiles, one tile
TILINGS = ((7, 12), (6, 10), (1, 8), (24, 40))


def _gray_twin(phi, u, tiling, packed=False, inplace=False, iters=4,
               unroll=2):
    return twin_two_phase(
        phi, (u,), lambda c1, c2: data_term(u, c1[0], c2[0], P.nu,
                                            P.lambda1, P.lambda2),
        P, iters, unroll, 8, tiling, packed, inplace)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("start", ["checkerboard", "circle"])
def test_twin_is_bitwise_resident_reference(tiling, packed, start):
    u = _image(24, 40)
    phi = init_phi((24, 40), start, torch.float32)
    got = _gray_twin(phi, u, tiling, packed)
    want = rk.resident_iterations_reference(phi, u, P, 4, unroll=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_twin_is_bitwise_in_float64():
    u = _image(24, 40, 3, torch.float64)
    phi = init_phi((24, 40), "checkerboard", torch.float64)
    got = _gray_twin(phi, u, (7, 12))
    want = rk.resident_iterations_reference(phi, u, P, 4, unroll=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("packed", [False, True])
def test_twin_is_bitwise_batch_reference(packed):
    frames = torch.stack([_image(24, 40, s) for s in range(3)])
    phis = init_phi((24, 40), "checkerboard", torch.float32).expand(
        3, 24, 40).contiguous()
    outs = [_gray_twin(phi, u, (7, 12), packed, iters=3, unroll=1)
            for phi, u in zip(phis, frames)]
    want = rk.resident_iterations_batch_reference(phis, frames, P, 3)
    assert torch.equal(torch.stack([o[0] for o in outs]), want[0])
    assert torch.equal(torch.stack([o[1][-1] for o in outs]), want[1])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("c", [1, 3, 8])
def test_twin_is_bitwise_mc_reference(c, packed):
    ucf = torch.stack([_image(24, 40, s) * (1.0 + 0.1 * s)
                       for s in range(c)])
    phi = init_phi((24, 40), "checkerboard", torch.float32)
    lam = (tuple(1.0 + 0.1 * k for k in range(c)),
           tuple(1.1 - 0.05 * k for k in range(c)))
    l1, l2 = P.channel_lambdas(c, *lam)
    got = twin_two_phase(
        phi, tuple(ucf), lambda c1, c2: data_term_mc(ucf, c1, c2, P, l1, l2),
        P, 3, 1, c + 4, (7, 12), packed)
    want = rk.resident_iterations_mc_reference(phi, ucf, P, 3, *lam)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_in_place_half_sweep_is_not_bitwise():
    """The diagonal trap: updating the active colour in place lets a cell
    read its nw/ne neighbours' new values; with the second buffer the
    twin is bitwise (above), in place it is not, even in one iteration."""
    u = _image(24, 40)
    phi = init_phi((24, 40), "checkerboard", torch.float32)
    want = rk.resident_iterations_reference(phi, u, P, 1)
    got = _gray_twin(phi, u, (7, 12), inplace=True, iters=1, unroll=1)
    assert not torch.equal(got[0], want[0])
    assert float((got[0] - want[0]).abs().max()) > 1e-3


def _stack(n, dtype=torch.float32):
    frames = torch.stack([_image(24, 40, s, dtype) for s in range(n)])
    starts = [init_phi((24, 40), "circle" if s % 2 else "checkerboard",
                       dtype) for s in range(n)]
    return torch.stack(starts), frames


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,groups", [(3, 2), (8, 4), (9, 4)])
def test_grouped_twin_is_bitwise_batch_reference(n, groups, packed):
    """Frames dealt to groups side by side (n not a multiple of G, so the
    groups run different numbers of frames) give each frame's phi and row
    bitwise the plain batch version's, in both layouts."""
    phis, frames = _stack(n)
    got = twin_grouped(phis, frames, P, 3, (7, 12), groups, packed)
    ref = (pk.packed_resident_iterations_batch_reference if packed
           else rk.resident_iterations_batch_reference)
    want = ref(phis, frames, P, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_grouped_twin_notices_a_group_on_another_groups_rims():
    """Group 0 on group 1's rims reads group 1's frame in its ring."""
    phis, frames = _stack(4)
    got = twin_grouped(phis, frames, P, 3, (7, 12), 2, fault="rims")
    want = rk.resident_iterations_batch_reference(phis, frames, P, 3)
    assert not torch.equal(got[0], want[0])


def test_grouped_twin_notices_groups_on_one_ticket():
    """With one ticket for every group the last block of a group's step
    is not the one the ticket names, so no one publishes its means and
    its blocks would wait for ever: the twin raises at the read."""
    phis, frames = _stack(4)
    with pytest.raises(ScheduleFault):
        twin_grouped(phis, frames, P, 3, (7, 12), 2, fault="ticket")


def test_twin_notices_a_schedule_fault():
    """A ring filled from the wrong parity's rims (the buffer the
    neighbours are writing this iteration) breaks the twin: the schedule,
    not the arithmetic, is what the twin checks."""
    u = _image(24, 40)
    phi = init_phi((24, 40), "circle", torch.float32)
    saved = Tiles.fill

    def wrong(self, level, par, t, red_only):
        return saved(self, level, par if red_only else par ^ 1, t, red_only)

    Tiles.fill = wrong
    try:
        got = _gray_twin(phi, u, (7, 12), iters=3, unroll=1)
    finally:
        Tiles.fill = saved
    want = rk.resident_iterations_reference(phi, u, P, 3)
    assert not torch.equal(got[0], want[0])


def _frozen_inputs(dtype, start="checkerboard", seed=0):
    u = _image(24, 40, seed, dtype)
    phi = init_phi((24, 40), start, dtype)
    c1, c2 = means_from_sums(
        torch.sum(u * heaviside(phi, P.eps)).reshape(1),
        torch.sum(heaviside(phi, P.eps)), torch.sum(u).reshape(1),
        torch.tensor(float(phi.numel()), dtype=dtype))
    return phi, u, c1[0], c2[0]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frozen_twin_is_bitwise_packed_chunk_reference(tiling, packed, k,
                                                       dtype):
    phi, u, c1, c2 = _frozen_inputs(dtype, "circle" if k == 3 else
                                    "checkerboard", seed=k)
    got = twin_frozen(phi, u, c1, c2, P, k, tiling, packed)
    want = pk.packed_chunk_reference(phi, u, c1, c2, P, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_frozen_twin_notices_a_schedule_fault():
    """Without a grid-wide step the whole ring must come from the rims of
    the iteration just committed: read from the other parity's (the
    iteration before), the frozen twin is not bitwise."""
    phi, u, c1, c2 = _frozen_inputs(torch.float32, "circle")
    saved = Tiles.fill

    def stale(self, level, par, t, red_only):
        return saved(self, level, par if red_only else par ^ 1, t, red_only)

    Tiles.fill = stale
    try:
        got = twin_frozen(phi, u, c1, c2, P, 3, (7, 12))
    finally:
        Tiles.fill = saved
    want = pk.packed_chunk_reference(phi, u, c1, c2, P, 3)
    assert not torch.equal(got[0], want[0])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tiling", [(7, 12), (5, 6), (24, 40)])
def test_twin_is_bitwise_mp2_reference(tiling, packed):
    u = _image(24, 40, 5)
    phis = mpm.init_multiphase((24, 40), 2)
    got = twin_mp2(phis, u, P, 4, 2, tiling, packed)
    want = mk.mp2_resident_iterations_reference(phis, u, P, 4, unroll=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the geometry --------------------------------------------------------------

# shapes of the main path and ragged or tiny ones (channels, level sets)
GEOMETRY_CASES = [
    (256, 256, 0, 1), (512, 512, 3, 1), (1024, 1024, 0, 1), (8, 128, 0, 1),
    (512, 384, 0, 2), (1024, 896, 0, 1), (250, 398, 0, 1), (512, 512, 0, 2),
    (1024, 1024, 0, 2), (16, 256, 8, 1), (1000, 1002, 0, 2), (2, 2, 0, 1),
]


@pytest.mark.parametrize("h,w,c,levels", GEOMETRY_CASES)
@pytest.mark.parametrize("per_sm", [1, 2])
def test_geometry_tiles_cover_every_cell_once(h, w, c, levels, per_sm):
    th, tw, gx, gy, u0res, smem = _cuda.resident_tile_geometry(
        h, w, c, levels, SMS, per_sm)
    assert tw % 2 == 0 and th >= 1
    assert gx * gy <= SMS * per_sm
    assert gx * gy <= max(1, h * w // 2 // _cuda.TILE_THREADS)
    count = torch.zeros((h, w), dtype=torch.int32)
    for by, bx in itertools.product(range(gy), range(gx)):
        r0, c0 = by * th, bx * tw
        assert r0 < h and c0 < w  # no empty tile
        count[r0:r0 + th, c0:c0 + tw] += 1
    assert bool((count == 1).all())
    assert smem == _cuda.tile_smem_bytes(th, tw, c, levels, u0res)
    assert smem <= _cuda.tile_budget(per_sm)


def _envelope(pred, step_w, step_h):
    """(h, w) at the edge of a routing predicate: for each width, the
    tallest height it takes."""
    out = []
    for w in range(step_w, 4097, step_w):
        hs = [h for h in range(step_h, 4097, step_h) if pred(h, w)]
        if hs:
            out.append((max(hs), w))
    return out


ENVELOPES = {
    "K7": (rk.supports_resident, 128, 8, 0, 1),
    "K8": (pk.supports_packed_resident, 256, 16, 0, 1),
    "K9": (mk.supports_mp2_resident, 128, 8, 0, 2),
    "K10": (pk.supports_packed_mp2_resident, 256, 16, 0, 2),
    "K13": (pk.supports_packed, 256, 16, 0, 1),
    **{f"K7 mc C={c}": (lambda h, w, c=c: rk.supports_resident_mc(h, w, c),
                        128, 8, c, 1) for c in range(1, 9)},
    **{f"K8 mc C={c}": (lambda h, w, c=c: pk.supports_packed_resident_mc(
        h, w, c), 256, 16, c, 1) for c in range(1, 9)},
}


@pytest.mark.parametrize("name", list(ENVELOPES))
def test_geometry_budget_holds_over_the_routing_envelope(name):
    """At one block an SM every shape the reference routes to the kernel
    fits (batch frames take the scalar geometry); u0 leaves shared memory
    exactly where the level sets and it would exceed the budget."""
    pred, sw, sh, c, levels = ENVELOPES[name]
    budget = _cuda.tile_budget(1)
    shapes = _envelope(pred, sw, sh)
    assert shapes
    for h, w in shapes:
        th, tw, gx, gy, u0res, smem = _cuda.resident_tile_geometry(
            h, w, c, levels, SMS, 1)
        assert gx * gy <= SMS and smem <= budget
        with_u0 = _cuda.tile_smem_bytes(th, tw, c, levels, True)
        assert u0res == (with_u0 <= budget), (h, w)


@pytest.mark.parametrize("name", [k for k, v in ENVELOPES.items()
                                  if v[4] == 1])
def test_frame_groups_keep_one_frame_on_one_group(name):
    """A single image (K7/K8 scalar and mc, K13's shapes) is one group on
    the whole grid: today's geometry."""
    pred, sw, sh, c, _ = ENVELOPES[name]
    for h, w in _envelope(pred, sw, sh):
        assert _cuda.frame_groups(1, h, w, c, SMS) == (
            1, _cuda.resident_tile_geometry(h, w, c, 1, SMS)), (h, w)


# stacks (frames, h, w, channels) and SM counts
GROUP_CASES = [
    (256, 512, 512, 0, SMS), (9, 256, 256, 0, SMS), (3, 24, 40, 0, SMS),
    (16, 1024, 1024, 0, SMS), (5, 250, 398, 0, SMS), (4, 256, 384, 0, SMS),
    (7, 512, 512, 3, SMS), (256, 512, 512, 0, 114), (200, 2, 2, 0, SMS),
    (2, 1152, 1152, 0, SMS),
]


@pytest.mark.parametrize("n,h,w,c,sms", GROUP_CASES)
def test_frame_groups_cover_each_frame_once_within_the_card(n, h, w, c,
                                                            sms):
    """G groups of B blocks fit the card (G B <= SMs, at most one group a
    frame); each group's tiles cover a frame once; a block's shared memory
    fits at one an SM, with u0 in it wherever G > 1."""
    g, geo = _cuda.frame_groups(n, h, w, c, sms)
    th, tw, gx, gy, u0res, smem = geo
    assert 1 <= g <= min(n, sms) and g * gx * gy <= sms
    assert geo == _cuda.resident_tile_geometry(h, w, c, 1, sms // g)
    count = torch.zeros((h, w), dtype=torch.int32)
    for by, bx in itertools.product(range(gy), range(gx)):
        assert by * th < h and bx * tw < w
        count[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw] += 1
    assert bool((count == 1).all())
    assert smem <= _cuda.tile_budget(1)
    assert u0res or g == 1


def test_frame_groups_of_the_benchmark_stack():
    """256 frames of 512^2 on 132 SMs: the G of PERF.md's K8 batch row,
    the largest that keeps u0 in shared memory (12 groups would not)."""
    g, (th, tw, gx, gy, u0res, smem) = _cuda.frame_groups(256, 512, 512, 0,
                                                          132)
    assert (g, gx * gy, th, tw, u0res) == (11, 12, 171, 128, True)
    assert not _cuda.resident_tile_geometry(512, 512, 0, 1, 132 // 12)[4]


def test_geometry_sends_u0_through_l2_only_where_needed():
    # the mc envelope's edge at C = 8 keeps u0 (216 KB a block); eight
    # channels of a 1024^2 image (past the envelope) do not fit beside phi
    # and go through L2; at two blocks an SM the tiles halve with the budget
    assert _cuda.resident_tile_geometry(640, 1152, 8, 1, SMS, 1)[4]
    th, tw, _, _, u0res, smem = _cuda.resident_tile_geometry(1024, 1024, 8)
    assert not u0res and smem == _cuda.tile_smem_bytes(th, tw, 8, 1, False)
    assert _cuda.tile_smem_bytes(th, tw, 8, 1, True) > _cuda.tile_budget(1)
    assert _cuda.resident_tile_geometry(640, 1152, 8, 1, SMS, 2)[4]


def test_geometry_refuses_what_no_block_holds():
    with pytest.raises(ValueError):
        _cuda.resident_tile_geometry(4096, 4096, 0, 2, SMS, 1)
    with pytest.raises(ValueError):
        _cuda.resident_tile_geometry(64, 63, 0, 1)
    with pytest.raises(ValueError):
        _cuda.resident_tile_geometry(64, 64, 0, 3)


def test_launchers_signatures():
    from chan_vese_tpu_torch import _build
    for s in _build.RESIDENT_SYMBOLS:
        assert len(_build.SIGNATURES[s]) == 34
        assert len(_build.SIGNATURES[f"{s}_grid"]) == 3
    for s in _build.MP2_RESIDENT_SYMBOLS:
        assert len(_build.SIGNATURES[s]) == 25
        assert len(_build.SIGNATURES[f"{s}_grid"]) == 3


def test_chunk_launchers_signatures():
    """K13's launchers on the tile body (8 pointers, 9 ints, 9 params, the
    stream; `_grid` the tile bodies' query)."""
    from chan_vese_tpu_torch import _build
    for s in _build.CHUNK_SYMBOLS:
        assert len(_build.SIGNATURES[s]) == 27
        assert _build.SIGNATURES[f"{s}_grid"] == _build.SIGNATURES[
            "cv_resident_iterations_grid"]


# on the card: the tile bodies against their first bodies' outputs ----------

def _card(x):
    return x.to(cuda_device()).contiguous()


MODES = {
    "K7": (rk.resident_iterations, 0), "K8": (pk.packed_resident_iterations, 0),
    "K7 batch": (rk.resident_iterations_batch, 0),
    "K8 batch": (pk.packed_resident_iterations_batch, 0),
    "K7 mc": (rk.resident_iterations_mc, 3),
    "K8 mc": (pk.packed_resident_iterations_mc, 3),
}


def _mode_args(name, h, w, start):
    u = _card(_image(h, w))
    phi = _card(init_phi((h, w), start, torch.float32))
    if "batch" in name:
        return (phi.expand(3, h, w).contiguous(),
                torch.stack([u, 0.5 * u + 20.0, 255.0 - u]))
    if "mc" in name:
        return phi, torch.stack([u, 0.5 * u + 20.0, 255.0 - u])
    return phi, u


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODES))
@pytest.mark.parametrize("shape", [(256, 256), (512, 512), (1024, 1024)])
def test_tiles_cuda_two_phase_match_first_body_and_plain(name, shape):
    """phi and the flips bitwise their recorded output (the first body's
    wherever the f32 means agreed: the f64 sums behind them are added in
    another order); the plain version at its bars; a second launch
    bitwise."""
    fn, _ = MODES[name]
    args = _mode_args(name, *shape, "checkerboard")
    new, parts = fn(*args, P, 1)
    again, parts2 = fn(*args, P, 1)
    want, wparts = fn(*(a.cpu() for a in args), P, 1)
    torch.cuda.synchronize()
    assert torch.equal(new, again) and torch.equal(parts, parts2)
    flips = 3 if "mc" not in name else 3 + 2  # [s_uH x C, s_H, d2, flips]
    assert_digest(f"{name} tiles {shape}", new, parts[:, flips])
    torch.testing.assert_close(new.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(parts.cpu(), wparts, rtol=1e-4, atol=16.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [
    ("K9", (512, 512)), ("K9", (1024, 1024)), ("K9", (512, 384)),
    ("K10", (256, 256)), ("K10", (512, 512))])
def test_tiles_cuda_mp2_match_first_body_and_plain(name, shape):
    """One iteration and 25 (rows every 5) bitwise their recorded outputs;
    one iteration within the bars of the plain version; a second launch
    bitwise."""
    fn = mk.mp2_resident_iterations if name == "K9" else \
        pk.packed_mp2_resident_iterations
    u = _card(_image(*shape))
    phis = _card(mpm.init_multiphase(shape, 2))
    new, parts = fn(phis, u, P, 1)
    want, _ = fn(phis.cpu(), u.cpu(), P, 1)
    again, _ = fn(phis, u, P, 1)
    torch.cuda.synchronize()
    assert torch.equal(new, again)
    assert_digest(f"{name} tiles {shape}", new, parts[:, 0])
    torch.testing.assert_close(new.cpu(), want, rtol=3e-4, atol=2e-3)
    n25, p25 = fn(phis, u, P, 25, unroll=5)
    torch.cuda.synchronize()
    assert_digest(f"{name} tiles {shape} 25", n25, p25[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape", [(512, 512), (1024, 1024), (720, 1280)])
def test_tiles_cuda_frozen_chunk_matches_first_body_and_plain(shape, packed):
    """K13 on the tile body: phi and the flips bitwise its first body's
    recorded output at k = 1, 3, 8 (the means are frozen), the partials
    within phase 3's bars of the plain version (f64 sums in tile order), a
    second launch and a launch on a second stream bitwise; one iteration's
    phi within phase 3's bars of the plain version. Deeper chunks are held to
    the plain version on the smoke's images (phase 15) and by
    test_torch_layout.py: from this noisier image the f32 trajectory of
    either body leaves those bars at up to 2.4e-4 of the cells by k = 8
    (last-ulp differences of rsqrtf and FMA contraction, amplified)."""
    u = _card(_image(*shape))
    phi = _card(init_phi(shape, "circle", torch.float32))
    c1, c2 = region_means(u, phi, P.eps)
    n0 = dict(pk.packed_chunk.launches)
    for k in (1, 3, 8):
        new = pk.packed_chunk(phi, u, c1, c2, P, k, packed=packed)
        again = pk.packed_chunk(phi, u, c1, c2, P, k, packed=packed)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            second = pk.packed_chunk(phi, u, c1, c2, P, k, packed=packed)
        want = pk.packed_chunk_reference(phi, u, c1, c2, P, k)
        torch.cuda.synchronize()
        layout = "packed" if packed else "flat"
        assert_digest(f"K13 {layout} {shape} k={k}", new[0], new[1][3:4])
        assert torch.equal(new[0], again[0]) and torch.equal(new[1],
                                                             again[1])
        assert torch.equal(new[0], second[0]) and torch.equal(new[1],
                                                              second[1])
        torch.testing.assert_close(new[1], want[1], rtol=1e-4, atol=16.0)
        if k == 1:
            torch.testing.assert_close(new[0], want[0], rtol=1e-4,
                                       atol=1e-4)
    assert pk.packed_chunk.launches[layout] == n0[layout] + 3 * 3


@pytest.mark.cuda
def test_tiles_cuda_second_stream_is_bitwise():
    u = _card(_image(512, 512))
    phi = _card(init_phi((512, 512), "circle", torch.float32))
    phis = _card(mpm.init_multiphase((512, 512), 2))

    def run():
        return (*pk.packed_resident_iterations(phi, u, P, 16),
                *rk.resident_iterations(phi, u, P, 16),
                *mk.mp2_resident_iterations(phis, u, P, 8))

    first = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_tiles_cuda_refuse_a_wrong_tiling():
    from chan_vese_tpu_torch import _build
    dev = cuda_device()
    phi = torch.zeros((256, 256), device=dev)
    th, tw, gx, gy, u0res, smem = _cuda.resident_tile_geometry(256, 256)
    lib = _build.library()
    usum = torch.zeros(1, dtype=torch.float64, device=dev)
    words = torch.zeros(4096, dtype=torch.int64, device=dev)
    # (TH, TW, GX, blocks, dynamic bytes, frame groups); two groups of one
    # image (not a stack) are refused too
    for bad in ((th, tw, gx, gx * gy + 1, smem, 1),
                (th, tw + 1, gx, gx * gy, smem, 1),
                (th, tw, gx, gx * gy, smem + 4, 1),
                (th, tw, gx, 2 * gx * gy, smem, 2)):
        err = lib.cv_resident_iterations(
            phi.data_ptr(), phi.data_ptr(), phi.data_ptr(), usum.data_ptr(),
            None, words.data_ptr(), words.data_ptr(), words.data_ptr(),
            phi.data_ptr(), bad[3], 1, 256, 256, 0, 1, 1, 0,
            8, bad[0], bad[1], bad[2], int(u0res), bad[4], bad[5],
            *([1.0] * 9), torch.cuda.current_stream().cuda_stream)
        assert err != 0
