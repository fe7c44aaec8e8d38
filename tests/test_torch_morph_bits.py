"""The bit-packed morphological body (``csrc/morph_bits.cuh``: K11's kinds
acwe, gac, gac_pre, acwe_sh, gac_pre_sh and K12) checked on the CPU
through a plain PyTorch word-level twin of it, and on the card against
its first body.

The kernel cuts the image (or a shard block's crop) into the tiles of
``_cuda.morph_geometry``; each tile's window (the tile plus the halo each
way, cut at the clamp box, in whole 32-cell words) is packed 32 cells a
word, the force signs or the GAC attraction as bit planes, and the ops run
on words with funnel-shift neighbors, reads clamped at the window's sides,
op i on the window rows at least i cells from a side that is not the box's
edge. The twin does the same on int64 tensors of 32-bit words, its second
state buffer filled with random words (so a stale row that reached the
tile would show), and is held:

- bitwise against ``morph_chunk_reference``, ``gac_chunk_reference``
  (balloons -1, 0, 1; ``pre_dg`` both ways), ``morph_chunk_fused_reference``
  (n_in exact, sum_in to the f64 sum's rounding) and the two shard
  references (the replica ring refreshed before every op) on every shard
  of 2x2 and 3x3 grids, at widths that are not multiples of 32, every
  parity0 and k = 1 ... 8;
- at three shapes against the JAX package's ``morph_chunk``, ``gac_chunk``
  and ``morph_chunk_fused`` in interpret mode.

The GAC sign-plane identity (four pairs' signs carry the nine products'
rounded sums) is checked over special float32 values; ``morph_geometry``
at the main path's shapes and on ragged ones. The ``cuda``-marked tests
hold each kind bitwise against its first body (the ``_v1`` launchers), its
plain version and a launch on a second stream.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.ops import pallas_morph as jpm
from chan_vese_tpu_torch.ops import _cuda
from chan_vese_tpu_torch.ops import morph_kernel as tmk
from chan_vese_tpu_torch.ops.morph import binary_means
from torch_port_helpers import cuda_device, to_np

F32 = np.float32
M32 = 0xFFFFFFFF
_BIT = torch.arange(32, dtype=torch.int64)


# the twin ----------------------------------------------------------------

def pack(x, ww):
    """(rows, n) bools -> (rows, ww) words of 32 cells, bit b of word j the
    cell 32 j + b; cells past n take the last column's value."""
    cols = torch.arange(32 * ww).clamp(max=x.shape[1] - 1)
    return (x[:, cols].reshape(x.shape[0], ww, 32).to(torch.int64)
            << _BIT).sum(-1)


def unpack(words, n):
    """(rows, ww) words -> (rows, n) bools."""
    b = (words[..., None] >> _BIT) & 1
    return b.reshape(words.shape[0], -1)[:, :n].bool()


def shifted(x, emask):
    """(left, word, right) neighbor words of every window word: the left
    and right cells come in by funnel shift from the neighbor words,
    clamped at the window's sides (bit 0 replicated on the left, bit 31 on
    the right); ``emask`` (a word a column) the bit of the box's last
    column, whose right neighbor is itself."""
    lw = torch.cat([(x[:, :1] << 31) & M32, x[:, :-1]], 1)
    rw = torch.cat([x[:, 1:], x[:, -1:] >> 31], 1)
    left = ((x << 1) & M32) | (lw >> 31)
    right = (x >> 1) | ((rw << 31) & M32)
    return left, x, right ^ ((right ^ x) & emask)


def rows_about(t):
    """(above, below) of every row, clamped at the window's top and
    bottom."""
    return torch.cat([t[:1], t[:-1]]), torch.cat([t[1:], t[-1:]])


def sup_inf(a, c, b):
    return c[1] & ((c[0] & c[2]) | (a[1] & b[1]) | (a[0] & b[2])
                   | (a[2] & b[0]))


def inf_sup(a, c, b):
    return c[1] | ((c[0] | c[2]) & (a[1] | b[1]) & (a[0] | b[2])
                   & (a[2] | b[0]))


def acwe_update(a, c, b, neg, pos):
    g = (a[1] ^ b[1]) | (c[0] ^ c[2])
    return (c[1] & ~(g & (neg | pos)) & M32) | (g & neg)


def balloon_update(a, c, b, mask, grow):
    d = a + c + b
    acc = d[0]
    for t in d[1:]:
        acc = (acc | t) if grow else (acc & t)
    return (c[1] & ~mask & M32) | (acc & mask)


def attraction_update(a, c, b, att):
    """The attraction on words from the eight sign planes (A+, A-, B+, B-,
    C+, C-, D+, D-) of the pairs (1/2, 0), (0, 1/2), (1/2, 1/2),
    (1/2, -1/2): a pair's negation takes the other plane."""
    up, dn, lf, rt = a[1], b[1], c[0], c[2]
    xp, xn, xz = dn & ~up & M32, up & ~dn & M32, ~(up ^ dn) & M32
    yp, yn, yz = rt & ~lf & M32, lf & ~rt & M32, ~(lf ^ rt) & M32
    sel = [(xp & yz, xn & yz), (xz & yp, xz & yn), (xp & yp, xn & yn),
           (xp & yn, xn & yp)]
    one = zero = 0
    for q, (pq, nq) in enumerate(sel):
        one = one | (pq & att[2 * q]) | (nq & att[2 * q + 1])
        zero = zero | (pq & att[2 * q + 1]) | (nq & att[2 * q])
    return (c[1] | one) & ~zero & M32


def attraction_planes(dgx, dgy):
    """The eight sign planes' bools of float32 dgx, dgy: the sums rounded
    once, as the kernel's __fadd_rn of __fmul_rn."""
    hx, hy, zx, zy = dgx * F32(0.5), dgy * F32(0.5), dgx * F32(0), \
        dgy * F32(0)
    sums = (hx + zy, zx + hy, hx + hy, hx + dgy * F32(-0.5))
    return [p for sm in sums for p in (sm > 0, sm < 0)]


def _window(tr0, tr1, tc0, tc1, halo, box):
    br0, br1, bc0, bc1 = box
    wr0, wr1 = max(tr0 - halo, br0), min(tr1 + halo, br1)
    wc0 = max(tc0 - halo, bc0)
    ww = -(-(min(tc1 + halo, bc1) - wc0) // 32)
    return wr0, wr1, wc0, ww, min(wc0 + 32 * ww, bc1)


def twin_chunk(kind, ls, aux, k, s, parity0, balloon=0, thr_b=0.0,
               shard=None, cc=None, seed=0):
    """The bit body's launch of ``kind`` on float32 inputs: the new level
    set (and for 'acwe_fused' the partials (n_in, sum_in) in f64).
    ``shard``: (pt, pb, pcl, pcr, top, bottom, left, right) ints; ``cc``:
    K12's (c_in, c_out, l1, l2)."""
    h, w = ls.shape
    base = {"acwe_sh": "acwe", "gac_pre_sh": "gac_pre"}.get(kind, kind)
    gac = base.startswith("gac")
    halo = tmk._reach(kind, s) * k
    crop = _cuda._morph_crop(h, w, shard)
    th, tw, ww_max, cap, nblocks = _cuda.morph_geometry(kind, h, w, halo,
                                                        crop)
    r0, r1, c0, c1 = crop or (0, h, 0, w)
    box = (0, h, 0, w) if shard is None else (
        r0 if shard[4] else 0, r1 if shard[5] else h,
        c0 if shard[6] else 0, c1 if shard[7] else w)
    nops = k * ((int(balloon != 0) + 1 if gac else 1) + 2 * s)
    assert halo >= nops
    rng = np.random.default_rng(seed)
    out = ls.clone()
    n_in, sum_in, tiles = 0, 0.0, 0
    for tr0 in range(r0, r1, th):
        for tc0 in range(c0, c1, tw):
            tiles += 1
            tr1, tc1 = min(tr0 + th, r1), min(tc0 + tw, c1)
            wr0, wr1, wc0, ww, wcr = _window(tr0, tr1, tc0, tc1, halo, box)
            wh = wr1 - wr0
            assert ww <= ww_max and wh * ww <= cap
            rows = torch.arange(wr0, wr1)
            cols = torch.arange(wc0, wc0 + 32 * ww).clamp(max=wcr - 1)

            def grab(x, rr=rows, cc_=cols):
                return x[rr][:, cc_]

            def word(x):
                return pack(x, ww)

            cur = word(grab(ls) > 0.5)
            if base in ("acwe", "acwe_fused"):
                f = grab(aux)
                if base == "acwe_fused":
                    d1, d2 = f - cc[0], f - cc[1]
                    f = cc[2] * (d1 * d1) - cc[3] * (d2 * d2)
                neg, pos = word(f < 0), word(f > 0)
            else:
                if base == "gac_pre":
                    dgx, dgy, msk = grab(aux[0]), grab(aux[1]), \
                        grab(aux[2]) > 0
                else:
                    br0, br1, bc0, bc1 = box
                    gs = grab(aux, (rows + 1).clamp(max=br1 - 1))
                    gn = grab(aux, (rows - 1).clamp(min=br0))
                    ge = grab(aux, rows, (cols + 1).clamp(max=bc1 - 1))
                    gw = grab(aux, rows, (cols - 1).clamp(min=bc0))
                    dgx = F32(0.5) * (gs - gn)
                    dgy = F32(0.5) * (ge - gw)
                    msk = grab(aux) > thr_b
                att = [word(p) for p in attraction_planes(dgx, dgy)]
                mask = word(msk)
            emask = torch.zeros(ww, dtype=torch.int64)
            emask[-1] = 1 << ((wcr - 1 - wc0) & 31)
            nxt = torch.from_numpy(rng.integers(0, 2 ** 32, (wh, ww)))
            top_box, bottom_box = wr0 == box[0], wr1 == box[1]
            op = 0

            def step(fn):
                nonlocal cur, nxt, op
                op += 1
                rlo = 0 if top_box else op
                rhi = wh if bottom_box else wh - op
                c = shifted(cur, emask)
                above = [rows_about(t)[0] for t in c]
                below = [rows_about(t)[1] for t in c]
                new = fn(above, list(c), below)
                nxt[rlo:rhi] = new[rlo:rhi]
                cur, nxt = nxt, cur

            for j in range(k):
                if gac:
                    if balloon:
                        step(lambda a, c, b: balloon_update(a, c, b, mask,
                                                            balloon > 0))
                    step(lambda a, c, b: attraction_update(a, c, b, att))
                else:
                    step(lambda a, c, b: acwe_update(a, c, b, neg, pos))
                for cyc in range(s):
                    sioi = (parity0 + j * s + cyc) % 2 == 0
                    for half in range(2):
                        step(inf_sup if sioi == (half == 0) else sup_inf)
            assert op == nops
            tile = unpack(cur, wcr - wc0)[tr0 - wr0:tr1 - wr0,
                                         tc0 - wc0:tc1 - wc0]
            out[tr0:tr1, tc0:tc1] = tile.to(ls.dtype)
            if base == "acwe_fused":
                n_in += int(tile.sum())
                sum_in += float((aux[tr0:tr1, tc0:tc1]
                                 * tile.to(ls.dtype)).double().sum())
    assert tiles == nblocks
    if base == "acwe_fused":
        return out, (n_in, sum_in)
    return out


# inputs ------------------------------------------------------------------

def _inputs(shape, seed):
    """float32 image in [0, 255), a random binary level set, the frozen
    force of its means, an edge map in [0.05, 1) and a random binary
    start with blobs (so the fronts move)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, shape).astype(F32)
    ls = (rng.uniform(size=shape) > 0.5).astype(F32)
    c_in, c_out = (float(c) for c in binary_means(torch.from_numpy(img),
                                                   torch.from_numpy(ls)))
    f = ((img - F32(c_in)) ** 2 - (img - F32(c_out)) ** 2).astype(F32)
    g = rng.uniform(0.05, 1.0, shape).astype(F32)
    return (torch.from_numpy(img), torch.from_numpy(ls), torch.from_numpy(f),
            torch.from_numpy(g), c_in, c_out)


# widths not multiples of 32, a tall one, one of several column tiles
SHAPES = [(40, 70), (57, 100), (96, 33), (70, 530)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k,s,parity0", [(1, 1, 0), (2, 0, 1), (3, 1, 1),
                                         (8, 1, 0), (5, 2, 1)])
def test_twin_is_bitwise_morph_chunk(shape, k, s, parity0):
    _, ls, f, _, _, _ = _inputs(shape, k + 7 * s)
    got = twin_chunk("acwe", ls, f, k, s, parity0)
    want = tmk.morph_chunk_reference(ls, f, k, s, parity0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("balloon", [-1, 0, 1])
@pytest.mark.parametrize("pre_dg", [False, True])
@pytest.mark.parametrize("k,s,parity0", [(1, 1, 1), (4, 1, 0), (6, 0, 1)])
def test_twin_is_bitwise_gac_chunk(shape, balloon, pre_dg, k, s, parity0):
    _, ls, _, g, _, _ = _inputs(shape, 3 + k)
    thr = tmk._thr_b(balloon, 0.4)
    aux = tmk.gac_aux_stack(g, balloon, 0.4) if pre_dg else g
    got = twin_chunk("gac_pre" if pre_dg else "gac", ls, aux, k, s, parity0,
                     balloon, thr)
    want = tmk.gac_chunk_reference(ls, g, k, s, parity0, balloon, 0.4,
                                   pre_dg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k,s,parity0", [(1, 1, 0), (4, 1, 1), (8, 1, 0),
                                         (7, 2, 1)])
def test_twin_is_bitwise_morph_chunk_fused(shape, k, s, parity0):
    img, ls, _, _, c_in, c_out = _inputs(shape, 11 + k)
    l1, l2 = 1.0, 1.25
    cc = [torch.tensor(v, dtype=torch.float32) for v in (c_in, c_out, l1,
                                                          l2)]
    got, (n_in, sum_in) = twin_chunk("acwe_fused", ls, img, k, s, parity0,
                                     cc=cc)
    want, parts = tmk.morph_chunk_fused_reference(ls, img, c_in, c_out, l1,
                                                  l2, k, s, parity0)
    assert torch.equal(got, want)
    assert n_in == float(parts[0]) == float(got.sum())
    ref = float((img * want).double().sum())
    assert abs(sum_in - ref) <= 1e-12 * abs(ref)
    np.testing.assert_allclose(float(parts[1]), sum_in, rtol=1e-7)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("parity0", [0, 1])
def test_twin_takes_every_k_and_parity(k, parity0):
    _, ls, f, g, _, _ = _inputs((45, 75), 40 + k)
    assert torch.equal(twin_chunk("acwe", ls, f, k, 1, parity0),
                       tmk.morph_chunk_reference(ls, f, k, 1, parity0))
    aux = tmk.gac_aux_stack(g, -1, 0.5)
    assert torch.equal(
        twin_chunk("gac_pre", ls, aux, k, 1, parity0, -1),
        tmk.gac_chunk_reference(ls, aux, k, 1, parity0, -1, 0.5, True))


def _shard_blocks(x, nx, ny, d, garbage=None):
    """Each shard's (edges, padded block, pads) of an nx x ny grid of x
    (2-D, or a stack on its first axis): blocks of the owned cells with d
    cells of the neighbors' around them; on the global-edge sides the pads
    hold the replica, or with ``garbage`` (a seed) random values beyond the
    depth-1 ring and a random ring (the replica ring is refreshed before
    every read, and nothing reads past it)."""
    h, w = x.shape[-2:]
    bh, bw = h // nx, w // ny
    rows = torch.arange(-d, bh + d)
    cols = torch.arange(-d, bw + d)
    rng = None if garbage is None else np.random.default_rng(garbage)
    for ix, iy in itertools.product(range(nx), range(ny)):
        rr = (rows + ix * bh).clamp(0, h - 1)
        cc = (cols + iy * bw).clamp(0, w - 1)
        blk = x[..., rr, :][..., cc].clone()
        edges = (ix == 0, ix == nx - 1, iy == 0, iy == ny - 1)
        if rng is not None:
            noise = torch.from_numpy(rng.integers(0, 2, blk.shape)
                                     .astype(np.float32)).to(blk.dtype)
            for flag, sl in zip(edges, (np.s_[..., :d, :],
                                        np.s_[..., bh + d:, :],
                                        np.s_[..., :, :d],
                                        np.s_[..., :, bw + d:])):
                if flag:
                    blk[sl] = noise[sl]
        yield edges, blk.contiguous(), (d, d, d, d)


@pytest.mark.parametrize("grid", [(2, 2), (3, 3)])
@pytest.mark.parametrize("gac", [False, True])
def test_twin_is_bitwise_the_shard_references(grid, gac):
    shape = (96, 150)
    _, ls, f, g, _, _ = _inputs(shape, 21 + grid[0])
    k, s = (3, 1) if gac else (4, 1)
    d = tmk._reach("gac" if gac else "acwe", s) * k
    aux = tmk.gac_aux_stack(g, 1, 0.4) if gac else f
    pieces = zip(_shard_blocks(ls, *grid, d, garbage=1),
                 _shard_blocks(aux, *grid, d, garbage=2))
    for (edges, lsb, pads), (_, auxb, _) in pieces:
        shard = (*pads, *(int(e) for e in edges))
        if gac:
            want = tmk.gac_chunk_shard_reference(lsb, auxb, list(edges),
                                                 pads, k, s, 1, 1, 0.4)
            got = twin_chunk("gac_pre_sh", lsb, auxb, k, s, 1, 1,
                             shard=shard)
        else:
            want = tmk.morph_chunk_shard_reference(lsb, auxb, list(edges),
                                                   pads, k, s, 0)
            got = twin_chunk("acwe_sh", lsb, auxb, k, s, 0, shard=shard)
        assert torch.equal(got, want), edges


@pytest.mark.parametrize("gac", [False, True])
def test_twin_shard_with_shallow_and_uneven_pads(gac):
    """Pads shallower than the reach on an unflagged side, and pads of
    different depths: the box is the block there, as the references'
    clamped reads."""
    _, ls, f, g, _, _ = _inputs((60, 90), 5)
    aux = tmk.gac_aux_stack(g, -1, 0.3) if gac else f
    for pads, flags in (((1, 7, 3, 2), (1, 0, 0, 1)),
                        ((5, 1, 1, 9), (0, 1, 1, 0)),
                        ((2, 2, 2, 2), (1, 1, 1, 1))):
        if gac:
            want = tmk.gac_chunk_shard_reference(ls, aux, list(flags), pads,
                                                 2, 1, 0, -1, 0.3)
            got = twin_chunk("gac_pre_sh", ls, aux, 2, 1, 0, -1,
                             shard=(*pads, *flags))
        else:
            want = tmk.morph_chunk_shard_reference(ls, aux, list(flags),
                                                   pads, 3, 1, 1)
            got = twin_chunk("acwe_sh", ls, aux, 3, 1, 1,
                             shard=(*pads, *flags))
        assert torch.equal(got, want), (pads, flags)


# against the JAX package's kernels in interpret mode (few compiles) -------

def test_twin_matches_the_jax_morph_chunk():
    _, ls, f, _, _, _ = _inputs((64, 128), 1)
    want = jpm.morph_chunk(jnp.asarray(ls.numpy()), jnp.asarray(f.numpy()),
                           k=8, smoothing=1, parity0=1, interpret=True)
    np.testing.assert_array_equal(
        to_np(twin_chunk("acwe", ls, f, 8, 1, 1)), np.asarray(want))


def test_twin_matches_the_jax_gac_chunk():
    _, ls, _, g, _, _ = _inputs((160, 128), 2)
    want = jpm.gac_chunk(jnp.asarray(ls.numpy()), jnp.asarray(g.numpy()),
                         k=4, smoothing=1, parity0=0, balloon=1,
                         threshold=0.4, pre_dg=False, interpret=True)
    got = twin_chunk("gac", ls, g, 4, 1, 0, 1, tmk._thr_b(1, 0.4))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_twin_matches_the_jax_morph_chunk_fused():
    img, ls, _, _, c_in, c_out = _inputs((64, 128), 3)
    want, wparts = jpm.morph_chunk_fused(
        jnp.asarray(ls.numpy()), jnp.asarray(img.numpy()), F32(c_in),
        F32(c_out), 1.0, 1.0, k=4, smoothing=1, parity0=0, interpret=True)
    cc = [torch.tensor(v, dtype=torch.float32) for v in (c_in, c_out, 1.0,
                                                          1.0)]
    got, (n_in, sum_in) = twin_chunk("acwe_fused", ls, img, 4, 1, 0, cc=cc)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert n_in == float(wparts[0])
    np.testing.assert_allclose(sum_in, float(wparts[1]), rtol=1e-6)


# the GAC sign-plane identity ------------------------------------------------

def _special_f32():
    tiny = np.finfo(F32).tiny
    den = np.float32(1e-45)  # the smallest denormal
    vals = [0.0, -0.0, np.inf, -np.inf, np.nan, den, -den, 2 * den, 3 * den,
            -3 * den, tiny, -tiny, tiny / 2, np.finfo(F32).max,
            -np.finfo(F32).max, np.finfo(F32).max / 2, 1.0, -1.0, 0.5,
            1.5e-38, 3.0, -7.25, 1e30, -1e-30, 2.0 ** -126 + 2.0 ** -149,
            1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23), 3 * 2.0 ** -149]
    return np.array(vals, dtype=F32)


def test_gac_sign_planes_carry_the_attraction():
    """For every (dgx, dgy) of special float32 values and each of the nine
    (dux, duy) in {-1/2, +0, 1/2}^2 (the first body's values: +0 where the
    differences cancel), the rounded a = dgx dux + dgy duy is > 0 (< 0)
    exactly where the word update's plane for that pair says so."""
    v = _special_f32()
    dgx, dgy = (a.ravel() for a in np.meshgrid(v, v))
    planes = [to_np(p) for p in attraction_planes(torch.from_numpy(dgx),
                                                  torch.from_numpy(dgy))]
    # the pair of each (dux, duy) and whether it is the pair's negation
    pair = {(0.5, 0.0): (0, False), (-0.5, 0.0): (0, True),
            (0.0, 0.5): (1, False), (0.0, -0.5): (1, True),
            (0.5, 0.5): (2, False), (-0.5, -0.5): (2, True),
            (0.5, -0.5): (3, False), (-0.5, 0.5): (3, True)}
    with np.errstate(invalid="ignore", over="ignore", under="ignore"):
        for dux, duy in itertools.product((-0.5, 0.0, 0.5), repeat=2):
            a = dgx * F32(dux) + dgy * F32(duy)
            assert a.dtype == F32
            if (dux, duy) == (0.0, 0.0):
                assert not (a > 0).any() and not (a < 0).any()
                continue
            q, negated = pair[(dux, duy)]
            pos, neg = planes[2 * q], planes[2 * q + 1]
            if negated:
                pos, neg = neg, pos
            np.testing.assert_array_equal(a > 0, pos)
            np.testing.assert_array_equal(a < 0, neg)


@pytest.mark.parametrize("mid", [31, 32])
def test_word_ops_are_the_float_ops(mid):
    """Every 3x3 neighborhood of {0, 1}: the word ops equal the plain
    version's float min/max on the middle cell, placed at the last bit of
    a word or the first, so that a neighbor comes from the next or the
    previous word."""
    from chan_vese_tpu_torch.ops import morph as om
    nb = torch.tensor(list(itertools.product((0.0, 1.0), repeat=9)))
    grids = nb.reshape(-1, 3, 3)
    # each neighborhood alone in a 3 x 3 image, replica outside: the middle
    # cell's results
    want = {name: torch.stack([fn(x)[1, 1] for x in grids])
            for name, fn in (("si", om.sup_inf), ("is", om.inf_sup),
                             ("dil", om.dilate8), ("ero", om.erode8))}
    emask = torch.tensor([0, 0, 1 << 2], dtype=torch.int64)
    for i, x in enumerate(grids):
        big = torch.zeros(3, 67, dtype=torch.bool)
        big[:, mid - 1:mid + 2] = x.bool()
        words = pack(big, 3)
        c = shifted(words, emask)
        a = [rows_about(t)[0] for t in c]
        b = [rows_about(t)[1] for t in c]
        for name, fn in (("si", sup_inf), ("is", inf_sup),
                         ("dil", lambda a_, c_, b_: balloon_update(
                             a_, c_, b_, torch.full_like(c_[1], M32), True)),
                         ("ero", lambda a_, c_, b_: balloon_update(
                             a_, c_, b_, torch.full_like(c_[1], M32),
                             False))):
            got = unpack(fn(a, list(c), b), 67)[1, mid]
            assert float(got) == float(want[name][i]), (name, x)


# the geometry -------------------------------------------------------------

# (kind, h, w, k, crop) of the main path's launches: 4K whole-image
# kinds at the drivers' k, the 2x2 shard blocks of the sharded drivers
# (comm_k 8, D the halo), 1080p (the compat entry point); and the tile
# height each takes: the busiest SM's window rows least
MAIN = {
    "acwe 4K": ("acwe", 2160, 3840, 8, None, 96),
    "gac 4K": ("gac", 2160, 3840, 4, None, 48),
    "gac_pre 4K": ("gac_pre", 2160, 3840, 4, None, 48),
    "acwe_fused 4K": ("acwe_fused", 2160, 3840, 8, None, 96),
    "gac_pre 1080p": ("gac_pre", 1080, 1920, 4, None, 48),
    "acwe_sh 2x2": ("acwe_sh", 1080 + 48, 1920 + 48, 8, (24, 1104, 24, 1944),
                    48),
    "gac_pre_sh 2x2": ("gac_pre_sh", 1080 + 64, 1920 + 64, 8,
                       (32, 1112, 32, 1952), 48),
}


@pytest.mark.parametrize("name", sorted(MAIN))
def test_main_path_geometry(name):
    kind, h, w, k, crop, rows = MAIN[name]
    halo = tmk._reach(kind, 1) * k
    th, tw, ww, cap, nblocks = _cuda.morph_geometry(kind, h, w, halo, crop)
    assert th == rows
    bps = _cuda.morph_blocks_per_sm(kind, cap)
    assert bps >= _cuda.MORPH_MIN_BLOCKS
    assert (_cuda.MORPH_WORDS[kind] * 4 * cap + _cuda.morph_static_bytes()
            <= _cuda.SMEM_LIMIT + 1024)
    th_all = h if crop is None else crop[1] - crop[0]
    tw_all = w if crop is None else crop[3] - crop[2]
    assert nblocks == -(-th_all // th) * -(-tw_all // tw)
    # the least busy tiling of the candidates: ceil(blocks / SMs) window
    # rows on the busiest SM
    def load(t):
        n = -(-th_all // t) * -(-tw_all // tw)
        return -(-n // _cuda.SMS) * min(t + 2 * halo, h)
    assert all(load(th) <= load(t) for t in _cuda.MORPH_TILE_ROWS
               if _cuda.morph_blocks_per_sm(
                   kind, min(t + 2 * halo, h) * ww) >= bps)
    assert ww <= _cuda.MORPH_ROW_WORDS
    assert 32 * ww >= min(tw + 2 * halo, w)
    assert min(th + 2 * halo, h) * ww <= cap


@pytest.mark.parametrize("shape,crop,kind,k", [
    ((40, 70), None, "acwe", 8), ((96, 33), None, "gac", 4),
    ((5, 3000), None, "gac_pre", 1), ((3000, 7), None, "acwe_fused", 2),
    ((60, 90), (1, 53, 3, 88), "acwe_sh", 3),
    ((60, 90), (5, 59, 1, 81), "gac_pre_sh", 2),
    ((2160, 3840), None, "acwe", 64), ((2160, 3840), None, "gac", 16)])
def test_geometry_fits_every_window(shape, crop, kind, k):
    h, w = shape
    halo = tmk._reach(kind, 1) * k
    th, tw, ww, cap, nblocks = _cuda.morph_geometry(kind, h, w, halo, crop)
    r0, r1, c0, c1 = crop or (0, h, 0, w)
    assert ww <= _cuda.MORPH_MAX_WORDS
    assert _cuda.morph_blocks_per_sm(kind, cap) >= _cuda.MORPH_MIN_BLOCKS
    count = 0
    for tr0 in range(r0, r1, th):
        for tc0 in range(c0, c1, tw):
            count += 1
            wr0, wr1, _, wwin, _ = _window(tr0, min(tr0 + th, r1), tc0,
                                           min(tc0 + tw, c1), halo,
                                           (0, h, 0, w))
            assert wwin <= ww and (wr1 - wr0) * ww <= cap
    assert count == nblocks


def test_geometry_refuses_a_halo_without_room():
    with pytest.raises(ValueError, match="halo"):
        _cuda.morph_geometry("gac", 2160, 3840, 600)


def test_launchers_have_signatures():
    """The bit body's and the first body's launchers, as the library binds
    them: the sources declare each symbol with as many arguments."""
    import re
    from pathlib import Path

    from chan_vese_tpu_torch import _build
    src = "".join((Path(_build._SRC) / n).read_text()
                  for n in ("morph_band.cu", "morph_fused.cu"))
    decl = dict(re.findall(r'extern "C" cudaError_t (\w+)\(([^)]*)\)', src,
                           re.S))
    for name in ("cv_morph_chunk", "cv_morph_chunk_shard",
                 "cv_morph_fused_chunk", "cv_morph_bits_occupancy",
                 "cv_morph_fused_bits_occupancy", "cv_morph_chunk_v1",
                 "cv_morph_chunk_shard_v1", "cv_morph_fused_chunk_v1"):
        assert len(decl[name].split(",")) == len(_build.SIGNATURES[name]), \
            name


# on the card: the bit body against its first body ---------------------------

def _card(x):
    return x.to(cuda_device()).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2160, 3840), (1080, 1920), (1000, 1500)])
def test_bits_cuda_is_bitwise_v1_and_plain(shape):
    img, ls, f, g, c_in, c_out = (_card(t) if isinstance(t, torch.Tensor)
                                  else t for t in _inputs(shape, 4))
    for k, s, p0 in ((8, 1, 0), (3, 2, 1)):
        halo = tmk._reach("acwe", s) * k
        new = _cuda.launch_morph("acwe", ls, f, k, s, p0, 0, 0.0, halo)
        old = _cuda.launch_morph("acwe", ls, f, k, s, p0, 0, 0.0, halo,
                                 v1=True)
        want = tmk.morph_chunk_reference(ls, f, k, s, p0)
        torch.cuda.synchronize()
        assert torch.equal(new, old) and torch.equal(new, want)
    for pre_dg, b in itertools.product((False, True), (-1, 0, 1)):
        kind = "gac_pre" if pre_dg else "gac"
        thr = tmk._thr_b(b, 0.3)
        aux = tmk.gac_aux_stack(g, b, 0.3) if pre_dg else g
        halo = tmk._reach(kind, 1) * 4
        new = _cuda.launch_morph(kind, ls, aux, 4, 1, 1, b, thr, halo)
        old = _cuda.launch_morph(kind, ls, aux, 4, 1, 1, b, thr, halo,
                                 v1=True)
        want = tmk.gac_chunk_reference(ls, g, 4, 1, 1, b, 0.3, pre_dg)
        torch.cuda.synchronize()
        assert torch.equal(new, old) and torch.equal(new, want), (kind, b)
    cc = torch.tensor([c_in, c_out, 1.0, 1.25], dtype=torch.float32,
                      device=ls.device)
    halo = tmk._reach("acwe_fused", 1) * 8
    new, parts = _cuda.launch_morph_fused(ls, img, cc, 8, 1, 0, halo)
    old, oparts = _cuda.launch_morph_fused(ls, img, cc, 8, 1, 0, halo,
                                           v1=True)
    want, wparts = tmk.morph_chunk_fused_reference(ls, img, c_in, c_out, 1.0,
                                                   1.25, 8, 1, 0)
    torch.cuda.synchronize()
    assert torch.equal(new, old) and torch.equal(new, want)
    assert float(parts[0]) == float(oparts[0]) == float(wparts[0])
    for ref in (oparts, wparts):
        np.testing.assert_allclose(float(parts[1]), float(ref[1]),
                                   rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(2, 2), (3, 3)])
def test_bits_cuda_shard_kinds_are_bitwise_v1_and_plain(grid):
    _, ls, f, g, _, _ = _inputs((2160, 3840), 6)
    for gac in (False, True):
        kind = "gac_pre_sh" if gac else "acwe_sh"
        d = tmk._reach(kind, 1) * 8
        aux = tmk.gac_aux_stack(g, 1, 0.3) if gac else f
        whole = _cuda.launch_morph(
            "gac_pre" if gac else "acwe", _card(ls), _card(aux), 8, 1, 0,
            1 if gac else 0, 0.0, d)
        bh, bw = 2160 // grid[0], 3840 // grid[1]
        pieces = zip(_shard_blocks(ls, *grid, d), _shard_blocks(aux, *grid, d))
        for i, ((edges, lsb, pads), (_, auxb, _)) in enumerate(pieces):
            lsb, auxb = _card(lsb), _card(auxb)
            shard = (*pads, *(int(e) for e in edges))
            args = (kind, lsb, auxb, 8, 1, 0, 1 if gac else 0, 0.0, d)
            new = _cuda.launch_morph(*args, shard=shard)
            old = _cuda.launch_morph(*args, shard=shard, v1=True)
            if gac:
                want = tmk.gac_chunk_shard_reference(
                    lsb, auxb, list(edges), pads, 8, 1, 0, 1, 0.3)
            else:
                want = tmk.morph_chunk_shard_reference(lsb, auxb,
                                                       list(edges), pads, 8,
                                                       1, 0)
            torch.cuda.synchronize()
            assert torch.equal(new, old) and torch.equal(new, want), edges
            ix, iy = divmod(i, grid[1])
            assert torch.equal(new[d:d + bh, d:d + bw],
                               whole[ix * bh:(ix + 1) * bh,
                                     iy * bw:(iy + 1) * bw])


@pytest.mark.cuda
def test_bits_cuda_second_stream_is_bitwise():
    img, ls, f, g, c_in, c_out = (_card(t) if isinstance(t, torch.Tensor)
                                  else t for t in _inputs((1080, 1920), 8))
    cc = torch.tensor([c_in, c_out, 1.0, 1.0], dtype=torch.float32,
                      device=ls.device)
    aux = tmk.gac_aux_stack(g, -1, 0.3)

    def run():
        return (tmk.morph_chunk(ls, f), tmk.gac_chunk(ls, g, k=4, balloon=1),
                tmk.gac_chunk(ls, aux, k=4, balloon=-1, pre_dg=True),
                *tmk.morph_chunk_fused(ls, img, cc[0], cc[1], cc[2], cc[3]))

    first = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bits_cuda_refuses_a_wrong_block_count():
    from chan_vese_tpu_torch import _build
    ls = torch.zeros((256, 384), device=cuda_device())
    th, tw, ww, cap, nblocks = _cuda.morph_geometry("acwe", 256, 384, 24)
    out = torch.empty_like(ls)
    lib = _build.library()
    err = lib.cv_morph_chunk(
        ls.data_ptr(), ls.data_ptr(), out.data_ptr(), 256, 384, 0, 8, 1, 0, 0,
        0.0, 24, th, tw, ww, cap, nblocks + 1,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
