"""Halo exchange over a grid of shards. Counterpart of
``chan_vese_tpu/parallel/halo.py``.

The shards of an nx x ny grid mesh are a list of rows of tensors, block
(ix, iy) on its own device. :func:`exchange_halo2d` returns each block
padded with ``depth`` rows and columns of its neighbours' cells: rows
first, then the columns of the row-extended blocks, so that the corners
ride along (the diagonal neighbour's cells arrive through the column
strip of a row-extended block). At the global image edges the pad holds
replicas of the block's own edge row or column, the solver's
clamped-index Neumann convention. Where a neighbour lives on the same
device its strip is a slice; across devices it moves with ``.to(dev)``
(a peer copy between cards). The reference runs this inside
``shard_map`` with ``ppermute``; here one process drives every shard.
"""

from __future__ import annotations

import torch


def _pad_axis(blocks, depth: int, dim: int):
    """Pad every block of a grid along ``dim`` (-2 rows, -1 columns) with
    its two neighbours' strips along that axis of the grid, or replicas of
    its own edge at the grid's ends."""
    nx, ny = len(blocks), len(blocks[0])
    out = []
    for ix in range(nx):
        row = []
        for iy in range(ny):
            x = blocks[ix][iy]
            ext = list(x.shape)
            ext[dim] = depth
            n = x.shape[dim]
            if dim == -2:
                lo = blocks[ix - 1][iy] if ix > 0 else None
                hi = blocks[ix + 1][iy] if ix < nx - 1 else None
            else:
                lo = blocks[ix][iy - 1] if iy > 0 else None
                hi = blocks[ix][iy + 1] if iy < ny - 1 else None
            before = (x.narrow(dim, 0, 1).expand(ext) if lo is None else
                      lo.narrow(dim, lo.shape[dim] - depth, depth)
                      .to(x.device))
            after = (x.narrow(dim, n - 1, 1).expand(ext) if hi is None else
                     hi.narrow(dim, 0, depth).to(x.device))
            row.append(torch.cat([before, x, after], dim=dim))
        out.append(row)
    return out


def _check_depth(blocks, depth: int):
    h, w = blocks[0][0].shape[-2:]
    if not 1 <= depth <= min(h, w):
        raise ValueError(f"halo depth {depth} must lie in 1..{min(h, w)} "
                         f"for ({h}, {w}) blocks")


def exchange_halo2d_batched(blocks, depth: int):
    """(..., h, w) blocks -> (..., h + 2 depth, w + 2 depth): the 2-D halo
    exchange applied to every leading-dimension slice at once (the
    sharded packed route exchanges parity-plane stacks this way: with
    even shards and an even depth, plane (a, b) of the padded block is
    the padded plane (a, b) at half depth). The global-edge replicas are
    each slice's own edge rows and columns; for parity planes the caller
    restores the flat convention (``sharded._fix_edge_replicas_planes``).
    """
    _check_depth(blocks, depth)
    return _pad_axis(_pad_axis(blocks, depth, -2), depth, -1)


def exchange_halo2d(blocks, depth: int = 4):
    """Pad each (h, w) block of the grid to (h + 2 depth, w + 2 depth)
    with halos: its neighbours' cells, edge replicas at the global image
    edges. Any depth up to min(h, w)."""
    return exchange_halo2d_batched(blocks, depth)
