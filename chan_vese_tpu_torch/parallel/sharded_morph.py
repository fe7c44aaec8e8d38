"""Sharded morphological drivers: MorphACWE and MorphGAC over an (x, y) grid
mesh of shards. Counterpart of ``chan_vese_tpu/parallel/sharded_morph.py``
(``segment_morph_sharded_chunked``, ``segment_gac_sharded_chunked``) and of
the per-iteration sharded wrappers ``models.morph.segment_morph_sharded``
and ``models.morph_gac.segment_gac_sharded``, which run here.

One process drives every shard (``parallel/sharded.py``). A chunk of k
iterations exchanges one halo of depth D = R k, R the reach of one
iteration (1 + 2s for ACWE, 2 + 2s for GAC: every elementary op reads
distance 1), and runs the k iterations on each shard's padded block; the
owned block stays exact because the validity rim shrinks by R an
iteration. At the global image edges the pads hold replicas, refreshed
from the current edge cells before every elementary op (the reference's
``_refresh_global_pads``, here ``sharded._resync_replicas``): refreshed
only between iterations they would leave some 0.4% of the cells wrong.
GAC has no reduction in its loop, so its chunks are the per-iteration
trajectory for any k; ACWE freezes the region means over a chunk (one
pair of summed region sums a chunk), k = 1 being the per-iteration
scheme. Convergence is chunk-granular (``models.morph_gac.run_chunks``,
the reference's ``_chunk_loop``): a below-tol chunk credits its k
iterations, and max_iter stays exact through one remainder chunk.

Routes: full gray chunks run K11's shard kinds per shard
(``ops.morph_kernel.morph_chunk_shard``, ``gac_chunk_shard``) where the
reference's kernel-per-shard predicate holds (``_route_shard_kernel``,
evaluated on its 8/128-aligned block); the remainder chunk and RGB take
the plain body, as in the reference, bitwise the same. The kernel's blocks
are (h + 2D, w + 2D) without the reference's alignment pads.

The per-iteration wrappers (the reference runs its unsharded drivers on
sharded arrays) exchange a depth-R halo each iteration and keep the
unsharded drivers' stopping rule, ``segment_morph``'s and
``segment_gac``'s 2-cycle detector included; their shards must hold R
rows and columns.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.morph import MorphResult, _lambdas
from ..models.morph_gac import GACResult, _init_ls, _Tolerance, run_chunks
from ..ops import morph_kernel
from ..ops.morph import acwe_force, padded_iteration
from ..ops.morph_kernel import _reach, gac_aux_stack, supports_morph_banded
from ..params import CVParams
from .halo import exchange_halo2d
from .mesh import grid_sharding, shard_grid
from .sharded import _Grid, _image_pads, _on_mesh, _resync_replicas

_TINY = 1e-8  # binary_means' empty-region guard (ops/morph.py)


def _check_geom(H, W, nx, ny, D):
    if H % nx or W % ny:
        raise ValueError(f"image {H}x{W} not divisible by mesh "
                         f"{nx}x{ny}")
    h, w = H // nx, W // ny
    if D > min(h, w):
        raise ValueError(
            f"comm_k halo depth {D} exceeds local block {h}x{w}; "
            f"lower comm_k or the mesh size")
    return h, w


def _route_shard_kernel(shape2d, mesh, comm_k, smoothing, kind,
                        use_pallas, on_cuda):
    """The kernel-per-shard route of the chunked drivers: the reference's
    predicate on its alignment-padded block, (comm_k smoothing) % 2 == 0,
    and (auto) CUDA devices. Explicit True on CPU devices runs the
    kernels' plain versions; True where the predicate fails raises."""
    H, W = shape2d
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    s = int(smoothing)
    D = _reach("acwe" if kind == "acwe_sh" else "gac", s) * comm_k
    ok = False
    if not (H % nx or W % ny) and D <= min(H // nx, W // ny):
        h, w = H // nx, W // ny
        rb, rc = (-(h + 2 * D)) % 8, (-(w + 2 * D)) % 128
        ok = (supports_morph_banded(h + 2 * D + rb, w + 2 * D + rc, comm_k,
                                    s, kind)
              and (comm_k * s) % 2 == 0)
    if use_pallas is None:
        return ok and on_cuda
    if use_pallas and not ok:
        raise ValueError(f"kernel-per-shard unsupported for "
                         f"{tuple(shape2d)} on {nx}x{ny}, comm_k={comm_k}, "
                         f"smoothing={smoothing}")
    return bool(use_pallas)


def _on_cuda(mesh) -> bool:
    return all(d.type == "cuda" for d in mesh.devices)


def _count(new, old):
    """Cells where two binary blocks differ, as a (1,) tensor."""
    return torch.sum((new != old).to(new.dtype))[None]


class _Morph:
    """A sharded morphological run: the grid, the level set's blocks, and
    one step over every shard."""

    def __init__(self, img, p: CVParams, mesh, ls0, kind: str, s: int,
                 depth: int, balloon: int = 0):
        self.img = _on_mesh(img, mesh)
        self.g = _Grid(self.img, p, mesh)
        self.kind, self.s, self.D, self.b = kind, s, depth, balloon
        self.ls = shard_grid(_init_ls(self.img, p, ls0), grid_sharding(mesh))

    def flips(self, new, old):
        """The fraction of cells where two level sets' blocks differ."""
        g = self.g
        return g.psum(g._each(lambda pos, a, b: _count(a, b), new,
                              old))[0] / g.n_pix

    def step(self, aux, size: int, n: int, kernel=None):
        """``size`` iterations from iteration n on each shard's padded
        block, ``aux`` the grid of its padded force or (dgx, dgy, mask)
        stack; ``kernel(pad, aux, pos)`` runs a full chunk in one launch.
        Returns the new blocks."""
        g, D = self.g, self.D
        parity0 = (n * self.s) % 2

        def one(pos, pad, a):
            if kernel is not None:
                out = kernel(pad, a, pos)
            else:
                def rim(x):
                    return _resync_replicas(x, *pos, g.nx, g.ny, D)
                out = pad
                for j in range(size):
                    out = padded_iteration(out, a, j, self.kind, self.s,
                                           parity0, self.b, rim)
            return out[D:D + g.h, D:D + g.w]

        return g.grid(g._each(one, exchange_halo2d(self.ls, D), aux))


def _acwe_force_pads(run: _Morph, u0p, c_in, c_out, l1, l2):
    """Each shard's frozen force on its padded image block."""
    g = run.g
    return g.grid(g._each(
        lambda pos, u: acwe_force(u, c_in.to(u.device), c_out.to(u.device),
                                  l1.to(u.device), l2.to(u.device)), u0p))


def segment_morph_sharded_chunked(u0, p: CVParams = CVParams(), mesh=None,
                                  ls0: Optional[torch.Tensor] = None,
                                  smoothing: int = 1, comm_k: int = 8,
                                  lambda1=None, lambda2=None,
                                  use_pallas: Optional[bool] = None
                                  ) -> MorphResult:
    """Communication-avoiding sharded MorphACWE: one halo exchange of depth
    (1 + 2 smoothing) comm_k and one pair of summed region sums per comm_k
    iterations (the frozen-means-per-chunk trajectory class; comm_k = 1 is
    the per-iteration-means scheme). u0: (H, W) or (H, W, C) with
    per-channel lambdas. Full gray chunks run K11's acwe_sh kind per shard
    where the reference's predicate holds (auto on CUDA devices; True on
    CPU devices runs its plain version). Returns a MorphResult gathered
    onto the mesh's first device."""
    if mesh is None:
        raise ValueError("segment_morph_sharded_chunked needs a mesh")
    s, comm_k = int(smoothing), int(comm_k)
    use_k = (u0.ndim == 2
             and _route_shard_kernel(u0.shape, mesh, comm_k, s, "acwe_sh",
                                     use_pallas, _on_cuda(mesh)))
    D = _reach("acwe", s) * comm_k
    _check_geom(*u0.shape[:2], mesh.shape["x"], mesh.shape["y"], D)
    run = _Morph(u0, p, mesh, ls0, "acwe", s, D)
    g = run.g
    l1, l2 = _lambdas(run.img, p, lambda1, lambda2)
    u0p = _image_pads(g, D)
    sum_u = g.psum(g._each(
        lambda pos, u: torch.sum(u, dim=(0, 1)).reshape(g.nchan), g.u0))

    def means():
        """Frozen per-chunk region means from one sum of (n_in, s_in)."""
        def local(pos, u, ls):
            w = ls[..., None] if g.vec else ls
            return torch.cat([torch.sum(ls)[None],
                              torch.sum(u * w, dim=(0, 1)).reshape(g.nchan)])
        tot = g.psum(g._each(local, g.u0, run.ls))
        n_in, s_in = tot[0], (tot[1:] if g.vec else tot[1])
        su = sum_u if g.vec else sum_u[0]
        return (s_in / (n_in + _TINY),
                (su - s_in) / (g.n_pix - n_in + _TINY))

    st = _Tolerance(p, run.img)

    def kernel(pad, f, pos):
        return morph_kernel.morph_chunk_shard(
            pad, f, g.edges(pos), (D,) * 4, k=comm_k, smoothing=s,
            parity0=0)

    def run_chunk(size):
        c_in, c_out = means()
        fp = _acwe_force_pads(run, u0p, c_in, c_out, l1, l2)
        new = run.step(fp, size, st.n,
                       kernel if use_k and size == comm_k else None)
        # NaN-poison through the frozen force: a non-finite image or mean
        # must abort, not freeze the binary state at 0 flips
        flips = run.flips(new, run.ls) + 0.0 * fp[0][0][0, 0].to(g.first)
        run.ls = new
        return flips

    run_chunks(st, p.max_iter, comm_k, run_chunk)
    c1, c2 = means()
    ls = g.gather(run.ls)
    return MorphResult(ls, ls >= 0.5, st.n, st.delta, c1, c2)


def _gac_aux_pads(g: _Grid, balloon: int, threshold: float, depth: int):
    """Each shard's (dgx, dgy, balloon mask) stack from its padded edge map
    (the grid's image; replica-clamped central differences: the unsharded
    stack at every owned and valid-halo cell)."""
    return g.grid(g._each(lambda pos, gp: gac_aux_stack(gp, balloon,
                                                        threshold),
                          exchange_halo2d(g.u0, depth)))


def _poison(g: _Grid):
    """0 * the edge map's sum over the shards: NaN where it is not
    finite (the edge map is a run invariant; comparisons against NaN are
    False, so the flip metric alone would read it as converged)."""
    return 0.0 * g.psum(g._each(lambda pos, u: torch.sum(u)[None],
                                g.u0))[0]


def segment_gac_sharded_chunked(g, p: CVParams = CVParams(), mesh=None,
                                ls0: Optional[torch.Tensor] = None,
                                smoothing: int = 1, balloon: int = 0,
                                threshold: float = 0.5, comm_k: int = 8,
                                use_pallas: Optional[bool] = None
                                ) -> GACResult:
    """Communication-avoiding sharded MorphGAC on the edge map g (H, W):
    one halo exchange of depth (2 + 2 smoothing) comm_k per comm_k
    iterations and no reduction in the iteration, the per-iteration
    trajectory for any comm_k. Full chunks run K11's gac_pre_sh kind per
    shard where the reference's predicate holds (auto on CUDA devices;
    True on CPU devices runs its plain version). Returns a GACResult
    gathered onto the mesh's first device."""
    if mesh is None:
        raise ValueError("segment_gac_sharded_chunked needs a mesh")
    s, b, comm_k = int(smoothing), int(balloon), int(comm_k)
    threshold = float(threshold)
    use_k = _route_shard_kernel(g.shape, mesh, comm_k, s, "gac_pre_sh",
                                use_pallas, _on_cuda(mesh))
    D = _reach("gac", s) * comm_k
    _check_geom(*g.shape, mesh.shape["x"], mesh.shape["y"], D)
    run = _Morph(g, p, mesh, ls0, "gac", s, D, b)
    grid = run.g
    aux = _gac_aux_pads(grid, b, threshold, D)
    poison = _poison(grid)
    st = _Tolerance(p, run.img)

    def kernel(pad, a, pos):
        return morph_kernel.gac_chunk_shard(
            pad, a, grid.edges(pos), (D,) * 4, k=comm_k, smoothing=s,
            parity0=0, balloon=b, threshold=threshold)

    def run_chunk(size):
        new = run.step(aux, size, st.n,
                       kernel if use_k and size == comm_k else None)
        flips = run.flips(new, run.ls) + poison
        run.ls = new
        return flips

    run_chunks(st, p.max_iter, comm_k, run_chunk)
    ls = grid.gather(run.ls)
    return GACResult(ls, ls >= 0.5, st.n, st.delta)


def _check_wrapper(name, img, mesh, s: int, kind: str):
    """The per-iteration wrappers' checks: a mesh, divisible shards, and
    shards that hold one iteration's reach R. Returns R."""
    if mesh is None:
        raise ValueError(f"{name} needs a mesh "
                         f"(parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = img.shape[:2]
    what = "edge map" if kind == "gac" else "image"
    if H % nx or W % ny:
        raise ValueError(f"{what} {H}x{W} not divisible by mesh "
                         f"{nx}x{ny}")
    R = _reach(kind, s)
    if R > min(H // nx, W // ny):
        raise ValueError(f"{name} exchanges a {R}-deep halo each "
                         f"iteration; the {H // nx}x{W // ny} shards are "
                         f"smaller")
    return R


def morph_sharded(u0, p: CVParams, mesh, ls0, smoothing: int, lambda1,
                  lambda2) -> MorphResult:
    """The body of ``models.morph.segment_morph_sharded``: the unsharded
    per-iteration MorphACWE (means every iteration, the 2-cycle detector)
    over the shards, one depth-R halo exchange an iteration."""
    s = int(smoothing)
    R = _check_wrapper("segment_morph_sharded", u0, mesh, s, "acwe")
    run = _Morph(u0, p, mesh, ls0, "acwe", s, R)
    g = run.g
    l1, l2 = _lambdas(run.img, p, lambda1, lambda2)
    u0p = _image_pads(g, R)

    def binary_means():
        """ops.morph.binary_means from the shards' sums."""
        def local(pos, u, ls):
            w = ls[..., None] if g.vec else ls
            return torch.cat([
                torch.sum(ls)[None], torch.sum(1.0 - ls)[None],
                torch.sum(u * w, dim=(0, 1)).reshape(g.nchan),
                torch.sum(u * (1.0 - w), dim=(0, 1)).reshape(g.nchan)])
        tot = g.psum(g._each(local, g.u0, run.ls))
        c = g.nchan
        s_in, s_out = tot[2:2 + c], tot[2 + c:]
        if not g.vec:
            s_in, s_out = s_in[0], s_out[0]
        return s_in / (tot[0] + _TINY), s_out / (tot[1] + _TINY)

    st, prev = _Tolerance(p, run.img), run.ls
    while st.more():
        c_in, c_out = binary_means()
        fp = _acwe_force_pads(run, u0p, c_in, c_out, l1, l2)
        new = run.step(fp, 1, st.n)
        flips = (run.flips(new, run.ls)
                 + 0.0 * (torch.sum(c_in) + torch.sum(c_out)))
        delta = torch.minimum(flips, run.flips(new, prev))
        prev, run.ls = run.ls, new
        st.record(delta)
    c1, c2 = binary_means()
    ls = g.gather(run.ls)
    return MorphResult(ls, ls >= 0.5, st.n, st.delta, c1, c2)


def gac_sharded(gmap, p: CVParams, mesh, ls0, smoothing: int, balloon: int,
                threshold: float) -> GACResult:
    """The body of ``models.morph_gac.segment_gac_sharded``: the unsharded
    per-iteration MorphGAC (the 2-cycle detector) over the shards, one
    depth-R halo exchange an iteration."""
    s, b = int(smoothing), int(balloon)
    R = _check_wrapper("segment_gac_sharded", gmap, mesh, s, "gac")
    run = _Morph(gmap, p, mesh, ls0, "gac", s, R, b)
    g = run.g
    aux = _gac_aux_pads(g, b, float(threshold), R)
    poison = _poison(g)
    st, prev = _Tolerance(p, run.img), run.ls
    while st.more():
        new = run.step(aux, 1, st.n)
        delta = torch.minimum(run.flips(new, run.ls) + poison,
                              run.flips(new, prev))
        prev, run.ls = run.ls, new
        st.record(delta)
    ls = g.gather(run.ls)
    return GACResult(ls, ls >= 0.5, st.n, st.delta)
