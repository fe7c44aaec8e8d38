"""Command-line interface: the grayscale, colour and multiphase subset of
``chan_vese_tpu/cli.py``.

    python -m chan_vese_tpu_torch image.npy -o mask.npy
    python -m chan_vese_tpu_torch image.npy --iters 100 --device cpu
    python -m chan_vese_tpu_torch rgb.npy --color --lambda1 1 1.2 0.8
    python -m chan_vese_tpu_torch image.npy --multiphase 2 -o labels.npy
    python -m chan_vese_tpu_torch image.npy --morph -o mask.npy
    python -m chan_vese_tpu_torch image.npy --morph-gac --balloon -1
    python -m chan_vese_tpu_torch image.npy --mesh 2 2 --comm-k 8 --iters 800
    python -m chan_vese_tpu_torch image.npy --mesh 2 2 --multiphase 2
    python -m chan_vese_tpu_torch image.npy --mesh 2 2 --morph-gac --comm-k 8
    python -m chan_vese_tpu_torch image.npy --pyramid -1 --reinit-every 10
    python -m chan_vese_tpu_torch image.npy --smooth 10 --smooth-kappa 12

Flag names and defaults follow the reference. ``--device`` picks the torch
device (default ``cuda``; it raises when no GPU is present rather than
falling back). Routing is the reference's: ``--color`` runs the plain
vector-valued drivers (``segment_vector``, or ``segment_vector_fixed``
with ``--iters``), which reach no kernel. Otherwise, on a CUDA device
with ``--order redblack``, the tolerance run takes the banded driver
(K2/K3 kernels, K5/K6 for a 3-D array) and elsewhere the plain driver;
``--iters`` runs exactly that many iterations of the plain driver.
``--multiphase M`` segments into 2^M phases: the tolerance run takes
``segment_multiphase`` and ``--iters`` ``segment_multiphase_fixed``, both
on their auto route (K9/K10 for M = 2 on a gray image on a CUDA device,
the plain path elsewhere or with ``--no-fused``), and the label map is
written with ``save_labels``; a diverged run exits 1 and writes nothing.
``--morph`` runs MorphACWE (gray, or per-channel with ``--color``) and
``--morph-gac`` MorphGAC on the image's inverse-Gaussian-gradient edge
map (``--gac-alpha``, ``--gac-sigma``, ``--gac-threshold``,
``--balloon``), both with ``--morph-smoothing`` cycles: the tolerance run
takes ``segment_morph`` / ``segment_gac`` (K11 on a CUDA device unless
``--no-fused``), ``--iters`` ``segment_morph_fixed`` /
``segment_gac_fixed``. With ``--multiphase`` the morph flags are dropped
with a warning. ``--mesh NX NY`` shards the image over an NX x NY grid
(NX*NY CPU devices with ``--device cpu``, the CUDA devices otherwise, in
turn where there are fewer than shards), as the reference routes it: the
two-phase PDE (gray or ``--color``) through ``segment_sharded`` and
``--multiphase`` through ``segment_multiphase_sharded`` (tolerance mode,
or fixed with ``--iters``; ``--comm-k`` and ``--halo`` passed on);
``--morph`` and ``--morph-gac`` in
tolerance mode through ``segment_morph_sharded_chunked`` /
``segment_gac_sharded_chunked`` with ``--comm-k`` above 1, else
``segment_morph_sharded`` / ``segment_gac_sharded``, and with ``--iters``
through the unsharded fixed drivers, whose result the reference's mesh
run equals. ``--halo`` picks the sharded PDE's exchange: ``ppermute``
(the default), ``rdma`` (K14's ring shifts on the card, its plain version
with ``--device cpu``) or ``overlap`` (the interior swept while the
exchange runs on a second stream, then the rim stitched), with the
reference's raises (gray only for the two-phase PDE; no ``--comm-k`` with
multiphase ``overlap``). ``--smooth STEPS`` runs Perona-Malik
pre-smoothing (``--smooth-kappa``) on the image first;
``--reinit-every K`` redistances the level set every K iterations (R1 on
the card; the banded and resident routes give way to the fused one).
``--pyramid L`` runs the tolerance solve coarse-to-fine over L 2x
decimations (-1: as many as ``plan_levels`` allows): ``segment_pyramid``,
``segment_pyramid_multiphase``, ``segment_pyramid_sharded`` with
``--mesh``, ``segment_pyramid_morph`` / ``segment_pyramid_gac`` (which take
L as given, so -1 runs no level below the image, as in the reference); it
is dropped with a warning with ``--iters``, with ``--mesh`` and
``--multiphase`` together, and with ``--mesh`` on the morphological paths.
``--trace-energy``, ``--evolution-gif`` (ROADMAP M12) and
``--checkpoint-dir`` (M13e) raise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .params import CVParams


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="chan_vese_tpu_torch",
        description="Chan-Vese active-contour segmentation (PyTorch/CUDA)")
    ap.add_argument("input", help="input image (npy/npz; png/jpg need "
                                  "Pillow)")
    ap.add_argument("-o", "--output", default=None,
                    help="output mask (npy, or png with Pillow)")
    d = CVParams()
    ap.add_argument("--mu", type=float, default=d.mu,
                    help=f"length penalty (default {d.mu:g}; for [0,255] "
                         "intensities)")
    ap.add_argument("--nu", type=float, default=d.nu, help="area penalty")
    ap.add_argument("--lambda1", type=float, nargs="+", default=[d.lambda1],
                    help="inside fit weight(s); one per channel with --color")
    ap.add_argument("--lambda2", type=float, nargs="+", default=[d.lambda2],
                    help="outside fit weight(s)")
    ap.add_argument("--dt", type=float, default=d.dt, help="time step")
    ap.add_argument("--eps", type=float, default=d.eps,
                    help="Heaviside/Dirac regularization width")
    ap.add_argument("--tol", type=float, default=d.tol,
                    help="per-pixel convergence tolerance")
    ap.add_argument("--max-iter", type=int, default=d.max_iter)
    ap.add_argument("--iters", type=int, default=None,
                    help="run EXACTLY this many iterations (fixed mode)")
    ap.add_argument("--init", default=d.init,
                    choices=("checkerboard", "circle", "rect", "disk",
                             "small-disk"))
    ap.add_argument("--order", choices=("redblack", "jacobi", "wavefront"),
                    default=d.order,
                    help="sweep ordering (wavefront == sequential raster "
                         "Gauss-Seidel; parity mode)")
    ap.add_argument("--color", action="store_true",
                    help="vector-valued (RGB) energy on color images")
    ap.add_argument("--pyramid", type=int, default=0, metavar="L",
                    help="coarse-to-fine multiscale: segment an L-times "
                         "2x-decimated copy first and refine upward "
                         "(tolerance mode; -1 = auto depth)")
    ap.add_argument("--multiphase", type=int, default=0, metavar="M",
                    help="multiphase Vese-Chan with M level sets (2^M "
                         "phases); writes a label map")
    ap.add_argument("--morph", action="store_true",
                    help="morphological Chan-Vese (MorphACWE): binary "
                         "level set with sup-inf/inf-sup curvature "
                         "smoothing instead of the PDE; gray or --color; "
                         "--mu/--dt/--eps unused")
    ap.add_argument("--morph-smoothing", type=int, default=1, metavar="S",
                    help="SI/IS smoothing cycles per --morph iteration")
    ap.add_argument("--morph-gac", action="store_true",
                    help="morphological geodesic active contours "
                         "(MorphGAC) on the inverse-Gaussian-gradient edge "
                         "map of the image, with balloon and "
                         "edge-attraction forces; --init disk seeds the "
                         "contour")
    ap.add_argument("--balloon", type=int, default=0, metavar="B",
                    help="MorphGAC balloon force: +1 grow, -1 shrink, "
                         "0 off")
    ap.add_argument("--gac-alpha", type=float, default=100.0,
                    help="inverse-Gaussian-gradient steepness")
    ap.add_argument("--gac-sigma", type=float, default=5.0,
                    help="inverse-Gaussian-gradient blur width")
    ap.add_argument("--gac-threshold", default="auto",
                    help="balloon activation threshold on the edge map "
                         "('auto' = 40th percentile)")
    ap.add_argument("--smooth", type=int, default=0, metavar="STEPS",
                    help="Perona-Malik pre-smoothing steps")
    ap.add_argument("--smooth-kappa", type=float, default=10.0)
    ap.add_argument("--reinit-every", type=int, default=d.reinit_every,
                    help="redistance the level set every K iterations "
                         "(0 = never)")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("NX", "NY"),
                    help="shard the image over an NX x NY grid mesh "
                         "(halo exchange): NX*NY CPU devices with --device "
                         "cpu, the CUDA devices otherwise (in turn where "
                         "there are fewer than shards)")
    ap.add_argument("--comm-k", type=int, default=1, metavar="K",
                    help="sharded communication-avoiding chunking: one "
                         "deep halo exchange per K iterations "
                         "(frozen-means trajectory class; the kernels per "
                         "shard on a GPU)")
    ap.add_argument("--halo", choices=("ppermute", "rdma", "overlap"),
                    default="ppermute",
                    help="sharded halo mechanism: the plain exchange "
                         "(default), the ring-shift kernel (K14), or "
                         "comm/compute overlap (interior compute concurrent "
                         "with the exchange on a second stream)")
    ap.add_argument("--trace-energy", default=None, metavar="CSV",
                    help="per-iteration energy trace (ROADMAP M12; raises)")
    ap.add_argument("--evolution-gif", default=None, metavar="GIF",
                    help="contour-evolution animation (ROADMAP M12; raises)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoints (ROADMAP M13e; raises)")
    ap.add_argument("--no-fused", action="store_true",
                    help="skip the kernel drivers even on a GPU")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .models.banded import segment_banded
    from .models.scalar import segment, segment_fixed
    from .models.vector import segment_vector, segment_vector_fixed
    from .utils import image_io

    if not args.color and (len(args.lambda1) > 1 or len(args.lambda2) > 1):
        print("error: per-channel --lambda1/--lambda2 need --color",
              file=sys.stderr)
        return 2
    if args.iters is not None and args.iters < 1:
        print("error: --iters must be positive", file=sys.stderr)
        return 2
    if args.multiphase < 0:
        print("error: --multiphase must be positive", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")
    try:
        img = image_io.load_image(args.input, color=args.color)
    except FileNotFoundError:
        print(f"error: cannot open input image {args.input!r}",
              file=sys.stderr)
        return 2
    u0 = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    if args.smooth:
        from .ops.diffusion import perona_malik

        u0 = perona_malik(u0, steps=args.smooth, kappa=args.smooth_kappa)

    p = CVParams(mu=args.mu, nu=args.nu, lambda1=args.lambda1[0],
                 lambda2=args.lambda2[0], dt=args.dt, eps=args.eps,
                 tol=args.tol, max_iter=args.max_iter, init=args.init,
                 order=args.order, reinit_every=args.reinit_every)
    if args.pyramid and (args.iters is not None
                         or (args.mesh is not None and args.multiphase)):
        # a tolerance-mode surface; the sharded multiphase driver has no
        # pyramid
        _warn_dropped("fixed-iteration/sharded-multiphase", "--pyramid")
        args.pyramid = 0
    if (args.morph or args.morph_gac) and args.multiphase:
        # the morphological schemes are two-phase; M coupled level sets
        # stay on the PDE multiphase path
        _warn_dropped("multiphase", *(n for n, v in (
            ("--morph", args.morph), ("--morph-gac", args.morph_gac)) if v))
        args.morph = args.morph_gac = False
    if args.pyramid and args.mesh is not None and (args.morph
                                                   or args.morph_gac):
        _warn_dropped("sharded morphological", "--pyramid")
        args.pyramid = 0
    for flag, value, module in (
            ("--trace-energy", args.trace_energy, "M12"),
            ("--evolution-gif", args.evolution_gif, "M12"),
            ("--checkpoint-dir", args.checkpoint_dir, "M13e")):
        if value is not None:
            raise NotImplementedError(f"{flag} is ROADMAP {module}, not "
                                      f"ported yet")
    if args.multiphase:
        return _multiphase(args, u0, p)

    lam1 = tuple(args.lambda1) if args.color else None
    lam2 = tuple(args.lambda2) if args.color else None
    if args.morph_gac:
        return _morph_gac(args, u0, p)
    if args.morph:
        return _morph(args, u0, p, lam1, lam2)

    if args.mesh is not None:
        mask, iters, c1, c2 = _sharded(args, u0, p, lam1, lam2)
    elif args.pyramid:
        from .models.pyramid import segment_pyramid

        res = segment_pyramid(u0, p, levels=_levels(args), lambda1=lam1,
                              lambda2=lam2)
        print(f"pyramid per-level iters (coarse -> fine): "
              f"{res.level_iters}", file=sys.stderr)
        mask, iters, c1, c2 = res.mask, res.iters, res.c1, res.c2
    elif args.iters is not None:
        if args.color:
            tr = segment_vector_fixed(u0, p, iters=args.iters, lambda1=lam1,
                                      lambda2=lam2)
        else:
            tr = segment_fixed(u0, p, iters=args.iters)
        mask, iters, c1, c2 = tr.mask, args.iters, tr.c1[-1], tr.c2[-1]
    else:
        if args.color:
            res = segment_vector(u0, p, lambda1=lam1, lambda2=lam2)
        elif (not args.no_fused and device.type == "cuda"
                and args.order == "redblack"):
            # the kernels implement red-black only; the banded driver
            # falls back to the fused kernel, then the plain path, off
            # its envelope (the reference's routing: --color never
            # reaches this branch)
            res = segment_banded(u0, p)
        else:
            res = segment(u0, p)
        mask, iters, c1, c2 = res.mask, res.iters, res.c1, res.c2

    c1, c2 = c1.cpu().numpy(), c2.cpu().numpy()
    if _diverged(iters, c1, c2):
        return 1
    print(f"converged in {iters} iters; c1={c1}, c2={c2}", file=sys.stderr)
    if args.output:
        image_io.save_mask(args.output, mask.cpu().numpy())
    return 0


def _warn_dropped(path_name, *flags):
    print(f"warning: {', '.join(flags)} not supported on the {path_name} "
          f"path; ignored", file=sys.stderr)


def _levels(args):
    """--pyramid's level count for the PDE pyramids: -1 = auto (None)."""
    return None if args.pyramid < 0 else args.pyramid


def _mesh(args, u0):
    """The --mesh grid: NX*NY CPU devices for a CPU tensor, else the CUDA
    devices, taken in turn where there are fewer than shards (one process
    drives every shard, so a 2x2 grid runs on one card)."""
    import torch

    from .parallel import make_grid_mesh

    nx, ny = args.mesh
    if u0.device.type == "cpu":
        devices = [torch.device("cpu")] * (nx * ny)
    else:
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i % n) for i in range(nx * ny)]
    return make_grid_mesh(nx, ny, devices)


def _sharded(args, u0, p: CVParams, lam1, lam2):
    """The --mesh branch (the two-phase PDE, gray or --color): tolerance
    mode, or exactly --iters iterations. Returns (mask, iters, c1, c2)."""
    from .parallel import segment_sharded

    mesh = _mesh(args, u0)
    kw = dict(lambda1=lam1, lambda2=lam2, comm_k=args.comm_k,
              use_pallas=False if args.no_fused else None, halo=args.halo)
    if args.iters is None:
        if args.pyramid:
            from .models.pyramid import segment_pyramid_sharded

            res = segment_pyramid_sharded(u0, p, mesh, levels=_levels(args),
                                          **kw)
            print(f"pyramid per-level iters (coarse -> fine): "
                  f"{res.level_iters}", file=sys.stderr)
        else:
            res = segment_sharded(u0, p, mesh, fixed=False, **kw)
        return res.mask, res.iters, res.c1, res.c2
    res = segment_sharded(u0, p, mesh, max_iter=args.iters, fixed=True, **kw)
    return res.mask, args.iters, res.c1, res.c2


def _diverged(iters, *signals) -> bool:
    """True (after saying so) if any signal is non-finite: a diverged run
    exits 1 and writes nothing."""
    import torch

    if all(bool(torch.isfinite(torch.as_tensor(s)).all()) for s in signals):
        return False
    print(f"DIVERGED after {iters} iters (non-finite level set - check the "
          f"input for NaN/Inf and the parameter scales); no outputs "
          f"written", file=sys.stderr)
    return True


def _multiphase(args, u0, p: CVParams) -> int:
    """The --multiphase branch: tolerance mode or --iters, labels out."""
    from .models.multiphase import (segment_multiphase,
                                    segment_multiphase_fixed)
    from .utils import image_io

    use_pallas = False if args.no_fused else None
    if args.mesh is not None:
        from .parallel import segment_multiphase_sharded

        kw = dict(m_sets=args.multiphase, use_pallas=use_pallas,
                  halo=args.halo, comm_k=args.comm_k)
        if args.iters is not None:
            res = segment_multiphase_sharded(u0, p, _mesh(args, u0),
                                             max_iter=args.iters, fixed=True,
                                             **kw)
            labels, iters, signals = res.labels, args.iters, (res.cs,)
        else:
            res = segment_multiphase_sharded(u0, p, _mesh(args, u0), **kw)
            labels, iters, signals = res.labels, res.iters, (res.cs,)
    elif args.iters is not None:
        tr = segment_multiphase_fixed(u0, p, iters=args.iters,
                                      m_sets=args.multiphase,
                                      use_pallas=use_pallas)
        labels, iters, signals = tr.labels, args.iters, (tr.energy[-1],)
    elif args.pyramid:
        from .models.pyramid import segment_pyramid_multiphase

        res = segment_pyramid_multiphase(u0, p, m_sets=args.multiphase,
                                         levels=_levels(args))
        labels, iters, signals = res.labels, res.iters, (res.cs, res.delta)
        print(f"pyramid levels: {res.level_iters} iters coarse->fine",
              file=sys.stderr)
    else:
        res = segment_multiphase(u0, p, m_sets=args.multiphase,
                                 use_pallas=use_pallas)
        labels, iters, signals = res.labels, res.iters, (res.cs, res.delta)
    if _diverged(iters, *signals):
        return 1
    print(f"multiphase: {2 ** args.multiphase} phases, {iters} iters",
          file=sys.stderr)
    if args.output:
        image_io.save_labels(args.output, labels.cpu().numpy())
    return 0


def _morph(args, u0, p: CVParams, lam1, lam2) -> int:
    """The --morph branch (MorphACWE): tolerance mode or --iters."""
    from .models.morph import segment_morph, segment_morph_fixed
    from .utils import image_io

    kw = dict(smoothing=args.morph_smoothing, lambda1=lam1, lambda2=lam2)
    if args.pyramid:
        from .models.pyramid import segment_pyramid_morph
        from .ops.morph import binary_means

        res = segment_pyramid_morph(u0, p, levels=args.pyramid, **kw)
        print(f"pyramid levels (coarse->fine iters): {res.level_iters}",
              file=sys.stderr)
        c1, c2 = binary_means(u0, res.ls)
        mask, iters, delta = res.mask, res.iters, res.delta
    elif args.iters is not None:
        tr = segment_morph_fixed(u0, p, iters=args.iters, **kw)
        mask, iters = tr.mask, args.iters
        c1, c2, delta = tr.c1[-1], tr.c2[-1], tr.delta[-1]
    elif args.mesh is not None:
        if args.comm_k > 1:
            from .parallel.sharded_morph import segment_morph_sharded_chunked

            res = segment_morph_sharded_chunked(
                u0, p, mesh=_mesh(args, u0), comm_k=args.comm_k,
                use_pallas=False if args.no_fused else None, **kw)
        else:
            from .models.morph import segment_morph_sharded

            res = segment_morph_sharded(u0, p, mesh=_mesh(args, u0), **kw)
        mask, iters, c1, c2, delta = (res.mask, res.iters, res.c1, res.c2,
                                      res.delta)
    else:
        res = segment_morph(u0, p, use_pallas=False if args.no_fused else None,
                            **kw)
        mask, iters, c1, c2, delta = (res.mask, res.iters, res.c1, res.c2,
                                      res.delta)
    if _diverged(iters, c1, c2, delta):
        return 1
    print(f"morphACWE: {iters} iters; c1={c1.cpu().numpy()}, "
          f"c2={c2.cpu().numpy()}", file=sys.stderr)
    if args.output:
        image_io.save_mask(args.output, mask.cpu().numpy())
    return 0


def _morph_gac(args, u0, p: CVParams) -> int:
    """The --morph-gac branch (MorphGAC on the image's edge map)."""
    from .models.morph_gac import segment_gac, segment_gac_fixed
    from .ops.morph import inverse_gaussian_gradient
    from .utils import image_io

    g = inverse_gaussian_gradient(u0, args.gac_alpha, args.gac_sigma)
    thr = (float(np.percentile(g.cpu().numpy(), 40))
           if args.gac_threshold == "auto" else float(args.gac_threshold))
    kw = dict(smoothing=args.morph_smoothing, balloon=args.balloon,
              threshold=thr)
    if args.pyramid:
        from .models.pyramid import segment_pyramid_gac

        res = segment_pyramid_gac(u0, p, levels=args.pyramid,
                                  gac_alpha=args.gac_alpha,
                                  gac_sigma=args.gac_sigma, **kw)
        print(f"pyramid levels (coarse->fine iters): {res.level_iters}",
              file=sys.stderr)
        mask, iters, delta = res.mask, res.iters, res.delta
    elif args.iters is not None:
        tr = segment_gac_fixed(g, p, iters=args.iters, **kw)
        mask, iters, delta = tr.mask, args.iters, tr.delta[-1]
    elif args.mesh is not None:
        if args.comm_k > 1:
            from .parallel.sharded_morph import segment_gac_sharded_chunked

            res = segment_gac_sharded_chunked(
                g, p, mesh=_mesh(args, u0), comm_k=args.comm_k,
                use_pallas=False if args.no_fused else None, **kw)
        else:
            from .models.morph_gac import segment_gac_sharded

            res = segment_gac_sharded(g, p, mesh=_mesh(args, u0), **kw)
        mask, iters, delta = res.mask, res.iters, res.delta
    else:
        res = segment_gac(g, p, use_pallas=False if args.no_fused else None,
                          **kw)
        mask, iters, delta = res.mask, res.iters, res.delta
    if _diverged(iters, delta):
        return 1
    print(f"morphGAC: {iters} iters; balloon={args.balloon}, "
          f"threshold={thr:.4g}", file=sys.stderr)
    if args.output:
        image_io.save_mask(args.output, mask.cpu().numpy())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
