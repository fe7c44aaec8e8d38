"""Command-line interface: the flags and the routing of
``chan_vese_tpu/cli.py``.

    python -m chan_vese_tpu_torch image.npy -o mask.npy --overlay ov.png
    python -m chan_vese_tpu_torch image.npy --iters 100 --device cpu --f64
    python -m chan_vese_tpu_torch rgb.npy --color --lambda1 1 1.2 0.8
    python -m chan_vese_tpu_torch image.npy --multiphase 2 -o labels.npy
    python -m chan_vese_tpu_torch image.npy --morph -o mask.npy
    python -m chan_vese_tpu_torch image.npy --morph-gac --balloon -1
    python -m chan_vese_tpu_torch image.npy --mesh 2 2 --comm-k 8 --iters 800
    python -m chan_vese_tpu_torch image.npy --mesh 2 2 --multiphase 2
    python -m chan_vese_tpu_torch image.npy --pyramid -1 --reinit-every 10
    python -m chan_vese_tpu_torch image.npy --iters 100 --trace-energy t.csv
    python -m chan_vese_tpu_torch image.npy --iters 100 --evolution-gif e.gif
    python -m chan_vese_tpu_torch image.npy --mesh 2 2 --iters 800 \\
        --checkpoint-dir ck --checkpoint-every 200

Flag names and defaults follow the reference. ``--device`` picks the torch
device (default ``cuda``; it raises when no GPU is present rather than
falling back). ``--f64`` runs in float64: the plain routes take it, the
kernels (float32 only) raise ``TypeError`` as their drivers do on a
float64 CUDA tensor, so on the card it goes with ``--no-fused``. ``--conv``
picks the convergence metric, ``--quiet`` silences the log lines and the
dropped-flag warnings (not the divergence report), and ``--overlay``
writes the contour of the mask (bit 0 of a label map) over the image on
every path.

Routing is the reference's. ``--color`` runs the plain vector-valued
drivers (``segment_vector``, or ``segment_vector_fixed`` with
``--iters``). Otherwise, on a CUDA device with ``--order redblack``, the
tolerance run takes the banded driver (K2/K3, K5/K6 for a 3-D array) and
elsewhere the plain driver; ``--iters`` runs exactly that many iterations
of the plain driver, with ``--trace-energy`` (the per-iteration energy,
delta and means as CSV) and ``--evolution-gif`` (a frame every
``--gif-every`` iterations, from a chunked re-run) or, with
``--checkpoint-dir``, ``segment_with_checkpoints`` (``.npz`` every
``--checkpoint-every`` iterations, resuming from the newest).
``--multiphase M`` segments into 2^M phases (``segment_multiphase``,
``segment_multiphase_fixed`` with its trace, or
``segment_multiphase_with_checkpoints``; K9/K10 for M = 2 on a gray image
on a CUDA device) and writes a label map. ``--morph`` runs MorphACWE and
``--morph-gac`` MorphGAC on the image's inverse-Gaussian-gradient edge
map (K11 on a CUDA device unless ``--no-fused``); their ``--iters`` runs
take ``--evolution-gif`` (and MorphACWE ``--trace-energy``); checkpoints
(and MorphGAC's trace) are dropped with a warning. ``--mesh NX NY``
shards the image over an NX x NY grid (NX*NY CPU devices with ``--device
cpu``, the CUDA devices otherwise, in turn where there are fewer than
shards): the two-phase PDE through ``segment_sharded`` (the trace through
``segment_sharded_fixed_trace``, which drops ``--comm-k``; checkpoints
through ``segment_sharded_with_checkpoints`` on
``torch.distributed.checkpoint``, gray only), ``--multiphase`` through
``segment_multiphase_sharded`` (its trace and checkpoints likewise, K9's
shard mode on the card), the GIF from a chunked re-run whose frames fall
on multiples of the run's ``--comm-k``; ``--morph``/``--morph-gac`` in
tolerance mode through the sharded morphological drivers. ``--halo``
picks the sharded exchange (``ppermute``, ``rdma``: K14 on the card, or
``overlap``). ``--smooth STEPS`` pre-smooths the image (Perona-Malik,
``--smooth-kappa``); ``--reinit-every K`` redistances every K iterations
(R1 on the card); ``--pyramid L`` runs the tolerance solve coarse-to-fine
over L 2x decimations (-1: as many as ``plan_levels`` allows) and is
dropped with a warning with ``--iters``, with ``--mesh`` and
``--multiphase`` together, and with ``--mesh`` on the morphological
paths. A diverged run exits 1 and writes nothing.
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
                    help="output mask / label map (npy, or png with Pillow)")
    ap.add_argument("--overlay", default=None,
                    help="write a contour overlay image here (npy, or png "
                         "with Pillow)")
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
                    help="per-pixel convergence tolerance (see --conv)")
    ap.add_argument("--max-iter", type=int, default=d.max_iter)
    ap.add_argument("--iters", type=int, default=None,
                    help="run EXACTLY this many iterations (fixed mode, "
                         "enables --trace-energy, --evolution-gif and "
                         "--checkpoint-dir)")
    ap.add_argument("--conv", choices=("flips", "rms", "mean_abs"),
                    default=d.conv_norm, help="convergence metric")
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
    ap.add_argument("--trace-energy", default=None, metavar="CSV",
                    help="write the per-iteration energy trace (fixed mode)")
    ap.add_argument("--evolution-gif", default=None, metavar="GIF",
                    help="write a contour-evolution animation (fixed mode, "
                         "records every --gif-every iterations; needs "
                         "imageio)")
    ap.add_argument("--gif-every", type=int, default=5)
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("NX", "NY"),
                    help="shard the image over an NX x NY grid mesh "
                         "(halo exchange): NX*NY CPU devices with --device "
                         "cpu, the CUDA devices otherwise (in turn where "
                         "there are fewer than shards)")
    ap.add_argument("--no-fused", action="store_true",
                    help="skip the kernel drivers even on a GPU")
    ap.add_argument("--halo", choices=("ppermute", "rdma", "overlap"),
                    default="ppermute",
                    help="sharded halo mechanism: the plain exchange "
                         "(default), the ring-shift kernel (K14), or "
                         "comm/compute overlap (interior compute concurrent "
                         "with the exchange on a second stream)")
    ap.add_argument("--comm-k", type=int, default=1, metavar="K",
                    help="sharded communication-avoiding chunking: one "
                         "deep halo exchange per K iterations "
                         "(frozen-means trajectory class; the kernels per "
                         "shard on a GPU)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write checkpoints here every --checkpoint-every "
                         "iterations (fixed mode; .npz, or "
                         "torch.distributed.checkpoint directories with "
                         "--mesh); resumes from the newest checkpoint if "
                         "present")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--f64", action="store_true",
                    help="double precision (the plain routes; CPU parity "
                         "mode)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

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
    if args.gif_every <= 0 or args.checkpoint_every <= 0:
        print("error: --gif-every and --checkpoint-every must be positive",
              file=sys.stderr)
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
    dtype = torch.float64 if args.f64 else torch.float32
    u0 = torch.from_numpy(np.ascontiguousarray(img)).to(device, dtype)
    if args.smooth:
        from .ops.diffusion import perona_malik

        u0 = perona_malik(u0, steps=args.smooth, kappa=args.smooth_kappa)

    p = CVParams(mu=args.mu, nu=args.nu, lambda1=args.lambda1[0],
                 lambda2=args.lambda2[0], dt=args.dt, eps=args.eps,
                 tol=args.tol, max_iter=args.max_iter, conv_norm=args.conv,
                 init=args.init, order=args.order,
                 reinit_every=args.reinit_every)
    if args.pyramid and (args.iters is not None
                         or (args.mesh is not None and args.multiphase)):
        # a tolerance-mode surface; the sharded multiphase driver has no
        # pyramid
        _warn_dropped(args, "fixed-iteration/sharded-multiphase",
                      ("--pyramid", True))
        args.pyramid = 0
    if (args.morph or args.morph_gac) and args.multiphase:
        # the morphological schemes are two-phase; M coupled level sets
        # stay on the PDE multiphase path
        _warn_dropped(args, "multiphase", ("--morph", args.morph),
                      ("--morph-gac", args.morph_gac))
        args.morph = args.morph_gac = False
    if args.pyramid and args.mesh is not None and (args.morph
                                                   or args.morph_gac):
        _warn_dropped(args, "sharded morphological", ("--pyramid", True))
        args.pyramid = 0
    if args.iters is None:
        # the trace, the GIF and the checkpoints need a fixed iteration
        # count on every path
        _warn_dropped(args, "tolerance-mode",
                      ("--trace-energy", args.trace_energy),
                      ("--evolution-gif", args.evolution_gif),
                      ("--checkpoint-dir", args.checkpoint_dir))
        args.trace_energy = args.evolution_gif = args.checkpoint_dir = None
    if args.multiphase:
        return _multiphase(args, img, u0, p)

    lam1 = tuple(args.lambda1) if args.color else None
    lam2 = tuple(args.lambda2) if args.color else None
    if args.morph_gac:
        return _morph_gac(args, img, u0, p)
    if args.morph:
        return _morph(args, img, u0, p, lam1, lam2)
    if args.mesh is not None:
        return _sharded(args, img, u0, p, lam1, lam2)
    if args.iters is not None and args.checkpoint_dir:
        return _checkpointed(args, img, u0, p, lam1, lam2)
    return _single(args, img, u0, p, lam1, lam2)


def _log(args, *msg):
    if not args.quiet:
        print(*msg, file=sys.stderr)


def _warn_dropped(args, path_name, *opts):
    """Warn (unless --quiet) that the options among ``opts`` ((flag, value)
    pairs) whose value is set are ignored on this path."""
    dropped = [name for name, val in opts if val]
    if dropped:
        _log(args, f"warning: {', '.join(dropped)} not supported on the "
                   f"{path_name} path; ignored")


def _levels(args):
    """--pyramid's level count for the PDE pyramids: -1 = auto (None)."""
    return None if args.pyramid < 0 else args.pyramid


def _use_pallas(args):
    return False if args.no_fused else None


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


def _diverged(iters, *signals) -> bool:
    """True (after saying so, even with --quiet) if any signal is
    non-finite: a diverged run exits 1 and writes nothing."""
    import torch

    if all(bool(torch.isfinite(torch.as_tensor(s)).all()) for s in signals):
        return False
    print(f"DIVERGED after {iters} iters (non-finite level set - check the "
          f"input for NaN/Inf and the parameter scales); no outputs "
          f"written", file=sys.stderr)
    return True


def _write_mask(args, img, mask):
    from .utils import image_io

    if args.output:
        image_io.save_mask(args.output, mask)
    if args.overlay:
        image_io.save_overlay(args.overlay, img, mask)


def _write_gif(args, img, frames):
    from .utils import image_io

    image_io.save_evolution_gif(args.evolution_gif, img, frames)


def _means(c1, c2):
    return c1.cpu().numpy(), c2.cpu().numpy()


# the GIF frames: the level set after every --gif-every iterations of a
# chunked re-run threading the state (and after the last), on the host

def _evolution_frames(iters: int, step: int, advance):
    """advance(state, n, chunk) -> (state, frame) runs iterations n to
    n + chunk from ``state`` (None: the run's own start)."""
    frames, state, n = [], None, 0
    while n < iters:
        chunk = min(step, iters - n)
        state, frame = advance(state, n, chunk)
        n += chunk
        frames.append(frame.cpu())
    return frames


def _aligned_step(args, comm_k: int) -> int:
    """--gif-every rounded up to a multiple of comm_k: a chunked re-run
    restarts the frozen-means cadence at each hand-off, so only aligned
    boundaries reproduce the main run's trajectory class."""
    return -(-args.gif_every // comm_k) * comm_k


def _fixed_frames(args, u0, p: CVParams, lam1, lam2):
    """Frames of the unsharded fixed run (``segment_fixed`` or
    ``segment_vector_fixed``; start_iter keeps the reinit cadence)."""
    from .models.scalar import segment_fixed
    from .models.vector import segment_vector_fixed

    def advance(phi, n, chunk):
        if args.color:
            t = segment_vector_fixed(u0, p, iters=chunk, phi0=phi,
                                     lambda1=lam1, lambda2=lam2,
                                     start_iter=n)
        else:
            t = segment_fixed(u0, p, iters=chunk, phi0=phi, start_iter=n)
        return t.phi, t.phi

    return _evolution_frames(args.iters, args.gif_every, advance)


def _sharded_frames(args, u0, p: CVParams, mesh, lam1, lam2, comm_k: int):
    """Frames of the sharded fixed run at ``comm_k``, from the run's own
    start (``segment_sharded``'s ``_make_phi0`` on the mesh)."""
    from .parallel import segment_sharded

    def advance(phi, n, chunk):
        r = segment_sharded(u0, p, mesh, phi0=phi, max_iter=chunk,
                            fixed=True, lambda1=lam1, lambda2=lam2,
                            use_pallas=_use_pallas(args), halo=args.halo,
                            comm_k=comm_k)
        return r.phi, r.phi

    return _evolution_frames(args.iters, _aligned_step(args, comm_k),
                             advance)


def _multiphase_sharded_frames(args, u0, p: CVParams, mesh, comm_k: int):
    """Frames (phi_0: bit 0 of the labels, the overlay's convention) of the
    sharded multiphase fixed run at ``comm_k``."""
    from .parallel import segment_multiphase_sharded

    def advance(phis, n, chunk):
        r = segment_multiphase_sharded(
            u0, p, mesh, m_sets=args.multiphase, phis0=phis, max_iter=chunk,
            fixed=True, use_pallas=_use_pallas(args), halo=args.halo,
            comm_k=comm_k)
        return r.phis, r.phis[0]

    return _evolution_frames(args.iters, _aligned_step(args, comm_k),
                             advance)


def _morph_frames(args, u0, p: CVParams, kw):
    """Frames (ls - 0.5) of the MorphACWE fixed run; start_iter keeps the
    SIoIS/ISoSI alternation of the main run."""
    from .models.morph import segment_morph_fixed

    def advance(ls, n, chunk):
        t = segment_morph_fixed(u0, p, iters=chunk, ls0=ls, start_iter=n,
                                **kw)
        return t.ls, t.ls - 0.5

    return _evolution_frames(args.iters, args.gif_every, advance)


def _gac_frames(args, g, p: CVParams, kw):
    """Frames (ls - 0.5) of the MorphGAC fixed run."""
    from .models.morph_gac import segment_gac_fixed

    def advance(ls, n, chunk):
        t = segment_gac_fixed(g, p, iters=chunk, ls0=ls, start_iter=n, **kw)
        return t.ls, t.ls - 0.5

    return _evolution_frames(args.iters, args.gif_every, advance)


def _single(args, img, u0, p: CVParams, lam1, lam2) -> int:
    """The unsharded two-phase PDE: tolerance mode, the pyramid, or
    exactly --iters iterations with the trace and the GIF."""
    from .models.banded import segment_banded
    from .models.scalar import segment, segment_fixed
    from .models.vector import segment_vector, segment_vector_fixed
    from .utils import trace as trace_util

    if args.iters is not None:
        if args.color:
            tr = segment_vector_fixed(u0, p, iters=args.iters, lambda1=lam1,
                                      lambda2=lam2)
        else:
            tr = segment_fixed(u0, p, iters=args.iters)
        mask, iters, c1, c2 = tr.mask, args.iters, tr.c1[-1], tr.c2[-1]
        if args.trace_energy:
            trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                        tr.delta, tr.c1, tr.c2)
        if args.evolution_gif:
            _write_gif(args, img, _fixed_frames(args, u0, p, lam1, lam2))
    else:
        if args.pyramid:
            from .models.pyramid import segment_pyramid

            res = segment_pyramid(u0, p, levels=_levels(args), lambda1=lam1,
                                  lambda2=lam2)
            _log(args, f"pyramid per-level iters (coarse -> fine): "
                       f"{res.level_iters}")
        elif args.color:
            res = segment_vector(u0, p, lambda1=lam1, lambda2=lam2)
        elif (not args.no_fused and u0.device.type == "cuda"
                and args.order == "redblack"):
            # the kernels implement red-black only; the banded driver
            # falls back to the fused kernel, then the plain path, off
            # its envelope (the reference's routing: --color never
            # reaches this branch)
            res = segment_banded(u0, p)
        else:
            res = segment(u0, p)
        mask, iters, c1, c2 = res.mask, res.iters, res.c1, res.c2
    c1, c2 = _means(c1, c2)
    if _diverged(iters, c1, c2):
        return 1
    _log(args, f"converged in {iters} iters; c1={c1}, c2={c2}")
    _write_mask(args, img, mask)
    return 0


def _checkpointed(args, img, u0, p: CVParams, lam1, lam2) -> int:
    """--iters with --checkpoint-dir, unsharded: ``.npz`` checkpoints."""
    from .utils import checkpoint as ckpt

    _warn_dropped(args, "checkpointed", ("--trace-energy", args.trace_energy),
                  ("--evolution-gif", args.evolution_gif))
    phi = ckpt.segment_with_checkpoints(
        u0, p, iters=args.iters, ckpt_dir=args.checkpoint_dir,
        every=args.checkpoint_every, lambda1=lam1, lambda2=lam2)
    if _diverged(args.iters, phi):
        return 1
    _log(args, f"checkpointed run: {args.iters} iters -> "
               f"{args.checkpoint_dir}")
    _write_mask(args, img, phi >= 0)
    return 0


def _sharded(args, img, u0, p: CVParams, lam1, lam2) -> int:
    """The --mesh branch (the two-phase PDE, gray or --color): tolerance
    mode, or exactly --iters iterations (traced, checkpointed or plain)."""
    from .parallel import segment_sharded, segment_sharded_fixed_trace
    from .utils import trace as trace_util

    mesh = _mesh(args, u0)
    kw = dict(lambda1=lam1, lambda2=lam2, use_pallas=_use_pallas(args),
              halo=args.halo)
    # the comm_k the main run takes: the trace has no comm_k variant
    run_k = args.comm_k
    if args.iters is None:
        if args.pyramid:
            from .models.pyramid import segment_pyramid_sharded

            res = segment_pyramid_sharded(u0, p, mesh, levels=_levels(args),
                                          comm_k=args.comm_k, **kw)
            _log(args, f"pyramid per-level iters (coarse -> fine): "
                       f"{res.level_iters}")
        else:
            res = segment_sharded(u0, p, mesh, fixed=False,
                                  comm_k=args.comm_k, **kw)
        mask, iters, c1, c2 = res.mask, res.iters, res.c1, res.c2
    elif args.trace_energy:
        _warn_dropped(args, "sharded traced",
                      ("--checkpoint-dir", args.checkpoint_dir),
                      ("--comm-k", args.comm_k > 1))
        run_k = 1
        tr = segment_sharded_fixed_trace(u0, p, mesh, iters=args.iters, **kw)
        trace_util.write_energy_csv(args.trace_energy, tr.energy, tr.delta,
                                    tr.c1, tr.c2)
        mask, iters, c1, c2 = tr.mask, args.iters, tr.c1[-1], tr.c2[-1]
    elif args.checkpoint_dir and args.color:
        _warn_dropped(args, "sharded color",
                      ("--checkpoint-dir", args.checkpoint_dir))
        run_k = 1
        res = segment_sharded(u0, p, mesh, max_iter=args.iters, fixed=True,
                              **kw)
        mask, iters, c1, c2 = res.mask, args.iters, res.c1, res.c2
    elif args.checkpoint_dir:
        from .utils.checkpoint_sharded import segment_sharded_with_checkpoints

        res = segment_sharded_with_checkpoints(
            u0, p, mesh, iters=args.iters, ckpt_dir=args.checkpoint_dir,
            every=args.checkpoint_every, use_pallas=_use_pallas(args),
            halo=args.halo, comm_k=args.comm_k)
        _log(args, f"sharded checkpointed run -> {args.checkpoint_dir}")
        mask, iters, c1, c2 = res.mask, args.iters, res.c1, res.c2
    else:
        res = segment_sharded(u0, p, mesh, max_iter=args.iters, fixed=True,
                              comm_k=args.comm_k, **kw)
        mask, iters, c1, c2 = res.mask, args.iters, res.c1, res.c2
    if args.iters is not None and args.evolution_gif:
        _write_gif(args, img, _sharded_frames(args, u0, p, mesh, lam1, lam2,
                                              run_k))
    c1, c2 = _means(c1, c2)
    if _diverged(iters, c1, c2):
        return 1
    _log(args, f"sharded over {args.mesh[0]}x{args.mesh[1]} mesh; {iters} "
               f"iters; c1={c1}, c2={c2}")
    _write_mask(args, img, mask)
    return 0


def _multiphase(args, img, u0, p: CVParams) -> int:
    """The --multiphase branch: tolerance mode or --iters, labels out."""
    from .models.multiphase import (segment_multiphase,
                                    segment_multiphase_fixed)
    from .utils import image_io, trace as trace_util

    use_pallas = _use_pallas(args)
    fixed = args.iters is not None
    if args.mesh is not None:
        from .parallel import (segment_multiphase_sharded,
                               segment_multiphase_sharded_fixed_trace)

        mesh = _mesh(args, u0)
        kw = dict(m_sets=args.multiphase, use_pallas=use_pallas,
                  halo=args.halo)
        run_k = args.comm_k
        if not fixed:
            res = segment_multiphase_sharded(u0, p, mesh, comm_k=args.comm_k,
                                             **kw)
            labels, iters, signals = res.labels, res.iters, (res.cs,)
        elif args.trace_energy:
            _warn_dropped(args, "sharded multiphase traced",
                          ("--checkpoint-dir", args.checkpoint_dir),
                          ("--comm-k", args.comm_k > 1))
            run_k = 1
            tr = segment_multiphase_sharded_fixed_trace(
                u0, p, mesh, iters=args.iters, **kw)
            trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                        tr.delta)
            labels, iters, signals = tr.labels, args.iters, (tr.energy[-1],)
        elif args.checkpoint_dir:
            from .utils.checkpoint_sharded import (
                segment_multiphase_sharded_with_checkpoints)

            _warn_dropped(args, "sharded multiphase checkpointed",
                          ("--comm-k", args.comm_k > 1))
            run_k = 1
            res = segment_multiphase_sharded_with_checkpoints(
                u0, p, mesh, iters=args.iters, ckpt_dir=args.checkpoint_dir,
                every=args.checkpoint_every, **kw)
            labels, iters, signals = res.labels, args.iters, (res.cs,)
            _log(args, f"multiphase sharded checkpointed run -> "
                       f"{args.checkpoint_dir}")
        else:
            res = segment_multiphase_sharded(u0, p, mesh, max_iter=args.iters,
                                             fixed=True, comm_k=args.comm_k,
                                             **kw)
            labels, iters, signals = res.labels, args.iters, (res.cs,)
        if fixed and args.evolution_gif:
            _write_gif(args, img, _multiphase_sharded_frames(args, u0, p,
                                                             mesh, run_k))
        path = f"multiphase sharded {args.mesh[0]}x{args.mesh[1]}"
    elif fixed and args.checkpoint_dir:
        from .utils.checkpoint import segment_multiphase_with_checkpoints

        _warn_dropped(args, "multiphase checkpointed",
                      ("--trace-energy", args.trace_energy),
                      ("--evolution-gif", args.evolution_gif))
        res = segment_multiphase_with_checkpoints(
            u0, p, iters=args.iters, ckpt_dir=args.checkpoint_dir,
            every=args.checkpoint_every, m_sets=args.multiphase)
        labels, iters, signals = res.labels, args.iters, (res.cs,)
        _log(args, f"multiphase checkpointed run -> {args.checkpoint_dir}")
        path = "multiphase"
    elif fixed:
        _warn_dropped(args, "unsharded multiphase",
                      ("--evolution-gif", args.evolution_gif))
        tr = segment_multiphase_fixed(u0, p, iters=args.iters,
                                      m_sets=args.multiphase,
                                      use_pallas=use_pallas)
        if args.trace_energy:
            trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                        tr.delta)
        labels, iters, signals = tr.labels, args.iters, (tr.energy[-1],)
        path = "multiphase"
    elif args.pyramid:
        from .models.pyramid import segment_pyramid_multiphase

        res = segment_pyramid_multiphase(u0, p, m_sets=args.multiphase,
                                         levels=_levels(args))
        labels, iters, signals = res.labels, res.iters, (res.cs, res.delta)
        _log(args, f"pyramid levels: {res.level_iters} iters coarse->fine")
        path = "multiphase"
    else:
        res = segment_multiphase(u0, p, m_sets=args.multiphase,
                                 use_pallas=use_pallas)
        labels, iters, signals = res.labels, res.iters, (res.cs, res.delta)
        path = "multiphase"
    if _diverged(iters, *signals):
        return 1
    _log(args, f"{path}: {2 ** args.multiphase} phases, {iters} iters")
    labels = labels.cpu().numpy()
    if args.output:
        image_io.save_labels(args.output, labels)
    if args.overlay:
        image_io.save_overlay(args.overlay, img, labels % 2 == 1)
    return 0


def _morph(args, img, u0, p: CVParams, lam1, lam2) -> int:
    """The --morph branch (MorphACWE): tolerance mode or --iters."""
    from .models.morph import segment_morph, segment_morph_fixed
    from .utils import trace as trace_util

    _warn_dropped(args, "morphological",
                  ("--checkpoint-dir", args.checkpoint_dir))
    kw = dict(smoothing=args.morph_smoothing, lambda1=lam1, lambda2=lam2)
    if args.pyramid:
        from .models.pyramid import segment_pyramid_morph
        from .ops.morph import binary_means

        res = segment_pyramid_morph(u0, p, levels=args.pyramid, **kw)
        _log(args, f"pyramid levels (coarse->fine iters): {res.level_iters}")
        c1, c2 = binary_means(u0, res.ls)
        mask, iters, delta = res.mask, res.iters, res.delta
    elif args.iters is not None:
        # with --mesh too: the reference's sharded fixed run equals the
        # unsharded one
        tr = segment_morph_fixed(u0, p, iters=args.iters, **kw)
        mask, iters = tr.mask, args.iters
        c1, c2, delta = tr.c1[-1], tr.c2[-1], tr.delta[-1]
        if args.trace_energy:
            trace_util.write_energy_csv(args.trace_energy, tr.energy,
                                        tr.delta, tr.c1, tr.c2)
        if args.evolution_gif:
            _write_gif(args, img, _morph_frames(args, u0, p, kw))
    elif args.mesh is not None:
        if args.comm_k > 1:
            from .parallel.sharded_morph import segment_morph_sharded_chunked

            res = segment_morph_sharded_chunked(
                u0, p, mesh=_mesh(args, u0), comm_k=args.comm_k,
                use_pallas=_use_pallas(args), **kw)
        else:
            from .models.morph import segment_morph_sharded

            res = segment_morph_sharded(u0, p, mesh=_mesh(args, u0), **kw)
        mask, iters, c1, c2, delta = (res.mask, res.iters, res.c1, res.c2,
                                      res.delta)
    else:
        res = segment_morph(u0, p, use_pallas=_use_pallas(args), **kw)
        mask, iters, c1, c2, delta = (res.mask, res.iters, res.c1, res.c2,
                                      res.delta)
    if _diverged(iters, c1, c2, delta):
        return 1
    c1, c2 = _means(c1, c2)
    _log(args, f"morphACWE: {iters} iters; c1={c1}, c2={c2}")
    _write_mask(args, img, mask)
    return 0


def _morph_gac(args, img, u0, p: CVParams) -> int:
    """The --morph-gac branch (MorphGAC on the image's edge map)."""
    from .models.morph_gac import segment_gac, segment_gac_fixed
    from .ops.morph import inverse_gaussian_gradient

    _warn_dropped(args, "morphological-GAC",
                  ("--checkpoint-dir", args.checkpoint_dir),
                  ("--trace-energy", args.trace_energy))
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
        _log(args, f"pyramid levels (coarse->fine iters): {res.level_iters}")
        mask, iters, delta = res.mask, res.iters, res.delta
    elif args.iters is not None:
        tr = segment_gac_fixed(g, p, iters=args.iters, **kw)
        mask, iters, delta = tr.mask, args.iters, tr.delta[-1]
        if args.evolution_gif:
            _write_gif(args, img, _gac_frames(args, g, p, kw))
    elif args.mesh is not None:
        if args.comm_k > 1:
            from .parallel.sharded_morph import segment_gac_sharded_chunked

            res = segment_gac_sharded_chunked(
                g, p, mesh=_mesh(args, u0), comm_k=args.comm_k,
                use_pallas=_use_pallas(args), **kw)
        else:
            from .models.morph_gac import segment_gac_sharded

            res = segment_gac_sharded(g, p, mesh=_mesh(args, u0), **kw)
        mask, iters, delta = res.mask, res.iters, res.delta
    else:
        res = segment_gac(g, p, use_pallas=_use_pallas(args), **kw)
        mask, iters, delta = res.mask, res.iters, res.delta
    if _diverged(iters, delta):
        return 1
    _log(args, f"morphGAC: {iters} iters; balloon={args.balloon}, "
               f"threshold={thr:.4g}")
    _write_mask(args, img, mask)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
