"""Drop-in convenience entry points with scikit-image's argument surface.

Counterpart of ``chan_vese_tpu/compat.py``. ``chan_vese(image, ...)``
returns the binary mask (and optionally the full result);
``morphological_chan_vese`` and ``morphological_geodesic_active_contour``
mirror the sibling scikit-image functions (models/morph.py,
models/morph_gac.py), with ``checkerboard_level_set`` / ``disk_level_set``
as their named starts and ``inverse_gaussian_gradient`` as the MorphGAC
preprocessor. Inputs and outputs are numpy arrays.

Every function that computes takes ``device`` (default ``"cuda"``); it
raises when torch finds no GPU rather than falling back, and
``device="cpu"`` runs the plain PyTorch versions. Routing is the
reference's: ``chan_vese`` takes the per-iteration fused driver (K1, K4)
on the card and the plain driver elsewhere; ``morphological_chan_vese``
runs the plain per-iteration driver; ``morphological_geodesic_active_
contour`` the lean driver, which reaches K11 on the card.

Intensity convention: [0, 255] is the canonical operating point (see
CVParams); ``normalize='255'`` (default) rescales [0, 1] float inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch finds no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _channel_lambdas(img, lambda1, lambda2):
    """Per-channel lambda tuples for an (H, W, C) image (a single value
    broadcast), floats for a gray one."""
    if img.ndim != 3:
        return (float(np.atleast_1d(lambda1)[0]),
                float(np.atleast_1d(lambda2)[0]))
    l1 = tuple(np.atleast_1d(lambda1).astype(float))
    l2 = tuple(np.atleast_1d(lambda2).astype(float))
    c = img.shape[-1]
    return (l1 * c if len(l1) == 1 else l1), (l2 * c if len(l2) == 1 else l2)


def chan_vese(image,
              mu: float = 0.01 * 255.0 ** 2,
              nu: float = 0.0,
              lambda1=1.0,
              lambda2=1.0,
              tol: float = 1e-5,
              max_num_iter: int = 500,
              dt: float = 0.5,
              eps: float = 1.0,
              init_level_set="checkerboard",
              normalize: Optional[str] = "255",
              extended_output: bool = False,
              device="cuda"):
    """Segment ``image`` (2D grayscale or 3D HxWxC) with Chan-Vese.

    Returns the boolean mask, or (mask, phi, result) with
    extended_output=True. Floats in [0, 1] are rescaled to [0, 255] when
    normalize='255' and max(image) <= 1. ``init_level_set``: a named
    shape ('checkerboard' | 'circle'/'disk' | 'small disk' | 'rect') or a
    custom (H, W) array used directly as phi0."""
    from .models.fused import segment_fused
    from .models.scalar import segment
    from .params import CVParams

    dev = _device(device)
    img = np.array(image, np.float32)
    if normalize == "255" and img.size and float(img.max()) <= 1.0:
        img = img * 255.0

    vector = img.ndim == 3
    if not vector and (len(np.atleast_1d(lambda1)) > 1
                       or len(np.atleast_1d(lambda2)) > 1):
        raise ValueError("per-channel lambda weights need an (H, W, C) "
                         "image")
    l1, l2 = _channel_lambdas(img, lambda1, lambda2) if vector else (None,
                                                                     None)
    phi0 = None
    init_kind = init_level_set
    if not isinstance(init_level_set, str):
        phi0 = torch.from_numpy(np.asarray(init_level_set, img.dtype)).to(dev)
        if tuple(phi0.shape) != img.shape[:2]:
            raise ValueError(
                f"init_level_set array shape {tuple(phi0.shape)} does not "
                f"match image spatial shape {img.shape[:2]}")
        init_kind = "checkerboard"  # unused when phi0 is given

    p = CVParams(mu=mu, nu=nu,
                 lambda1=float(np.atleast_1d(lambda1)[0]),
                 lambda2=float(np.atleast_1d(lambda2)[0]),
                 dt=dt, eps=eps, tol=tol, max_iter=max_num_iter,
                 init=init_kind)
    u0 = torch.from_numpy(img).to(dev)
    run = segment_fused if dev.type == "cuda" else segment
    res = run(u0, p, phi0, lambda1=l1, lambda2=l2)
    mask = res.mask.cpu().numpy()
    if extended_output:
        return mask, res.phi.cpu().numpy(), res
    return mask


def checkerboard_level_set(image_shape, square_size: int = 5):
    """Binary checkerboard of square_size x square_size tiles (int8), the
    published MorphACWE default start: XOR of per-axis tile parities."""
    i, j = np.ogrid[:image_shape[0], :image_shape[1]]
    return np.int8(((i // square_size) + (j // square_size)) % 2)


def disk_level_set(image_shape, center=None, radius=None):
    """Binary disk (int8); defaults: centered, radius = 3/8 min(shape)."""
    if center is None:
        center = tuple(s // 2 for s in image_shape[:2])
    if radius is None:
        radius = min(image_shape[:2]) * 3.0 / 8.0
    i, j = np.ogrid[:image_shape[0], :image_shape[1]]
    r2 = (i - center[0]) ** 2 + (j - center[1]) ** 2
    return np.int8(r2 < radius * radius)


def _start(init_level_set, shape, named):
    """The float32 {0, 1} start: a named shape from ``named`` or a custom
    array of the image's spatial shape."""
    if isinstance(init_level_set, str):
        if init_level_set not in named:
            raise ValueError(f"unknown init_level_set {init_level_set!r}")
        ls = named[init_level_set](shape)
    else:
        ls = np.asarray(init_level_set)
        if ls.shape != shape:
            raise ValueError(
                f"init_level_set shape {ls.shape} does not match the "
                f"image's spatial shape {shape}")
    return np.asarray(ls, np.float32)


def _run_with_callback(fixed, num_iter, ls, iter_callback, **kw):
    """One fixed-driver call per iteration, ``iter_callback`` on the start
    and after every iteration with the int8 level set."""
    iter_callback(np.asarray(ls.cpu(), np.int8))
    for n in range(int(num_iter)):
        ls = fixed(iters=1, ls0=ls, start_iter=n, **kw).ls
        iter_callback(np.asarray(ls.cpu(), np.int8))
    return np.asarray(ls.cpu(), np.int8)


def morphological_chan_vese(image, num_iter: int,
                            init_level_set="checkerboard",
                            smoothing: int = 1,
                            lambda1=1.0, lambda2=1.0,
                            iter_callback=None, device="cuda"):
    """MorphACWE with the scikit-image argument surface: EXACTLY
    ``num_iter`` iterations of the plain per-iteration driver
    (``segment_morph_fixed``), returning the int8 level set. (H, W, C)
    images take per-channel lambda sequences. Edge convention:
    replica/Neumann (ops/morph.py) rather than ndimage's border_value=0.
    ``iter_callback(level_set)`` (optional) gets the start and every
    iteration's int8 level set (one device round trip each)."""
    from .models.morph import segment_morph_fixed
    from .params import CVParams

    dev = _device(device)
    img = np.array(image, np.float32)
    l1, l2 = _channel_lambdas(img, lambda1, lambda2)
    ls = torch.from_numpy(_start(
        init_level_set, img.shape[:2],
        {"checkerboard": checkerboard_level_set, "circle": disk_level_set,
         "disk": disk_level_set})).to(dev)
    kw = dict(p=CVParams(), smoothing=int(smoothing), lambda1=l1,
              lambda2=l2)
    u0 = torch.from_numpy(img).to(dev)
    if iter_callback is None:
        res = segment_morph_fixed(u0, iters=int(num_iter), ls0=ls, **kw)
        return np.asarray(res.ls.cpu(), np.int8)
    return _run_with_callback(
        lambda **a: segment_morph_fixed(u0, **a), num_iter, ls,
        iter_callback, **kw)


def inverse_gaussian_gradient(image, alpha: float = 100.0,
                              sigma: float = 5.0, device="cuda"):
    """Edge-stopping map 1/sqrt(1 + alpha |grad(G_sigma * image)|) as a
    float32 numpy array (the MorphGAC preprocessor): scipy's discretised
    Gaussian with replica edges, then central differences of the blurred
    plane. (H, W, C) images take the per-channel gradients' root sum of
    squares."""
    from .ops.morph import inverse_gaussian_gradient as _igg

    img = torch.from_numpy(np.array(image, np.float32)).to(_device(device))
    return _igg(img, float(alpha), float(sigma)).cpu().numpy()


def morphological_geodesic_active_contour(gimage, num_iter: int,
                                          init_level_set="disk",
                                          smoothing: int = 1,
                                          threshold="auto",
                                          balloon: int = 0,
                                          iter_callback=None,
                                          device="cuda"):
    """MorphGAC with the scikit-image argument surface. ``gimage`` is the
    preprocessed edge map (inverse_gaussian_gradient). Runs EXACTLY
    ``num_iter`` iterations and returns the int8 level set;
    threshold='auto' is gimage's 40th percentile. Without a callback the
    lean driver runs, on the card through K11 (its chunks are the
    per-iteration trajectory); ``iter_callback`` as in
    :func:`morphological_chan_vese`."""
    from .models.morph_gac import segment_gac_fixed, segment_gac_iterations
    from .params import CVParams

    dev = _device(device)
    g = np.array(gimage, np.float32)
    if g.ndim != 2:
        raise ValueError("gimage must be a 2D edge map "
                         "(inverse_gaussian_gradient output)")
    thr = (float(np.percentile(g, 40)) if threshold == "auto"
           else float(threshold))
    ls = torch.from_numpy(_start(
        init_level_set, g.shape,
        {"circle": disk_level_set, "disk": disk_level_set,
         "checkerboard": checkerboard_level_set})).to(dev)
    kw = dict(p=CVParams(), smoothing=int(smoothing), balloon=int(balloon),
              threshold=thr)
    gt = torch.from_numpy(g).to(dev)
    if iter_callback is None:
        res = segment_gac_iterations(gt, iters=int(num_iter), ls0=ls, **kw)
        return np.asarray(res.ls.cpu(), np.int8)
    return _run_with_callback(
        lambda **a: segment_gac_fixed(gt, **a), num_iter, ls, iter_callback,
        **kw)
