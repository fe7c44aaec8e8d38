"""Parameter set for Chan–Vese segmentation (PyTorch port).

Field for field the same frozen dataclass as ``chan_vese_tpu.params``: same
names, defaults, ``replace`` and ``channel_lambdas``. The port keeps its own
copy because the JAX package imports jax on import; a test pins the two
classes to each other.

This system has no weights. Its state is this parameter set plus numpy
arrays (``u0``, ``phi0``), which enter the port through ``torch.from_numpy``;
:meth:`CVParams.from_reference` carries the parameters across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CVParams:
    """Chan–Vese model + solver parameters.

    Operating point: intensities in [0, 255] with lambda1 = lambda2 = 1 and
    mu of order 0.01-0.25 times 255^2 (Chan-Vese 2001). Images in [0, 1]
    need mu/nu scaled by (1/255)^2.

    Attributes:
      mu: weight of the contour-length penalty (curvature term).
      nu: weight of the inside-area penalty.
      lambda1: weight of the inside data-fitting term (u0 - c1)^2.
      lambda2: weight of the outside data-fitting term (u0 - c2)^2.
      dt: time step of the semi-implicit update.
      eps: regularization width of the Heaviside/Dirac.
      tol: per-pixel convergence tolerance on the update metric.
      max_iter: iteration cap.
      min_iter: never declare convergence before this many iterations.
      patience: the update metric must stay below tol for this many
        consecutive iterations.
      eta2: curvature-denominator regularizer inside the sqrt.
      conv_norm: 'flips' (fraction of mask sign changes), 'rms' or
        'mean_abs'.
      reinit_every: if > 0, redistance phi every K iterations
        (ops/reinit.py).
      reinit_steps: upwind redistancing steps per reinit call.
      order: 'redblack' | 'jacobi' | 'wavefront' (exact raster
        Gauss-Seidel, parity mode).
      init: 'checkerboard' | 'circle' ('disk') | 'small disk' | 'rect'.
    """

    mu: float = 0.01 * 255.0 ** 2
    nu: float = 0.0
    lambda1: float = 1.0
    lambda2: float = 1.0
    dt: float = 0.5
    eps: float = 1.0
    tol: float = 1e-5
    max_iter: int = 500
    eta2: float = 1e-8
    conv_norm: str = "flips"
    min_iter: int = 5
    patience: int = 3
    order: str = "redblack"
    init: str = "checkerboard"
    reinit_every: int = 0
    reinit_steps: int = 20

    def replace(self, **kw) -> "CVParams":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_reference(cls, obj: Any) -> "CVParams":
        """Copy every field from a ``chan_vese_tpu`` CVParams or its
        ``dataclasses.asdict``. A missing or unknown field raises."""
        if isinstance(obj, Mapping):
            src = dict(obj)
        else:
            src = {f.name: getattr(obj, f.name)
                   for f in dataclasses.fields(obj)}
        names = {f.name for f in dataclasses.fields(cls)}
        if set(src) != names:
            raise ValueError(f"field mismatch: missing {names - set(src)}, "
                             f"unknown {set(src) - names}")
        return cls(**src)

    def channel_lambdas(self, nchan: int,
                        lambda1: Optional[Tuple[float, ...]] = None,
                        lambda2: Optional[Tuple[float, ...]] = None,
                        ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        """Per-channel lambda weights for the vector-valued energy.

        Falls back to broadcasting the scalar lambda1/lambda2 when no
        per-channel weights are given (Chan-Sandberg-Vese 2000).
        """
        def norm(lam, default):
            if lam is None:
                return (default,) * nchan
            try:
                return tuple(float(v) for v in lam)
            except TypeError:  # scalar: broadcast
                return (float(lam),) * nchan

        l1 = norm(lambda1, self.lambda1)
        l2 = norm(lambda2, self.lambda2)
        # a length-1 tuple is a scalar in sequence clothing
        if len(l1) == 1 and nchan > 1:
            l1 = l1 * nchan
        if len(l2) == 1 and nchan > 1:
            l2 = l2 * nchan
        if len(l1) != nchan or len(l2) != nchan:
            raise ValueError(
                f"per-channel lambdas must have length {nchan}, "
                f"got {len(l1)} / {len(l2)}")
        return l1, l2


DEFAULTS = CVParams()
