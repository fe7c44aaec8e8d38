"""Plain PyTorch ops and the red-black kernels (fused, banded, packed),
the redistance (R1) and the Perona-Malik pre-smoothing."""

from .reinit import reinit
from .diffusion import perona_malik

__all__ = ["reinit", "perona_malik"]
