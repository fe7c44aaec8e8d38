"""Plain PyTorch ops and the red-black kernels (fused, banded, packed)."""
