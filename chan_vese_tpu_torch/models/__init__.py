"""Segmentation drivers: scalar (plain), vector-valued, multiphase, batched,
fused (K1), banded (K2/K3), resident, morphological and the coarse-to-fine
pyramids. Counterpart of ``chan_vese_tpu/models``."""

from .scalar import SegResult, SegTrace, segment, segment_fixed, step
from .vector import segment_vector, segment_vector_fixed
from .multiphase import (MultiphaseResult, MultiphaseTrace,
                         segment_multiphase, segment_multiphase_fixed)
from .batched import (segment_batch, segment_stack_fixed,
                      segment_stack_fused_fixed)
from .fused import segment_fused, segment_fused_fixed
from .banded import segment_banded, segment_banded_fixed
from .pyramid import (MultiphasePyramidResult, PyramidResult,
                      segment_pyramid, segment_pyramid_multiphase,
                      segment_pyramid_sharded)
from .morph import (MorphResult, MorphTrace, segment_morph,
                    segment_morph_fixed, segment_morph_iterations,
                    segment_morph_sharded)

__all__ = [
    "segment", "segment_fixed", "step", "SegResult", "SegTrace",
    "segment_vector", "segment_vector_fixed",
    "segment_multiphase", "segment_multiphase_fixed",
    "MultiphaseResult", "MultiphaseTrace",
    "segment_batch", "segment_stack_fixed", "segment_stack_fused_fixed",
    "segment_fused", "segment_fused_fixed",
    "segment_banded", "segment_banded_fixed",
    "segment_pyramid", "PyramidResult",
    "segment_pyramid_multiphase", "MultiphasePyramidResult",
    "segment_pyramid_sharded",
    "segment_morph", "segment_morph_fixed", "segment_morph_sharded",
    "segment_morph_iterations",
    "MorphResult", "MorphTrace",
]
