"""chan_vese_tpu_torch: Chan-Vese segmentation in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

The port of ``chan_vese_tpu`` (the JAX reference, which stays beside it).
This package covers the grayscale and the vector-valued (RGB) main paths:
the plain PyTorch ops and drivers (``segment``, ``segment_fixed``,
``segment_vector``, ``segment_vector_fixed``), the per-iteration fused
driver over K1 (K4 for C channels), the banded drivers over K2/K3
(K5/K6) and the exact-means resident drivers over K7/K8
(``segment_resident``, ``segment_resident_fixed``,
``segment_stack_resident_fixed``), and multiphase segmentation
(``segment_multiphase``, ``segment_multiphase_fixed``) over K9/K10 and
K1's force mode, and the morphological family: MorphACWE
(``segment_morph``, ``segment_morph_fixed``, ``segment_morph_iterations``)
and MorphGAC (``segment_gac``, ``segment_gac_fixed``,
``segment_gac_iterations``) over K11 and K12, with the scikit-image
compatible front ends in ``compat``; and frame stacks (``segment_batch``,
``segment_stack_fixed``, ``segment_stack_fused_fixed`` over K1's batch
mode, and ``parallel.segment_stack_sharded`` over a data mesh); the
coarse-to-fine pyramids (``segment_pyramid`` and its multiphase, sharded,
MorphACWE and MorphGAC forms), the reinit cadence of every PDE driver
(``CVParams.reinit_every``) over the redistance kernel R1, and the
Perona-Malik pre-smoothing (``ops.perona_malik``). Every
packed route packs through K15/K16; K13 (``ops.packed_kernel.
packed_chunk``) is the layout A/B. CPU tensors run the plain PyTorch
versions of the kernels; CUDA tensors launch the kernels in ``csrc/``,
built with nvcc at first use. It never imports jax.
"""

from .params import CVParams, DEFAULTS
from .models.scalar import SegResult, SegTrace, segment, segment_fixed, step
from .models.vector import segment_vector, segment_vector_fixed
from .models.fused import segment_fused, segment_fused_fixed
from .models.banded import (auto_config, auto_config_mc, segment_banded,
                            segment_banded_fixed)
from .models.resident import (segment_resident, segment_resident_fixed,
                              segment_stack_resident_fixed)
from .models.batched import (segment_batch, segment_stack_fixed,
                             segment_stack_fused_fixed)
from .models.multiphase import (MultiphaseResult, segment_multiphase,
                                segment_multiphase_fixed)
from .models.morph import (MorphResult, MorphTrace, segment_morph,
                           segment_morph_fixed, segment_morph_iterations)
from .models.morph_gac import (GACResult, GACTrace, segment_gac,
                               segment_gac_fixed, segment_gac_iterations)
from .models.pyramid import (MorphPyramidResult, MultiphasePyramidResult,
                             PyramidResult, segment_pyramid,
                             segment_pyramid_gac, segment_pyramid_morph,
                             segment_pyramid_multiphase,
                             segment_pyramid_sharded)
from . import parallel

__all__ = [
    "CVParams", "DEFAULTS",
    "segment", "segment_fixed", "step", "SegResult", "SegTrace",
    "segment_vector", "segment_vector_fixed",
    "segment_fused", "segment_fused_fixed",
    "auto_config", "auto_config_mc", "segment_banded",
    "segment_banded_fixed",
    "segment_resident", "segment_resident_fixed",
    "segment_stack_resident_fixed",
    "segment_batch", "segment_stack_fixed", "segment_stack_fused_fixed",
    "segment_multiphase", "segment_multiphase_fixed", "MultiphaseResult",
    "segment_morph", "segment_morph_fixed", "segment_morph_iterations",
    "MorphResult", "MorphTrace",
    "segment_gac", "segment_gac_fixed", "segment_gac_iterations",
    "GACResult", "GACTrace",
    "segment_pyramid", "segment_pyramid_multiphase",
    "segment_pyramid_sharded", "segment_pyramid_morph",
    "segment_pyramid_gac", "PyramidResult", "MultiphasePyramidResult",
    "MorphPyramidResult",
    "parallel",
]

__version__ = "0.1.0"
