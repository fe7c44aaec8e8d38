"""Level-set initialization, image I/O and visualization (masks, label
maps, contour overlays, evolution GIFs), energy traces, ``.npz``
checkpoints (``checkpoint``) and their sharded form on
``torch.distributed.checkpoint`` (``checkpoint_sharded``, imported on
use), and the profiling and timing harness."""

from .init_phi import checkerboard, circle, init_phi, rect
from . import checkpoint, image_io, profiling, trace

__all__ = ["init_phi", "checkerboard", "circle", "rect",
           "image_io", "trace", "checkpoint", "profiling"]
