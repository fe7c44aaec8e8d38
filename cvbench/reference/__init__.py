"""The plain reference: the Chan-Vese scheme in plain PyTorch
(:mod:`.numerics`), one module a trajectory class. It imports nothing of
the program under test and takes nothing it made: the same input image,
the configuration's parameters, and nothing else.

A trajectory class is the module ``reference/<trajectory>.py`` that the
``TRAJECTORY`` of an entry names. It has

- ``run(u0, params, cell, dtype)``: (phi, mask, iterations) of the
  reference on input ``u0`` of the cell, computed in ``dtype``;
- ``call_work(shape, iters, cell)``: (operations, bytes,
  pixel-iterations) of one call on an input of ``shape`` that ran
  ``iters`` iterations, counted with :mod:`cvbench.work`;
- optionally ``compare(out, ref)``: {number: value} of one call's answer
  against the reference's, where :func:`cvbench.check.compare` does not
  fit the answer's shape.

A later change adds a class by adding its module.
"""

from .. import spec


def trajectory(name: str):
    """The module of trajectory class ``name``."""
    return spec.module("reference", name)

