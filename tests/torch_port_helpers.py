"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference: conversions through numpy, the comparison bars, and the digests
that pin the card bodies' outputs (:func:`assert_digest`).

Importing this module pins torch to one thread, since the suite runs
several pytest workers on a few CPUs.
"""

import functools
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chan_vese_tpu.params as jparams
import chan_vese_tpu_torch as ct

torch.set_num_threads(1)


def to_torch(x, dtype=np.float64):
    """numpy (or JAX) array -> CPU torch tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype)))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def params(**kw):
    """(JAX CVParams, port CVParams) with the same fields."""
    pj = jparams.CVParams(**kw)
    return pj, ct.CVParams.from_reference(pj)


def assert_rel(got, want, rtol):
    """max |got - want| <= rtol * max |want| (relative to the field's
    scale, so cells near zero do not dominate)."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, (err, rtol * scale)


def cuda_device():
    """The first CUDA device; skips the calling test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


# sha256 digests of the card bodies' outputs on the cuda-marked cases that
# hold a body bitwise, recorded on an NVIDIA H100 from the bodies that the
# present ones replaced (CHANGES.md names the commit and the run)
DIGESTS_FILE = Path(__file__).with_name("card_digests.json")


@functools.lru_cache(maxsize=1)
def _digests():
    return json.loads(DIGESTS_FILE.read_text())


def digest(*tensors) -> str:
    """sha256 of the tensors' dtypes, shapes and bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{t.dtype} {tuple(t.shape)};".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def assert_digest(key: str, *tensors):
    """The tensors (a level set and its flips slot, say) are bitwise the
    output recorded under ``key`` in card_digests.json; a key with no
    recorded digest fails."""
    want = _digests().get(key)
    if want is None:
        pytest.fail(f"no digest recorded for {key!r} in {DIGESTS_FILE.name}")
    assert digest(*tensors) == want, f"{key}: not the recorded output"
