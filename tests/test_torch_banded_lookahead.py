"""``segment_banded``'s tolerance loop, which queues the next chunk before it
reads the last one's stop metric, against a loop that drives the same
``_Chunker`` one chunk at a time, reading before it queues: phi, mask,
iterations, delta and means bitwise, on every way a run can stop, with
the chunks queued ahead and thrown away counted. The card's test holds
K3 (packed 4K gray) and K6 (4K RGB) to the same loop and reads the last
chunk's pinned copy. No JAX here: the card runs this file too."""

import math
import sys

import numpy as np
import pytest
import torch

from chan_vese_tpu_torch import cli
from chan_vese_tpu_torch.models import banded
from chan_vese_tpu_torch.models.scalar import SegResult
from chan_vese_tpu_torch.params import CVParams
from fixtures import colored_squares, two_disks

SHAPE = (64, 256)
P = CVParams(tol=1e-4, max_iter=200, min_iter=10)
TOL32 = float(np.float32(1e-4))  # 1e-4 rounded to float32: just below it


def one_at_a_time(u0, p, k=8, packed=None):
    """The stop loop read before queue: chunk n's stop metric read (and
    read again for divergence) before chunk n + 1 is queued. Returns the
    result and the stop metric of every chunk run, as floats."""
    k, unroll, packed, fuse, p, l1, l2, ok = banded._route(
        u0, p, k, None, packed, None, None, None)
    assert ok
    ch = banded._Chunker(u0, p, banded._phi0(u0, p, None), k, unroll,
                         packed, fuse, l1, l2)
    delta = torch.tensor(math.inf, dtype=u0.dtype, device=u0.device)
    n, streak, values = 0, 0, []
    full = (p.max_iter // k) * k
    rem = p.max_iter - full

    def not_stopped():
        done = streak >= p.patience and n >= p.min_iter
        if n == 0:
            return not done
        return not (done or not math.isfinite(float(delta)))

    def next_size():
        if n < full and not_stopped():
            return k
        if rem and n < p.max_iter and not_stopped():
            return rem
        return 0

    size = next_size()
    while size:
        parts = ch.run(size)
        delta = banded._delta_from_partials(parts, ch.n_pix, p, ch.offset)
        values.append(float(delta))
        streak = streak + size if bool(delta < p.tol) else 0
        n += size
        size = next_size()
    phi = ch.image()
    return SegResult(phi, phi >= 0, n, delta, ch.c1, ch.c2), values


def _bits(t):
    """``t`` as integers of its width, so NaNs compare too."""
    return t.contiguous().view({torch.float32: torch.int32,
                                torch.float64: torch.int64}.get(
                                    t.dtype, t.dtype))


def assert_same_run(got, want):
    assert got.iters == want.iters
    for a, b in zip((got.phi, got.mask, got.delta, got.c1, got.c2),
                    (want.phi, want.mask, want.delta, want.c1, want.c2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def _counted(fn):
    """fn's output and how many chunks it queued ahead and threw away."""
    before = (banded.segment_banded.ahead, banded.segment_banded.discarded)
    out = fn()
    return out, (banded.segment_banded.ahead - before[0],
                 banded.segment_banded.discarded - before[1])


@pytest.fixture(scope="module")
def images():
    gray, _ = two_disks(*SHAPE, noise=6.0)
    gray = torch.from_numpy(gray.astype(np.float32))
    rgb, _ = colored_squares(*SHAPE, noise=6.0)
    bad = gray.clone()
    bad[3, 5] = float("nan")
    return {"gray": gray, "rgb": torch.from_numpy(rgb.astype(np.float32)),
            "nan": bad}


# every case with k = 8
CASES = {
    # the streak of below-tol chunks reaches patience
    "tol": P.replace(tol=5e-4),
    # patience > k: the streak spans chunks (RGB's also starts again)
    "patience": P.replace(tol=1e-3, patience=20),
    # min_iter holds the run past below-tol chunks
    "min_iter": P.replace(tol=5e-4, min_iter=120),
    # the cap with a remainder chunk: 8 + 8 + 4, nothing queued past it
    "max_iter": P.replace(tol=-1.0, max_iter=20),
    # a start the stop already meets: no chunk at all
    "no_chunk": P.replace(patience=0, min_iter=0),
}


@pytest.mark.parametrize("image", ["gray", "rgb"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lookahead_matches_one_at_a_time(images, image, case):
    p = CASES[case]
    u0 = images[image]
    want, values = one_at_a_time(u0, p)
    got, (ahead, discarded) = _counted(
        lambda: banded.segment_banded(u0, p, k=8))
    assert_same_run(got, want)
    chunks = len(values)
    schedule = -(-p.max_iter // 8)
    assert chunks == -(-got.iters // 8)
    # a chunk is queued ahead in every step with a next chunk in the
    # schedule; one thrown away at a stop before the schedule's end
    early = chunks < schedule
    assert discarded == (early and chunks > 0)
    assert ahead == (chunks if early else max(chunks - 1, 0))
    below = [v < float(np.float32(p.tol)) for v in values]
    if case == "max_iter":
        assert got.iters == 20 and chunks == 3
    elif case == "no_chunk":
        assert got.iters == 0 and math.isinf(float(got.delta))
    else:
        assert early and below[-1]
    if case == "patience":
        # more than two chunks below tol in a row before the stop
        assert all(below[-3:])
    if case == "min_iter":
        first = below.index(True)
        assert (first + 1) * 8 < p.min_iter <= got.iters


@pytest.mark.parametrize("packed", [False, True])
def test_diverged_run_stops_and_reports(images, packed):
    """A NaN in the image: the first chunk's metric is NaN, the run stops
    there with the chunk ahead thrown away, and its means tell the CLI to
    exit 1."""
    p = P.replace(max_iter=40)
    want, values = one_at_a_time(images["nan"], p, packed=packed)
    got, (ahead, discarded) = _counted(
        lambda: banded.segment_banded(images["nan"], p, k=8, packed=packed))
    assert_same_run(got, want)
    assert got.iters == 8 and math.isnan(values[0])
    assert (ahead, discarded) == (1, 1)
    assert cli._diverged(got.iters, got.c1, got.c2)


# stop metrics given to both loops, chunk by chunk (then 1.0): the host's
# verdict must be the device's ``delta < tol``, in float32
SCRIPTS = {
    # float32(1e-4) < 1e-4 in float64, not in float32: never below
    "at_tol32": [TOL32] * 30,
    # the float32 just below it is below: a stop after patience
    "below_tol32": [float(np.nextafter(np.float32(1e-4), np.float32(0)))]
    * 30,
    # below, then above: the streak starts again
    "streak_reset": [1e-5, 1.0, 1e-5, 1.0, 1e-5, 1e-5],
    "inf": [1.0, math.inf],
    "nan": [1.0, 1e-5, math.nan],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_host_verdict_is_the_devices(images, monkeypatch, script):
    values = SCRIPTS[script]
    real = banded._delta_from_partials
    calls = []

    def scripted(parts, n_pixels, p, offset=0):
        d = real(parts, n_pixels, p, offset)
        if not isinstance(n_pixels, torch.Tensor):
            return d  # the set-up's check of conv_norm
        calls.append(1)
        i = len(calls) - 1
        return torch.full_like(d, values[i] if i < len(values) else 1.0)

    monkeypatch.setattr(banded, "_delta_from_partials", scripted)
    p = P.replace(max_iter=64, min_iter=0, patience=16)
    want, seen = one_at_a_time(images["gray"], p)
    del calls[:]
    got, (ahead, discarded) = _counted(
        lambda: banded.segment_banded(images["gray"], p, k=8))
    assert_same_run(got, want)
    stops = {"at_tol32": 64, "below_tol32": 16, "streak_reset": 48,
             "inf": 16, "nan": 24}
    assert got.iters == stops[script]
    assert len(calls) == len(seen) + discarded
    assert discarded == (got.iters < 64)


def _pinned_reads(monkeypatch):
    """The numbers ``models/banded.py`` reads with ``float``, and whether
    each came from pinned host memory."""
    reads = []
    orig = torch.Tensor.__float__

    def read(self):
        value = orig(self)
        if sys._getframe(1).f_code.co_filename == banded.__file__:
            reads.append((value, self.device.type == "cpu"
                          and self.is_pinned()))
        return value
    monkeypatch.setattr(torch.Tensor, "__float__", read)
    return reads


@pytest.mark.cuda
@pytest.mark.parametrize("image", ["gray", "rgb"])
def test_cuda_lookahead_matches_one_at_a_time(monkeypatch, image):
    """4K on the card: K3 on packed planes (gray), K6 (RGB); the answer
    bitwise the one-at-a-time loop's, every read from a pinned slot, the
    last one the number the loop's ``float(delta)`` gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    if image == "gray":
        img, _ = two_disks(2160, 3840, noise=5.0, dtype=np.float32)
        launcher = "packed_banded_chunk"
    else:
        img, _ = colored_squares(2160, 3840, noise=5.0, dtype=np.float32)
        launcher = "packed_banded_chunk_mc"
    u0 = torch.from_numpy(img).to(dev)
    p = CVParams(tol=1e-4, patience=4, min_iter=4, max_iter=400,
                 init="circle")
    assert banded._route(u0, p, None, None, None, None, None, None)[2]
    want, values = one_at_a_time(u0, p, k=None)
    from chan_vese_tpu_torch.ops import packed_kernel
    launches = getattr(packed_kernel, launcher).launches
    reads = _pinned_reads(monkeypatch)
    got, (ahead, discarded) = _counted(lambda: banded.segment_banded(u0, p))
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert_same_run(got, want)
    assert getattr(packed_kernel, launcher).launches - launches == (
        len(values) + discarded)
    assert [v for v, _ in reads] == values
    assert all(pinned for _, pinned in reads)
    assert reads[-1][0] == float(want.delta) == float(got.delta)
    assert ahead == len(values) - 1 + discarded


@pytest.mark.cuda
def test_cuda_cli_diverged_exit_code(tmp_path):
    """The CLI's default route on the card (``segment_banded``) on a NaN
    image: exit code 1, nothing written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    inp = tmp_path / "bad.npy"
    np.save(inp, np.full((64, 256), np.nan, np.float32))
    out = tmp_path / "mask.npy"
    ahead = banded.segment_banded.ahead
    assert cli.main([str(inp), "-o", str(out), "--quiet"]) == 1
    assert banded.segment_banded.ahead > ahead
    assert not out.exists()
