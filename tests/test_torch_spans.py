"""The port's spans (``chan_vese_tpu_torch.spans``) on the routes of the
benchmark's cells, on the CPU: where each driver opens its set-up, steps,
means, stop decisions and finish, that every kernel wrapper's call and
every host wait lies in a span of its own, that nothing is recorded with
the profiler off, and that the spans change no output."""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chan_vese_tpu_torch import spans
from chan_vese_tpu_torch.models import banded
from chan_vese_tpu_torch.params import CVParams
from chan_vese_tpu_torch.parallel.data_parallel import segment_stack_sharded
from chan_vese_tpu_torch.parallel.mesh import make_data_mesh
from fixtures import two_disks

SHAPE = (64, 256)
P = CVParams(tol=1e-4, max_iter=200, min_iter=10)


@pytest.fixture(scope="module")
def gray():
    img, _ = two_disks(*SHAPE, noise=6.0)
    return torch.from_numpy(img.astype(np.float32))


@pytest.fixture(scope="module")
def rgb(gray):
    return torch.stack([gray, 0.8 * gray + 20.0, 255.0 - gray], dim=-1)


@pytest.fixture(scope="module")
def stack(gray):
    return torch.stack([gray[:32], gray[32:], gray[:32].flip(1),
                        gray[32:].flip(0)]).contiguous()


def _fixed(u0, packed=None):
    return banded.segment_banded_fixed(u0, P, iters=24, k=8, packed=packed)


def _tol(u0):
    return banded.segment_banded(u0, P, k=8, packed=True)


def _sharded(u0):
    return segment_stack_sharded(u0, P, make_data_mesh(devices=[u0.device]),
                                 iters=4, use_pallas=True)


def _traced(fn):
    """fn's output and its ``cv.`` spans, [(start, end, name)] in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.name.startswith("cv."))
    return out, got


def _named(got, prefix):
    return [s for s in got if s[2].startswith(prefix)]


def _inside(got, outer, prefix):
    """The spans of ``got`` named ``prefix...`` that lie within
    ``outer``."""
    return [s for s in _named(got, prefix)
            if outer[0] <= s[0] and s[1] <= outer[1]]


@pytest.mark.parametrize("image, packed", [("gray", False), ("gray", True),
                                           ("rgb", None)])
def test_fixed_driver_spans(request, image, packed):
    """24 iterations at k = 8: set-up, three steps of a launch and the
    means each, a finish; the host waits only in set-up."""
    _, got = _traced(lambda: _fixed(request.getfixturevalue(image), packed))
    setup, = _named(got, "cv.drv.setup")
    steps = _named(got, "cv.drv.step")
    assert len(steps) == 3
    for step in steps:
        assert len(_inside(got, step, "cv.launch.")) == 1
        assert len(_inside(got, step, "cv.drv.means")) == 1
        assert not _inside(got, step, "cv.sync.")
    finish, = _named(got, "cv.drv.finish")
    syncs = _named(got, "cv.sync.")
    assert {s[2] for s in syncs} == {"cv.sync.n_pix", "cv.sync.region_n"}
    assert _inside(got, setup, "cv.sync.") == syncs
    launch = "cv.launch.packed_banded_chunk" if packed else "cv.launch."
    assert all(s[2].startswith(launch) for step in steps
               for s in _inside(got, step, "cv.launch."))
    if packed:
        # the packs in set-up, the unpack in the finish
        assert len(_inside(got, setup, "cv.launch.pack_planes")) == 2
        assert len(_inside(got, finish, "cv.launch.unpack_planes")) == 1


def _counting_reads(monkeypatch):
    """Count the device-to-host reads (``bool``, ``float`` of a tensor)
    made from ``models/banded.py``."""
    reads = []
    for name in ("__bool__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def read(self, _orig=orig):
            if sys._getframe(1).f_code.co_filename == banded.__file__:
                reads.append(1)
            return _orig(self)
        monkeypatch.setattr(torch.Tensor, name, read)
    return reads


def test_tolerance_driver_spans(gray, monkeypatch):
    """One step a chunk read: the chunk ahead queued in its own span, then
    the one host wait of the step inside its stop decision, a read a chunk;
    the chunk ahead thrown away at a tolerance stop, none queued past the
    schedule at a ``max_iter`` stop."""
    reads = _counting_reads(monkeypatch)
    for p in (P, P.replace(tol=-1.0, max_iter=20)):
        del reads[:]
        ahead = banded.segment_banded.ahead
        discarded = banded.segment_banded.discarded
        res, got = _traced(lambda: banded.segment_banded(gray, p, k=8,
                                                         packed=True))
        setup, = _named(got, "cv.drv.setup")
        steps = _named(got, "cv.drv.step")
        at_tol = p.tol > 0
        if at_tol:
            assert 0 < res.iters < p.max_iter and res.iters % 8 == 0
        else:
            assert res.iters == p.max_iter  # chunks of 8, 8 and 4
        # one step a chunk whose verdict is read: the first step also
        # queues the first chunk, every step with a next chunk in the
        # schedule queues it ahead, before the wait
        assert len(steps) == -(-res.iters // 8)
        chunks = len(steps) + at_tol
        for i, step in enumerate(steps):
            last = i == len(steps) - 1
            ahead_spans = _inside(got, step, "cv.drv.ahead")
            assert len(ahead_spans) == (0 if last and not at_tol else 1)
            for a in ahead_spans:
                assert len(_inside(got, a, "cv.launch.")) == 1
                assert len(_inside(got, a, "cv.drv.means")) == 1
                assert not _inside(got, a, "cv.sync.")
            assert len(_inside(got, step, "cv.launch.")) == (
                1 + (i == 0) - (last and not at_tol))
            stop, = _inside(got, step, "cv.drv.stop")
            sync, = _inside(got, step, "cv.sync.")
            assert sync[2] == "cv.sync.stop"
            assert _inside(got, stop, "cv.sync.") == [sync]
            assert all(a[1] <= sync[0] for a in ahead_spans)
            assert len(_inside(got, step, "cv.drv.discard")) == (
                last and at_tol)
        assert len(_named(got, "cv.drv.discard")) == at_tol
        assert len(_named(got, "cv.launch.packed_banded_chunk")) == chunks
        assert banded.segment_banded.ahead - ahead == chunks - 1
        assert banded.segment_banded.discarded - discarded == at_tol
        # one read a chunk, not the two (the metric against tol, then
        # again for divergence) of a loop that reads before it queues
        loop_syncs = [s for s in _named(got, "cv.sync.")
                      if s not in _inside(got, setup, "cv.sync.")]
        assert len(loop_syncs) == len(reads) == len(steps)
        assert {s[2] for s in _inside(got, setup, "cv.sync.")} == {
            "cv.sync.n_pix", "cv.sync.region_n", "cv.sync.inf"}


def test_sharded_stack_spans(stack):
    """The stack's one launch in the wrapper's span, inside the shard's
    step; no host wait."""
    _, got = _traced(lambda: _sharded(stack))
    step, = _named(got, "cv.drv.step")
    launches = _inside(got, step, "cv.launch.")
    assert [s[2] for s in launches] == [
        "cv.launch.packed_resident_iterations_batch"]
    assert not _named(got, "cv.sync.")
    assert len(_named(got, "cv.drv.finish")) == 2  # the shard's, the gather


def test_no_record_function_with_the_profiler_off(gray, stack, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} recorded with the profiler "
                             "off")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _fixed(gray, packed=True)
    _tol(gray)
    _sharded(stack)
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            spans.span("cv.drv.step")


@pytest.mark.parametrize("driver", ["fixed", "tol", "sharded"])
def test_outputs_equal_with_the_profiler_on_and_off(gray, stack, driver):
    run = {"fixed": lambda: _fixed(gray, packed=True),
           "tol": lambda: _tol(gray), "sharded": lambda: _sharded(stack)}[
        driver]
    off, (on, got) = run(), _traced(run)
    assert got
    if driver == "tol":
        assert on.iters == off.iters
        off, on = ((r.phi, r.mask, r.delta, r.c1, r.c2) for r in (off, on))
    for a, b in zip(on, off):
        assert torch.equal(a, b)
