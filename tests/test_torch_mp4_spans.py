"""The spans of the multiphase drivers (``models/multiphase.py``, the
sharded multiphase driver) and of K9's wrappers (``ops/
multiphase_kernel.py``) on the CPU: each route's set-up, steps, stop
decisions and finish, every kernel wrapper's call and every host wait in
a span of its own, nothing recorded with the profiler off, and the same
outputs with the profiler on and off; and the resident route's start, made
once a shape and kept."""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chan_vese_tpu_torch.models import multiphase
from chan_vese_tpu_torch.ops import packed_kernel
from chan_vese_tpu_torch.params import CVParams
from chan_vese_tpu_torch.parallel import (make_grid_mesh,
                                          segment_multiphase_sharded)
from fixtures import four_regions

CPU = torch.device("cpu")
P = CVParams(mu=0.003 * 255.0 ** 2, tol=1e-3, max_iter=40, min_iter=4,
             patience=2)


@pytest.fixture(scope="module")
def img():
    """A four-region 32x256 image: the resident route takes it packed
    (K10), the banded one where resident is refused."""
    u, _ = four_regions(32, 256, noise=4.0)
    return torch.from_numpy(u.astype(np.float32))


def _traced(fn, first=True):
    """fn's output and its ``cv.`` spans, [(start, end, name)] in order;
    ``first``: as the first call of its shape (nothing of the start kept
    on the device from an earlier call)."""
    if first:
        multiphase._checkerboard_factor_on.cache_clear()
        multiphase._kept_start.cache_clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.name.startswith("cv."))
    return out, got


def _named(got, prefix):
    return [s for s in got if s[2].startswith(prefix)]


def _inside(got, outer, prefix):
    return [s for s in _named(got, prefix)
            if outer[0] <= s[0] and s[1] <= outer[1]]


def _one_setup_and_finish(got):
    setup, = _named(got, "cv.drv.setup")
    finish, = _named(got, "cv.drv.finish")
    # the first start's two uploads of the checkerboard's sines
    assert [s[2] for s in _inside(got, setup, "cv.sync.")] == [
        "cv.sync.mp_init"] * 2
    return setup, finish


def _run(u0, p=P, fixed=True, use_pallas=True, max_iter=None):
    return multiphase.segment_multiphase(u0, p, m_sets=2, fixed=fixed,
                                         use_pallas=use_pallas,
                                         max_iter=max_iter)


@pytest.mark.parametrize("shape, wrapper", [
    ((32, 256), "cv.launch.packed_mp2_resident_iterations"),
    ((24, 128), "cv.launch.mp2_resident_iterations")])
def test_resident_fixed_spans(img, shape, wrapper):
    """One step holding the one launch; the host waits only in set-up."""
    u0 = img[:shape[0], :shape[1]].contiguous()
    res, got = _traced(lambda: _run(u0, max_iter=10))
    assert res.iters == 10
    setup, finish = _one_setup_and_finish(got)
    step, = _named(got, "cv.drv.step")
    assert [s[2] for s in _inside(got, step, "cv.launch.")
            if "mp2" in s[2]] == [wrapper]
    assert not _named(got, "cv.drv.stop")
    assert _named(got, "cv.sync.") == _inside(got, setup, "cv.sync.")
    assert setup[1] <= step[0] and step[1] <= finish[0]


def test_a_later_start_waits_for_nothing(img):
    """The checkerboard's sines stay on the device after a shape's first
    call: a second call's set-up makes no upload, and starts alike."""
    def start():
        return multiphase.init_multiphase(img.shape, 2, device=img.device)
    first, _ = _traced(start)
    again, got = _traced(start, first=False)
    assert not _named(got, "cv.sync.")
    assert torch.equal(first, again)
    res, got = _traced(lambda: _run(img, max_iter=4), first=False)
    assert len(_named(got, "cv.drv.setup")) == 1
    assert res.iters == 4 and not _named(got, "cv.sync.")


def test_the_resident_route_keeps_its_start(img):
    """The resident route makes its default start once a shape and shares
    it: later calls start from the same tensor, their answers are bitwise
    those of that start handed in, and a call of no iterations answers a
    copy of it. Off the card no parity planes are kept."""
    multiphase._kept_start.cache_clear()
    first = _run(img, max_iter=6)
    again = _run(img, max_iter=6)
    kept, planes = multiphase._kept_start(tuple(img.shape), 2, img.dtype,
                                          img.device)
    assert multiphase._kept_start.cache_info().misses == 1
    assert planes is None
    assert torch.equal(kept, multiphase.init_multiphase(img.shape, 2))
    given = multiphase.segment_multiphase(img, P, m_sets=2,
                                          phis0=kept.clone(), fixed=True,
                                          use_pallas=True, max_iter=6)
    for res in (first, again):
        assert torch.equal(res.phis, given.phis)
        assert torch.equal(res.labels, given.labels)
    zero = _run(img, max_iter=0)
    assert zero.iters == 0 and torch.equal(zero.phis, kept)
    assert zero.phis.data_ptr() != kept.data_ptr()


@pytest.mark.cuda
def test_the_kept_planes_on_the_card():
    """On the card the kept start carries its parity planes: a later call
    packs u0 alone, and its answer is bitwise that of the start handed in
    (which K10's wrapper packs itself)."""
    from torch_port_helpers import cuda_device
    dev = cuda_device()
    u, _ = four_regions(256, 256, noise=4.0)
    u0 = torch.from_numpy(u.astype(np.float32)).to(dev)
    multiphase._kept_start.cache_clear()
    first = _run(u0, max_iter=10, use_pallas=None)
    n = packed_kernel.pack_planes.launches
    again = _run(u0, max_iter=10, use_pallas=None)
    assert packed_kernel.pack_planes.launches == n + 1
    kept, planes = multiphase._kept_start((256, 256), 2, u0.dtype, dev)
    assert torch.equal(planes, packed_kernel.pack_planes(kept))
    given = multiphase.segment_multiphase(u0, P, m_sets=2,
                                          phis0=kept.clone(), fixed=True,
                                          max_iter=10)
    for res in (first, again):
        assert torch.equal(res.phis, given.phis)
        assert torch.equal(res.labels, given.labels)


def _counting_reads(monkeypatch, names=("__bool__", "__float__")):
    """Count the device-to-host reads (``names``: ``bool``, ``float`` of a
    tensor, or its ``.cpu()``) made from ``models/multiphase.py``."""
    reads = []
    for name in names:
        orig = getattr(torch.Tensor, name)

        def read(self, *args, _orig=orig, **kwargs):
            if sys._getframe(1).f_code.co_filename == multiphase.__file__:
                reads.append(1)
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, read)
    return reads


def test_resident_tolerance_spans(img, monkeypatch):
    """A step a chunk of 32: its launch, then a stop decision holding the
    chunk's one read of its rows (the tests on them read the host's
    copy)."""
    # tol 0: no flip fraction lies below it, so the run goes to its cap
    p = CVParams(mu=P.mu, tol=0.0, max_iter=70, min_iter=4, patience=2)
    reads = _counting_reads(monkeypatch, ("cpu",))
    res, got = _traced(lambda: _run(img, p, fixed=False))
    assert res.iters == 70
    _one_setup_and_finish(got)
    steps = _named(got, "cv.drv.step")
    assert len(steps) == 3  # 32, 32, then the remainder of 6
    for step in steps:
        assert [s[2] for s in _inside(got, step, "cv.launch.")
                if "mp2" in s[2]] == [
            "cv.launch.packed_mp2_resident_iterations"]
        stop, = _inside(got, step, "cv.drv.stop")
        assert [s[2] for s in _inside(got, stop, "cv.sync.")] == [
            "cv.sync.mp_rows"]
    assert len(reads) == len(steps)
    # the start's infinite delta, a host number copied to the device
    assert [s[2] for s in _named(got, "cv.sync.inf")] == ["cv.sync.inf"]


@pytest.mark.parametrize("route", ["banded", "plain"])
def test_per_iteration_tolerance_spans(img, route, monkeypatch):
    """K9's banded loop (resident refused by a redistance cadence) and the
    plain loop: a step an iteration, its stop decision holding the two
    reads of the flip fraction, one span a read."""
    if route == "banded":
        p = CVParams(mu=P.mu, tol=1e-3, max_iter=12, min_iter=4,
                     patience=2, reinit_every=5)
        use_pallas, launch = True, "cv.launch.mp2_iteration"
    else:
        p, use_pallas, launch = P.replace(max_iter=12), None, None
    reads = _counting_reads(monkeypatch)
    res, got = _traced(lambda: _run(img, p, fixed=False,
                                    use_pallas=use_pallas))
    setup, _ = _one_setup_and_finish(got)
    steps = _named(got, "cv.drv.step")
    assert len(steps) == res.iters > 0
    if route == "banded":
        # the first means, between the set-up and the first step; the
        # later ones come from the kernel's partials
        means, = _named(got, "cv.drv.means")
        assert setup[1] <= means[0] and means[1] <= steps[0][0]
    for step in steps:
        mp2 = [s[2] for s in _inside(got, step, "cv.launch.")
               if "mp2" in s[2]]
        assert mp2 == ([launch] if launch else [])
        stop, = _inside(got, step, "cv.drv.stop")
        assert [s[2] for s in _inside(got, stop, "cv.sync.")] == [
            "cv.sync.mp_delta", "cv.sync.mp_tol"]
    loop_syncs = [s for s in _named(got, "cv.sync.")
                  if s[2] not in ("cv.sync.mp_init", "cv.sync.inf")]
    assert len(loop_syncs) == len(reads) == 2 * len(steps)


def test_fixed_trace_spans(img):
    """``segment_multiphase_fixed`` on K9's banded route: a step an
    iteration, each with its launch, and no wait in the loop."""
    _, got = _traced(lambda: multiphase.segment_multiphase_fixed(
        img, P, iters=3, use_pallas=True))
    setup, _ = _one_setup_and_finish(got)
    steps = _named(got, "cv.drv.step")
    assert len(steps) == 3
    for step in steps:
        assert [s[2] for s in _inside(got, step, "cv.launch.")] == [
            "cv.launch.mp2_iteration"]
    assert _named(got, "cv.sync.") == _inside(got, setup, "cv.sync.")


def test_sharded_spans(img):
    """The sharded driver on a 1x2 grid through K9's shard mode: a step an
    iteration, each with one launch a shard."""
    mesh = make_grid_mesh(1, 2, [CPU, CPU])
    _, got = _traced(lambda: segment_multiphase_sharded(
        img, P, mesh, max_iter=3, fixed=True, use_pallas=True))
    setup, _ = _one_setup_and_finish(got)
    steps = _named(got, "cv.drv.step")
    assert len(steps) == 3
    for step in steps:
        assert [s[2] for s in _inside(got, step, "cv.launch.")] == [
            "cv.launch.mp2_iteration_sharded"] * 2
    assert _named(got, "cv.sync.") == _inside(got, setup, "cv.sync.")


def test_no_record_function_with_the_profiler_off(img, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name!r} recorded with the profiler "
                             "off")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _run(img, max_iter=4)
    _run(img, P.replace(reinit_every=2), fixed=False)
    _run(img, fixed=False, use_pallas=None)
    multiphase.segment_multiphase_fixed(img, P, iters=2, use_pallas=True)
    segment_multiphase_sharded(img, P, make_grid_mesh(1, 2, [CPU, CPU]),
                               max_iter=2, fixed=True, use_pallas=True)


@pytest.mark.parametrize("fixed, use_pallas", [(True, True), (False, True),
                                               (False, None)])
def test_outputs_equal_with_the_profiler_on_and_off(img, fixed, use_pallas):
    def run():
        return _run(img, fixed=fixed, use_pallas=use_pallas, max_iter=8)
    off, (on, got) = run(), _traced(run)
    assert got and on.iters == off.iters
    for a, b in zip((on.phis, on.labels, on.delta, on.cs),
                    (off.phis, off.labels, off.delta, off.cs)):
        assert torch.equal(a, b)
