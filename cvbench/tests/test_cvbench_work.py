"""The frozen work counts: the band body's 4K chunks against the numbers
the repository's kernel table carries, and whole calls."""

import pytest

from cvbench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)

from cvbench import reference, work

FROZEN = reference.trajectory("frozen_chunks")
EXACT = reference.trajectory("exact_means")


def test_4k_gray_chunk_bound():
    ms, by = work.bound(2160, 3840, 8, 0)
    assert by == "operations"
    assert round(ms * 1e3, 4) == 0.0574


def test_4k_rgb_chunk_bound():
    ms, by = work.bound(2160, 3840, 8, 3)
    assert by == "operations"
    assert round(ms * 1e3, 4) == 0.0599


def test_whole_fixed_call_is_its_chunks():
    ops, nbytes, pix_it = FROZEN.call_work((2160, 3840), 800, {"k": 8})
    per_chunk = 2160 * 3840 * (55 * 8 + 8 + 14 + 2)
    assert ops == 100 * per_chunk
    assert pix_it == 2160 * 3840 * 800
    # the image read once, the level set and the mask written once
    assert nbytes == 2160 * 3840 * (4 + 5)
    # the call's least time is its chunks' operations at the f32 peak
    assert work.roofline(nbytes, ops) == pytest.approx(
        (100 * work.bound(2160, 3840, 8, 0)[0], "operations"))


def test_remainder_chunk_is_counted():
    ops, _, _ = FROZEN.call_work((64, 256), 20, {"k": 8})
    per = [work.launch_work(64, 256, k, 0)[0] for k in (8, 8, 4)]
    assert ops == sum(per)


def test_rgb_call_reads_every_channel():
    _, nbytes, pix_it = FROZEN.call_work((2160, 3840, 3), 800, {"k": 8})
    assert nbytes == 2160 * 3840 * (12 + 5)
    assert pix_it == 2160 * 3840 * 800


def test_stack_call_counts_exact_means_every_iteration():
    ops, nbytes, pix_it = EXACT.call_work((256, 512, 512), 30, {"iters": 30})
    per_pixel = 30 * (55 + 8 + 4 + 2) + 30 * 8
    assert ops == 256 * 512 * 512 * per_pixel
    assert nbytes == 256 * 512 * 512 * 9
    assert pix_it == 256 * 512 * 512 * 30
    assert work.roofline(nbytes, ops)[0] == pytest.approx(
        ops / work.PEAK_F32)


def test_unknown_trajectory_raises():
    with pytest.raises(ModuleNotFoundError):
        reference.trajectory("sharded")
    with pytest.raises(ValueError):
        reference.trajectory("../work")
