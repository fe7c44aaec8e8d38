"""The port's driver hooks (chan_vese_tpu_torch/graft_entry.py, demo.py)
against the repository's ``__graft_entry__.py`` and ``examples/demo.py``.

- ``entry(device="cpu")``: the same inputs as the reference's (512^2,
  seed 0, the checkerboard start, its sines within an ulp), and its plain
  step against the reference's CPU function on the reference's inputs in
  f32: phi within 1e-4 of its scale, the means within 1e-5, the flips
  fraction and the masks within 1e-4 of the cells.
- ``_factor3`` equals the reference's for n = 1 to 12.
- ``dryrun_multichip`` on CPU devices for n = 1, 4, 6 and 8: the layout
  and a finite result; ``main`` runs both hooks.
- ``demo.main`` on the CPU writes every artifact; its masks and labels
  agree with the reference demo's images.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chan_vese_tpu_torch import demo, graft_entry
from torch_port_helpers import assert_rel, to_np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def test_entry_cpu_matches_reference():
    from __graft_entry__ import entry as jentry

    fn, args = graft_entry.entry("cpu")
    assert [tuple(a.shape) for a in args] == [(512, 512), (512, 512), (),
                                              ()]
    jfn, jargs = jentry()
    np.testing.assert_array_equal(to_np(args[1]), np.asarray(jargs[1]))
    # the checkerboard's sines differ in the last ulp between libraries,
    # the means' f32 sums in their order
    assert_rel(args[0], jargs[0], 1e-6)
    for a, b in zip(args[2:], jargs[2:]):
        assert_rel(a, b, 1e-5)
    phi, parts = fn(*(torch.from_numpy(np.asarray(b)) for b in jargs))
    jphi, jparts = jax.jit(jfn)(*jargs)
    assert phi.dtype == torch.float32 and parts.shape == (3,)
    # one f32 step on uniform noise: the means' sums run in another order,
    # so a few cells near phi = 0 flip (the flips fraction is parts[2])
    assert_rel(phi, jphi, 1e-4)
    assert_rel(parts[:2], np.asarray(jparts)[:2], 1e-5)
    assert abs(float(parts[2]) - float(jparts[2])) <= 1e-4
    assert np.mean(to_np(phi >= 0) != (np.asarray(jphi) >= 0)) <= 1e-4


@pytest.mark.parametrize("n", list(range(1, 13)))
def test_factor3_matches_reference(n):
    from __graft_entry__ import _factor3

    assert graft_entry._factor3(n) == _factor3(n)


@pytest.mark.parametrize("n,layout", [(1, (1, 1, 1)), (4, (1, 2, 2)),
                                      (6, (2, 1, 3)), (8, (2, 2, 2))])
def test_dryrun_multichip_cpu(n, layout, capsys):
    out = graft_entry.dryrun_multichip(n, device="cpu")
    assert out["layout"] == layout
    assert np.isfinite(out["delta"]) and out["chunk_finite"]
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_main_runs_both_hooks(capsys):
    assert graft_entry.main(["--device", "cpu", "2"]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip OK" in out and "entry OK" in out


def test_dryrun_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(2)


def test_demo_cpu_against_reference_demo(tmp_path, capsys):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] /
                           "examples"))
    import demo as jdemo

    demo.main(tmp_path / "t", device="cpu")
    out = capsys.readouterr().out
    names = {f.name for f in (tmp_path / "t").iterdir()}
    assert {"scalar_mask.npy", "scalar_trace.csv", "rgb_mask.npy",
            "multiphase_labels.npy", "scalar_mask.png",
            "scalar_overlay.png", "rgb_overlay.png",
            "multiphase_labels.png"} <= names
    assert "artifacts in" in out
    jdemo.main(str(tmp_path / "j"))
    from chan_vese_tpu_torch.utils.image_io import load_image

    for name in ("scalar_mask", "multiphase_labels"):
        got = load_image(tmp_path / "t" / f"{name}.png")
        want = load_image(tmp_path / "j" / f"{name}.png")
        assert got.shape == want.shape
        assert np.mean(got != want) <= 1e-3, name
    np.testing.assert_array_equal(
        np.load(tmp_path / "t" / "scalar_mask.npy"),
        load_image(tmp_path / "t" / "scalar_mask.png").astype(np.uint8))


def test_demo_without_pillow_skips_images_only(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setitem(sys.modules, "PIL", None)
    demo.main(tmp_path, device="cpu")
    out = capsys.readouterr().out
    assert "Pillow is missing" in out
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "multiphase_labels.npy", "rgb_mask.npy", "scalar_mask.npy",
        "scalar_trace.csv"]
