"""The port's CLI flags of the trace, GIF, checkpoint and output modules
(--trace-energy, --evolution-gif, --gif-every, --checkpoint-dir,
--checkpoint-every, --overlay, --conv, --f64, --quiet) against the JAX
CLI on the same ``.npy``, branch by branch of the reference's routing:

- unsharded fixed (gray and --color): trace, GIF, overlay;
- unsharded ``.npz`` checkpoints (gray and --color), the trace and GIF
  dropped with a warning;
- sharded PDE: the trace (--comm-k dropped), the checkpoints (gray; colour
  drops them), the GIF with frames on comm_k multiples;
- multiphase sharded: trace and GIF, checkpoints (--comm-k dropped);
  multiphase unsharded: checkpoints and trace;
- MorphACWE: trace and GIF (checkpoints dropped); MorphGAC: GIF (trace
  and checkpoints dropped);
- --overlay on every tolerance-mode branch; --conv's three metrics;
  --quiet silences stderr; the interval check.

Masks, label maps and overlays are identical, the CSVs within 1e-10 with
--f64 (f64 both ways), the GIF frames equal once decoded. The reference
CLI writes orbax checkpoints with --mesh and the port DCP ones: both
directories hold the same checkpoint names.
"""

import numpy as np
import pytest

from chan_vese_tpu import cli as jcli
from chan_vese_tpu_torch import cli as tcli
from chan_vese_tpu_torch.utils import trace as ttrace
from fixtures import colored_squares, four_regions, two_disks
from torch_port_helpers import assert_rel


@pytest.fixture
def gray(tmp_path):
    src = tmp_path / "gray.npy"
    np.save(src, two_disks(32, 64, noise=6.0)[0])
    return src


@pytest.fixture
def rgb(tmp_path):
    src = tmp_path / "rgb.npy"
    np.save(src, colored_squares(32, 64, noise=4.0)[0])
    return src


@pytest.fixture
def regions(tmp_path):
    src = tmp_path / "regions.npy"
    np.save(src, four_regions(32, 64, noise=4.0)[0])
    return src


def run_both(tmp_path, src, args, outs=(), capsys=None):
    """Both CLIs on ``src`` with ``args``; each (flag, name) of ``outs``
    is passed as ``flag <tmp>/<j|t>_<name>``. Returns {who: (rc, stderr)}."""
    res = {}
    for who, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        argv = [str(src)] + list(args) + extra
        for flag, name in outs:
            argv += [flag, str(tmp_path / f"{who}_{name}")]
        rc = main(argv)
        err = capsys.readouterr().err if capsys is not None else None
        res[who] = (rc, err)
        assert rc == 0, (who, err)
    return res


def same_npy(tmp_path, name):
    got, want = (np.load(tmp_path / f"{w}_{name}") for w in "tj")
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def same_csv(tmp_path, name, rtol=1e-10):
    got, want = (ttrace.read_energy_csv(tmp_path / f"{w}_{name}")
                 for w in "tj")
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["iter"], want["iter"])
    for k in want:
        assert_rel(got[k], want[k], rtol)


def same_gif(tmp_path, name, n_frames):
    """The decoded frames are equal (the GIF writer folds a frame equal to
    the one before it into it, so there are at most n_frames)."""
    iio = pytest.importorskip("imageio.v3")
    got, want = (iio.imread(tmp_path / f"{w}_{name}", index=None)
                 for w in "tj")
    assert 1 <= len(want) <= n_frames
    np.testing.assert_array_equal(got, want)


def ck_names(tmp_path, who, name="ck"):
    return sorted(f.name for f in (tmp_path / f"{who}_{name}").iterdir())


# unsharded -----------------------------------------------------------------

def test_fixed_trace_gif_overlay(tmp_path, gray):
    run_both(tmp_path, gray, ["--iters", "12", "--f64", "--gif-every", "5"],
             [("--trace-energy", "t.csv"), ("--evolution-gif", "e.gif"),
              ("--overlay", "ov.npy"), ("-o", "m.npy")])
    same_csv(tmp_path, "t.csv")
    same_gif(tmp_path, "e.gif", 3)
    same_npy(tmp_path, "ov.npy")
    same_npy(tmp_path, "m.npy")


def test_fixed_color_trace_and_gif(tmp_path, rgb):
    run_both(tmp_path, rgb, ["--color", "--iters", "8", "--f64",
                             "--lambda1", "1", "1.2", "0.8",
                             "--gif-every", "4"],
             [("--trace-energy", "t.csv"), ("--evolution-gif", "e.gif"),
              ("-o", "m.npy")])
    same_csv(tmp_path, "t.csv")
    same_gif(tmp_path, "e.gif", 2)
    same_npy(tmp_path, "m.npy")


@pytest.mark.parametrize("color", [False, True])
def test_unsharded_checkpoints(tmp_path, gray, rgb, color, capsys):
    src = rgb if color else gray
    args = ["--iters", "10", "--f64", "--checkpoint-every", "4"] + (
        ["--color"] if color else [])
    res = run_both(tmp_path, src, args,
                   [("--checkpoint-dir", "ck"), ("--trace-energy", "t.csv"),
                    ("-o", "m.npy"), ("--overlay", "ov.npy")], capsys)
    same_npy(tmp_path, "m.npy")
    same_npy(tmp_path, "ov.npy")
    assert ck_names(tmp_path, "t") == ck_names(tmp_path, "j") == [
        "ckpt_00000004.npz", "ckpt_00000008.npz", "ckpt_00000010.npz"]
    got, want = (np.load(tmp_path / f"{w}_ck" / "ckpt_00000010.npz")
                 for w in "tj")
    assert_rel(got["phi"], want["phi"], 1e-10)
    assert "--trace-energy not supported" in res["t"][1]
    assert not (tmp_path / "t_t.csv").exists()


# sharded PDE -----------------------------------------------------------------

def test_sharded_trace_drops_comm_k(tmp_path, gray, capsys):
    res = run_both(tmp_path, gray, ["--mesh", "2", "2", "--iters", "10",
                                    "--f64", "--comm-k", "2"],
                   [("--trace-energy", "t.csv"), ("-o", "m.npy"),
                    ("--overlay", "ov.npy")], capsys)
    same_csv(tmp_path, "t.csv")
    same_npy(tmp_path, "m.npy")
    same_npy(tmp_path, "ov.npy")
    assert "--comm-k not supported on the sharded traced path" in \
        res["t"][1]


def test_sharded_checkpoints(tmp_path, gray):
    run_both(tmp_path, gray, ["--mesh", "2", "2", "--iters", "8", "--f64",
                              "--comm-k", "2", "--checkpoint-every", "4"],
             [("--checkpoint-dir", "ck"), ("-o", "m.npy")])
    same_npy(tmp_path, "m.npy")
    assert ck_names(tmp_path, "t") == ["ckpt_00000004", "ckpt_00000008"]
    assert set(ck_names(tmp_path, "t")) <= set(ck_names(tmp_path, "j"))


def test_sharded_color_drops_checkpoints(tmp_path, rgb, capsys):
    res = run_both(tmp_path, rgb, ["--mesh", "2", "2", "--iters", "6",
                                   "--f64", "--color"],
                   [("--checkpoint-dir", "ck"), ("-o", "m.npy")], capsys)
    same_npy(tmp_path, "m.npy")
    assert not (tmp_path / "t_ck").exists()
    assert "--checkpoint-dir not supported on the sharded color path" in \
        res["t"][1]


@pytest.mark.parametrize("comm_k,frames", [("1", 3), ("2", 3)])
def test_sharded_gif_frames_on_comm_k_multiples(tmp_path, gray, comm_k,
                                                frames):
    # --gif-every 3: frames every 3 iterations at comm_k 1, every 4 at 2
    iters = "8" if comm_k == "1" else "12"
    run_both(tmp_path, gray, ["--mesh", "2", "2", "--iters", iters, "--f64",
                              "--comm-k", comm_k, "--gif-every", "3"],
             [("--evolution-gif", "e.gif"), ("-o", "m.npy")])
    same_gif(tmp_path, "e.gif", frames)
    same_npy(tmp_path, "m.npy")


# multiphase ----------------------------------------------------------------

MP = ["--multiphase", "2", "--mu", "195"]


def test_multiphase_sharded_trace_and_gif(tmp_path, regions):
    run_both(tmp_path, regions, MP + ["--mesh", "2", "2", "--iters", "6",
                                      "--f64", "--gif-every", "3"],
             [("--trace-energy", "t.csv"), ("--evolution-gif", "e.gif"),
              ("-o", "l.npy"), ("--overlay", "ov.npy")])
    same_csv(tmp_path, "t.csv")
    same_gif(tmp_path, "e.gif", 2)
    same_npy(tmp_path, "l.npy")
    same_npy(tmp_path, "ov.npy")


def test_multiphase_sharded_checkpoints(tmp_path, regions, capsys):
    res = run_both(tmp_path, regions,
                   MP + ["--mesh", "2", "2", "--iters", "6", "--f64",
                         "--comm-k", "2", "--checkpoint-every", "3"],
                   [("--checkpoint-dir", "ck"), ("-o", "l.npy")], capsys)
    same_npy(tmp_path, "l.npy")
    assert ck_names(tmp_path, "t") == ["ckpt_00000003", "ckpt_00000006"]
    assert "--comm-k not supported" in res["t"][1]


def test_multiphase_unsharded_checkpoints(tmp_path, regions):
    run_both(tmp_path, regions, MP + ["--iters", "8", "--f64",
                                      "--checkpoint-every", "3"],
             [("--checkpoint-dir", "ck"), ("-o", "l.npy"),
              ("--overlay", "ov.npy")])
    same_npy(tmp_path, "l.npy")
    same_npy(tmp_path, "ov.npy")
    assert ck_names(tmp_path, "t") == ck_names(tmp_path, "j")
    got, want = (np.load(tmp_path / f"{w}_ck" / "ckpt_00000008.npz")
                 for w in "tj")
    assert_rel(got["phi"], want["phi"], 1e-10)


def test_multiphase_unsharded_trace(tmp_path, regions):
    run_both(tmp_path, regions, MP + ["--iters", "8", "--f64"],
             [("--trace-energy", "t.csv"), ("-o", "l.npy")])
    same_csv(tmp_path, "t.csv")
    same_npy(tmp_path, "l.npy")


# morphological -------------------------------------------------------------

def test_morph_trace_and_gif(tmp_path, gray, capsys):
    res = run_both(tmp_path, gray, ["--morph", "--iters", "8", "--f64",
                                    "--gif-every", "3"],
                   [("--trace-energy", "t.csv"), ("--evolution-gif", "e.gif"),
                    ("--checkpoint-dir", "ck"), ("-o", "m.npy"),
                    ("--overlay", "ov.npy")], capsys)
    same_csv(tmp_path, "t.csv")
    same_gif(tmp_path, "e.gif", 3)
    same_npy(tmp_path, "m.npy")
    same_npy(tmp_path, "ov.npy")
    assert "--checkpoint-dir not supported on the morphological path" in \
        res["t"][1]


def test_gac_gif_drops_trace_and_checkpoints(tmp_path, gray, capsys):
    res = run_both(tmp_path, gray,
                   ["--morph-gac", "--balloon", "1", "--init", "small-disk",
                    "--gac-alpha", "5", "--gac-sigma", "2",
                    "--gac-threshold", "0.3", "--iters", "8",
                    "--gif-every", "4"],
                   [("--evolution-gif", "e.gif"), ("--trace-energy", "t.csv"),
                    ("--checkpoint-dir", "ck"), ("-o", "m.npy"),
                    ("--overlay", "ov.npy")], capsys)
    same_gif(tmp_path, "e.gif", 2)
    same_npy(tmp_path, "m.npy")
    same_npy(tmp_path, "ov.npy")
    assert ("--checkpoint-dir, --trace-energy not supported on the "
            "morphological-GAC path") in res["t"][1]
    assert not (tmp_path / "t_t.csv").exists()


# --overlay, --conv, --quiet, the interval check -----------------------------

@pytest.mark.parametrize("branch", [
    ["--max-iter", "40"],
    ["--max-iter", "30", "--color"],
    ["--max-iter", "20"] + MP,
    ["--morph", "--max-iter", "20"],
    ["--mesh", "2", "2", "--max-iter", "30"],
    ["--pyramid", "1", "--max-iter", "40"],
])
def test_overlay_on_every_branch(tmp_path, gray, rgb, regions, branch):
    src = rgb if "--color" in branch else (regions if "--multiphase"
                                           in branch else gray)
    run_both(tmp_path, src, branch + ["--f64"],
             [("--overlay", "ov.npy"), ("-o", "m.npy")])
    same_npy(tmp_path, "ov.npy")
    same_npy(tmp_path, "m.npy")


# (metric, tol): this image's update norm falls fast, then levels off,
# so each metric stops early or runs to --max-iter about its tolerance
@pytest.mark.parametrize("conv,tol,stops", [
    ("flips", "1e-3", True), ("rms", "0.1", False), ("rms", "0.2", True),
    ("mean_abs", "0.06", False), ("mean_abs", "0.08", True)])
def test_conv_metric(tmp_path, gray, conv, tol, stops, capsys):
    res = run_both(tmp_path, gray, ["--conv", conv, "--f64", "--tol", tol,
                                    "--max-iter", "200"],
                   [("-o", "m.npy")], capsys)
    same_npy(tmp_path, "m.npy")
    iters = [int(err.split("converged in ")[1].split()[0])
             for err in (res["t"][1], res["j"][1])]
    assert iters[0] == iters[1]
    assert (iters[0] < 200) == stops


@pytest.mark.parametrize("branch", [
    ["--iters", "4", "--checkpoint-dir", "{tmp}/ck", "--trace-energy",
     "{tmp}/t.csv"],
    ["--max-iter", "10", "--trace-energy", "{tmp}/t.csv"],
    ["--mesh", "2", "2", "--iters", "4", "--comm-k", "2",
     "--trace-energy", "{tmp}/t.csv"],
    ["--iters", "4", "--morph", "--checkpoint-dir", "{tmp}/ck"],
    ["--iters", "4"] + MP + ["--checkpoint-dir", "{tmp}/ck"],
])
def test_quiet_silences_stderr(tmp_path, gray, branch, capsys):
    argv = [str(gray), "--device", "cpu", "--quiet", "-o",
            str(tmp_path / "m.npy")] + [a.format(tmp=tmp_path)
                                        for a in branch]
    capsys.readouterr()
    assert tcli.main(argv) == 0
    assert capsys.readouterr().err == ""
    assert tcli.main([a for a in argv if a != "--quiet"]) == 0
    assert capsys.readouterr().err != ""


@pytest.mark.parametrize("flag", ["--gif-every", "--checkpoint-every"])
@pytest.mark.parametrize("value", ["0", "-3"])
def test_intervals_must_be_positive(gray, flag, value, capsys):
    argv = [str(gray), "--iters", "4", flag, value]
    assert jcli.main(argv) == 2
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    assert "must be positive" in capsys.readouterr().err


def test_f64_runs_in_double(tmp_path, gray):
    """--f64 reaches the drivers in float64: the f32 run's trace differs
    from the f64 reference's beyond 1e-10, the f64 run's does not."""
    run_both(tmp_path, gray, ["--iters", "6", "--f64"],
             [("--trace-energy", "t64.csv")])
    same_csv(tmp_path, "t64.csv")
    assert tcli.main([str(gray), "--iters", "6", "--device", "cpu",
                      "--trace-energy", str(tmp_path / "t_t32.csv")]) == 0
    e32 = ttrace.read_energy_csv(tmp_path / "t_t32.csv")["energy"]
    e64 = ttrace.read_energy_csv(tmp_path / "j_t64.csv")["energy"]
    assert np.max(np.abs(e32 - e64) / np.abs(e64)) > 1e-10
