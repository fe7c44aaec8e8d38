"""PyTorch port vs the JAX reference: parameters, import hygiene, the
plain numerics/reductions/sweep/init ops (f64, <= 1e-12 relative), the
routing predicates, the parity-plane pack and the CLI."""

import dataclasses
import math
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chan_vese_tpu.params as jparams
import chan_vese_tpu_torch as ct
from chan_vese_tpu.models import banded as jbanded
from chan_vese_tpu.ops import numerics as jn
from chan_vese_tpu.ops import pallas_banded, pallas_packed, pallas_sweep
from chan_vese_tpu.ops import reductions as jr
from chan_vese_tpu.ops import sweep as js
from chan_vese_tpu.utils.init_phi import init_phi as jinit_phi
from chan_vese_tpu_torch import cli
from chan_vese_tpu_torch.models import banded as tbanded
from chan_vese_tpu_torch.ops import banded_kernel, fused_kernel, packed_kernel
from chan_vese_tpu_torch.ops import numerics as tn
from chan_vese_tpu_torch.ops import reductions as tr
from chan_vese_tpu_torch.ops import sweep as ts
from chan_vese_tpu_torch.utils import image_io
from chan_vese_tpu_torch.utils.init_phi import init_phi as tinit_phi
from fixtures import iou, two_disks
from torch_port_helpers import assert_rel, params, to_np, to_torch

RTOL = 1e-12


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    phi = rng.standard_normal((24, 40)) * 3.0
    phi2 = phi + rng.standard_normal((24, 40)) * 0.5
    u0 = rng.uniform(0, 255, (24, 40))
    return phi, phi2, u0


# (a) parameters ----------------------------------------------------------

def test_cvparams_fields_and_defaults_match_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jparams.CVParams)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ct.CVParams)]
    assert tf == jf
    assert ct.CVParams().replace(mu=3.0).mu == 3.0
    assert (ct.CVParams().channel_lambdas(3, (1.0,), 2.0)
            == jparams.CVParams().channel_lambdas(3, (1.0,), 2.0))


def test_cvparams_from_reference_round_trips():
    pj = jparams.CVParams(mu=12.5, tol=3e-4, order="wavefront",
                          init="circle", max_iter=77, patience=2)
    pt = ct.CVParams.from_reference(pj)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    assert ct.CVParams.from_reference(dataclasses.asdict(pj)) == pt
    with pytest.raises(ValueError):
        ct.CVParams.from_reference({"mu": 1.0})


# (b) import hygiene ------------------------------------------------------

def test_port_imports_no_jax():
    code = ("import sys, chan_vese_tpu_torch, chan_vese_tpu_torch.cli, "
            "chan_vese_tpu_torch.models.banded, chan_vese_tpu_torch._build, "
            "chan_vese_tpu_torch.compat, chan_vese_tpu_torch.models.morph, "
            "chan_vese_tpu_torch.models.morph_gac, "
            "chan_vese_tpu_torch.ops.morph_kernel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'chan_vese_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# (c) plain ops in f64 ----------------------------------------------------

@pytest.mark.parametrize("name", ["shift_up", "shift_down", "shift_left",
                                  "shift_right", "grad_forward",
                                  "grad_central", "neumann_pad"])
def test_numerics_stencils(fields, name):
    phi = fields[0]
    want = getattr(jn, name)(jnp.asarray(phi))
    got = getattr(tn, name)(to_torch(phi))
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    np.testing.assert_array_equal(
        to_np(tn.neumann_pad(to_torch(phi), 3)),
        np.asarray(jn.neumann_pad(jnp.asarray(phi), 3)))


@pytest.mark.parametrize("name", ["heaviside", "dirac", "curvature",
                                  "face_coeffs", "face_coeffs_backward",
                                  "face_coeffs_all"])
def test_numerics_pointwise_and_coefficients(fields, name):
    phi = fields[0]
    args = {"heaviside": (1.5,), "dirac": (1.5,), "curvature": (1e-8,)}
    args = args.get(name, (650.25, 1e-8))
    want = getattr(jn, name)(jnp.asarray(phi), *args)
    got = getattr(tn, name)(to_torch(phi), *args)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert_rel(g, w, RTOL)


def test_reductions(fields):
    phi, phi2, u0 = fields
    pj, pt = params(nu=3.0, lambda1=1.3, lambda2=0.7)
    for w, g in zip(jr.region_sums(jnp.asarray(u0), jnp.asarray(phi), 1.0),
                    tr.region_sums(to_torch(u0), to_torch(phi), 1.0)):
        assert_rel(g, w, RTOL)
    jc = jr.region_means(jnp.asarray(u0), jnp.asarray(phi), 1.0)
    tc = tr.region_means(to_torch(u0), to_torch(phi), 1.0)
    for w, g in zip(jc, tc):
        assert_rel(g, w, RTOL)
    assert_rel(tr.data_term(to_torch(u0), tc[0], tc[1], 3.0, 1.3, 0.7),
               jr.data_term(jnp.asarray(u0), jc[0], jc[1], 3.0, 1.3, 0.7),
               RTOL)
    assert_rel(tr.energy(to_torch(u0), to_torch(phi), tc[0], tc[1], pt),
               jr.energy(jnp.asarray(u0), jnp.asarray(phi), jc[0], jc[1],
                         pj), RTOL)
    # the vector branch (ROADMAP M6): channel means of the weighted terms
    rgb = np.stack([u0, 0.5 * u0, 255.0 - u0], axis=-1)
    jcv = jr.region_means(jnp.asarray(rgb), jnp.asarray(phi), 1.0)
    tcv = tr.region_means(to_torch(rgb), to_torch(phi), 1.0)
    assert_rel(tr.data_term(to_torch(rgb), tcv[0], tcv[1], 3.0,
                            (1.3, 1.0, 0.5), 0.7),
               jr.data_term(jnp.asarray(rgb), jcv[0], jcv[1], 3.0,
                            (1.3, 1.0, 0.5), 0.7), RTOL)


@pytest.mark.parametrize("kind", ["flips", "rms", "mean_abs"])
def test_delta_norm_and_nan_poison(fields, kind):
    phi, phi2, _ = fields
    assert_rel(tr.delta_norm(to_torch(phi2), to_torch(phi), kind),
               jr.delta_norm(jnp.asarray(phi2), jnp.asarray(phi), kind),
               RTOL)
    bad = phi2.copy()
    bad[3, 4] = np.nan
    got = float(tr.delta_norm(to_torch(bad), to_torch(phi), kind))
    want = float(jr.delta_norm(jnp.asarray(bad), jnp.asarray(phi), kind))
    assert math.isnan(got) and math.isnan(want)
    with pytest.raises(ValueError):
        tr.delta_norm(to_torch(phi2), to_torch(phi), "bogus")


def test_loop_continue_matches_reference():
    pj, pt = params(min_iter=5, patience=3, max_iter=20)
    for n in (0, 1, 4, 5, 19, 20):
        for delta in (math.inf, math.nan, 0.5, 1e-9):
            for streak in (0, 2, 3):
                want = bool(jr.loop_continue(
                    jnp.int32(n), jnp.float64(delta), jnp.int32(streak), pj))
                assert tr.loop_continue(n, delta, streak, pt) == want, \
                    (n, delta, streak)


@pytest.mark.parametrize("order", ["jacobi", "redblack", "wavefront"])
def test_sweeps(fields, order):
    phi, _, u0 = fields
    pj, pt = params(order=order)
    f = u0 - 120.0
    want = js.semi_implicit_step(jnp.asarray(phi), jnp.asarray(f), pj)
    got = ts.semi_implicit_step(to_torch(phi), to_torch(f), pt)
    assert_rel(got, want, RTOL)
    np.testing.assert_array_equal(
        to_np(ts.color_masks((5, 7), 1)), np.asarray(js.color_masks((5, 7),
                                                                   1)))


@pytest.mark.parametrize("kind", ["checkerboard", "circle", "disk",
                                  "small disk", "rect"])
def test_init_phi(kind):
    want = jinit_phi((37, 50), kind, jnp.float64)
    got = tinit_phi((37, 50), kind, torch.float64)
    assert_rel(got, want, RTOL)


# routing predicates ------------------------------------------------------

def test_routing_predicates_match_reference():
    shapes = [(24, 128), (64, 128), (64, 256), (96, 256), (40, 100),
              (1080, 1920), (2160, 3840), (4320, 7680), (1000, 1500),
              (72, 384), (16, 256), (8, 128)]
    for h, w in shapes:
        assert fused_kernel.supports(h, w) == pallas_sweep.supports(h, w)
        for k in (1, 2, 3, 4, 8, 16, 64, 65):
            assert banded_kernel.supports_banded(h, w, k) \
                == pallas_banded.supports_banded(h, w, k), (h, w, k)
            assert packed_kernel.supports_packed_banded(h, w, k) \
                == pallas_packed.supports_packed_banded(h, w, k), (h, w, k)
            for pk in (None, True, False):
                assert tbanded.auto_config(h, w, k, None, pk) \
                    == jbanded.auto_config(h, w, k, None, pk)
        assert tbanded.auto_config(h, w) == jbanded.auto_config(h, w)
    assert banded_kernel._halos(8) == pallas_banded._halos(8)


# (e) parity planes -------------------------------------------------------

def test_pack_unpack_bitwise_against_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 512)).astype(np.float32)
    want = np.asarray(pallas_packed._pack(jnp.asarray(x)))
    got = packed_kernel.pack_planes(to_torch(x, np.float32))
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(to_np(packed_kernel.unpack_planes(got)), x)
    np.testing.assert_array_equal(
        np.asarray(pallas_packed._unpack(jnp.asarray(want))),
        to_np(packed_kernel.unpack_planes(got)))


# (h) image I/O and the CLI -----------------------------------------------

def test_image_io_npy_round_trip(tmp_path):
    img, gt = two_disks(16, 24)
    np.save(tmp_path / "img.npy", img)
    loaded = image_io.load_image(tmp_path / "img.npy")
    assert loaded.dtype == np.float32
    np.testing.assert_array_equal(loaded, img.astype(np.float32))
    image_io.save_mask(tmp_path / "m.npy", gt)
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"),
                                  gt.astype(np.uint8) * 255)


@pytest.mark.parametrize("extra", [[], ["--iters", "20"]])
def test_cli_runs_on_npy_with_cpu_device(tmp_path, extra):
    img, gt = two_disks(64, 128, noise=6.0)
    np.save(tmp_path / "img.npy", img)
    out = tmp_path / "mask.npy"
    rc = cli.main([str(tmp_path / "img.npy"), "-o", str(out),
                   "--device", "cpu", "--init", "circle", *extra])
    assert rc == 0
    mask = np.load(out) > 0
    assert mask.shape == gt.shape
    assert iou(mask, gt) > 0.95


def test_cli_cuda_without_gpu_raises(tmp_path, monkeypatch):
    np.save(tmp_path / "img.npy", np.zeros((8, 8)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(tmp_path / "img.npy"), "--device", "cuda"])
