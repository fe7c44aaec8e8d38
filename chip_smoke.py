"""Smoke test of chan_vese_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--sass-parent DIR]

Builds the CUDA kernels from this checkout, holds each kernel against its
plain PyTorch version, drives the grayscale main path (segment_banded at
4K, 3840x2160) and the RGB main path (segment_banded at 4K RGB,
3840x2160x3) through the kernels, checks the masks, and times the 4K
fixed-iteration runs (phases 1-5). Phases 6-8 do the same for the
exact-means resident route (K7 flat, K8 parity planes; scalar, batch and
RGB modes): each mode against its plain version at 256^2-1024^2, a
ragged shape and the shapes the main path gives it, segment_resident / segment_stack_resident_fixed /
segment_resident_fixed through the kernels, and the resident drivers'
throughput beside the per-iteration fused driver's at 256^2, 512^2 RGB and
1024^2. Phases 9-11 do the same for multiphase (two level sets, four
phases): K9 banded and resident, K10 and K1's force mode (fused_sweep)
each against its plain version at the shapes the main path gives it,
segment_multiphase at 512^2 (K10), 1024^2 (K9 resident) and 4K (K9
banded), segment_multiphase_fixed at 512^2 (K9 banded) and the fused_sweep
route (M = 3 gray, M = 2 RGB) through the kernels, and the multiphase
throughput at 512^2, 1024^2 and 4K. Phases 12-14 do the same for the
morphological family: K11 (kinds acwe, gac, gac_pre) and K12 each bitwise
against its plain version at 4K, 1080p and a ragged shape, segment_morph
(4K gray and RGB), segment_morph_iterations(fuse_force=True),
segment_gac, segment_gac_iterations and
compat.morphological_geodesic_active_contour through the kernels, and the
morph-acwe / morph-gac throughput at 4K, and check that the binary
morph start built on the card equals the one built on the CPU. Phases
15-17 do the same for frame stacks and the layout kernels: K1's batch
mode, K13 (packed_chunk, flat and packed, on the tile body) and the
parity pack/unpack
K15/K16 each against its plain version (the pack bitwise) at the shapes
the main path gives it, segment_stack_sharded on a one-device data mesh
(64 x 512^2 through K8 batch, 16 x 1080p through K1 batch, tolerance
mode, whose per-frame iteration counts and masks are held against the
same stack run on the CPU) and packed_chunk through the kernels, and the
times: the batched-stack configuration at steady state, K1 batch beside
the per-frame loop it replaced, the layout A/B at 1024^2 (K13
flat/packed, K2/K3, K7/K8) and K15/K16 beside the permute-copy. Phases
18-20 do the same for the sharded two-phase PDE: the shard-canvas modes
of K1, K2, K3 and K5 each against its plain version on every shard of a
2x2 and a 3x3 grid of the 4K images (a second launch bitwise the first,
each crop against the whole-image launch of the same kernel),
segment_sharded at 4K on a 2x2 grid of four shards on the card (gray and
RGB, comm_k 8 and 1, tolerance mode) and on the 1x1 mesh (flat and
packed), and segment_sharded_fixed_trace, with their masks, trace and
launch counts checked, and the times: each run's throughput beside the
unsharded banded driver, each shard mode per launch, and the halo
exchange that builds the canvases. Phases 21-23 do the same for the
sharded multiphase and morphological solvers: K9's shard-canvas mode, K1's
force mode with a parity and K11's shard kinds (acwe_sh, gac_pre_sh) each
against its plain version on every shard of a 2x2 and a 3x3 grid of the
4K images (each crop or owned block against the whole-image launch, K9
also over 2 and 8 launches chained on one canvas),
segment_multiphase_sharded at 4K on a 2x2 grid of four shards on the card
(fixed at comm_k 1 and 8, tolerance mode), its trace,
segment_morph_sharded_chunked and segment_gac_sharded_chunked at comm_k 8,
the per-iteration segment_morph_sharded / segment_gac_sharded at 1080p and
the multiphase sweeps with the lattice offset, each against the unsharded
run of its trajectory class, with every launch counted, and the times:
each run's throughput beside the unsharded route, each mode per launch,
and the halo exchange a chunk. Phases 24-26 do the same for the halo
mechanisms: K14 (exchange_halo2d_rdma, one clamped-gather launch an
exchange) bitwise against its plain version and exchange_halo2d on
every shard of a 2x2 and a 3x3 grid of the 4K
image and on the 1x1 self-ring at D = 4, 32 and 64, for the image and a
stack of two level sets (and on a grid over the cards where there are
several), segment_sharded (comm_k 8 and 1), segment_multiphase_sharded
(K9's shard mode, comm_k 1 and 8) and segment_sharded_fixed_trace with
halo='rdma' bitwise equal to halo='ppermute', K14's launches counted,
halo='overlap' (the kernels' hybrid at 4K against ppermute, the plain
route bitwise at 1080p), and the times: K14 an exchange, device and host
ms, beside exchange_halo2d and its bound
(the image at D = 4, 32, 64; the two level sets at D = 4, 64), and the 4K
rates of the three mechanisms.
Phase 27 does the same for the banded body of K2, K3, K5 and K6
(csrc/band.cuh, K3 and K6 on parity planes): registers, spills and (with
--sass-parent DIR, a checkout of the parent package) sass_diff.py's check
that every kernel body of the parent compiles as before; each mode (whole
image and shard canvas) against its plain version and its own second
launch at 4K gray and RGB (k = 1, 8, 21), a ragged shape and every shard
of the 2x2 and 3x3 grids and the 1x1 canvas (each crop bitwise equal to
the whole-image launch), K3 and K6 also bitwise K2's and K5's launch on
the unpacked inputs in phi and every partial; the body's queued times at
the main path's shapes beside the bound, blocks per SM and waves; and
phase 19's sharded runs (the 1x1 mesh also packed) and the 4K
segment_banded_fixed runs, flat and default-routed (packed), through the
entry points, their masks against the truth and every K2/K3/K5/K6 launch
counted, with their rates.
Phase 28 does the same for K9's band body (csrc/mp2_band.cu's
mp2_coupled_kernel, both modes): registers, spills, each mode's second
launches bitwise at 4K, a ragged shape and every shard of the 2x2 and 3x3
grids at D = 4 and over 2 and 8 launches chained on 8k-deep canvases
(phases 9 and 21 hold them against the plain versions); the body's
queued times at 4K and on the 2x2 canvas beside the bound, blocks per SM
and waves; and phase 23's three 4-phase runs through the entry points,
their K9 launches counted, with their rates.
Phase 29 does the same for the single-sweep body of K1 and K4
(csrc/sweep.cuh): registers and spills of every instantiation; each mode
(whole image, force mode with and without a parity, batch, shard canvas,
K4 RGB) against its second launch at 512^2, 4K gray and RGB, 16 x 1080p,
a ragged shape and every shard of the 2x2 and 3x3 grids (each crop
bitwise the whole-image launch, each batch frame bitwise its own launch)
and against its plain version; the body's queued times at the main
path's shapes beside the bound, blocks per SM and waves; and
segment_stack_fused_fixed (16 x 1080p), segment_fused_fixed (4K gray and
RGB), the multiphase sweeps route (512^2, M = 3) and segment_sharded
(2x2, comm_k 1) through the entry points, their launches counted and
their masks checked, with their rates.
Phase 30 does the same for the bit body of K11 and K12
(csrc/morph_bits.cuh): registers and spills of every instance and its
blocks an SM; each kind (acwe, gac, gac_pre, K12; acwe_sh and gac_pre_sh
on every shard of the 2x2 and 3x3 grids) bitwise its second launch and a
launch on a second stream, at phase 12's shapes and runs (phases 12 and
21 hold the same launches against the plain versions); the body's queued
times at 4K and on the 2x2 shard block beside the bound, blocks per SM
and waves; and segment_morph and segment_morph_iterations (4K gray and
RGB, fuse_force), segment_gac and segment_gac_iterations (4K, pre_dg both
ways), compat's GAC (1080p) and the sharded chunked morph and GAC drivers
(2x2, comm_k 8) through the entry points, their K11/K12 launches counted,
with their rates.
Phase 31 does the same for the tile bodies of K7, K8 (every mode), K9's
resident mode and K10 (csrc/resident_tiles.cuh, mp2.cuh): registers and
spills of every instance; each mode bitwise its second launch and a
launch on a second stream at phase 6's and 9's shapes and the main path's
(phases 6 and 9 hold the same launches against the plain versions); the
bodies' times at the main path's shapes (1000 iterations) beside the
bound, with the tiling, the dynamic shared memory and the blocks an SM;
and phase 8's and 11's fixed runs (segment_resident_fixed,
segment_stack_resident_fixed, segment_multiphase(fixed=True)) through the
entry points, the tile bodies' launches counted, with their rates.
Phase 32 does the same for M10 and R1, the redistance kernel
(csrc/reinit.cu, the port's kernel for the reference's jnp
ops/reinit.py::reinit): the registers and spills of R1's tile body; R1
against its plain version (bitwise, or identical signs and within 1e-5 of
max |phi|; the input left as it was) at 4K, at the pyramid's four coarser
level shapes and on stacks of two 1080p and two 4K level sets (20 steps),
and at 257x131 and the 1080p stack at 1 and 9 steps, f32 and f64; its
queued times a redistance beside the plain version and the bound at every
level shape, with the tile body's geometry, launches and blocks an SM;
segment_pyramid on the 4K pyramid cell (bench_families.py:166-180: the
time to the converged mask after a warm run, level_iters, R1's device
time from torch.profiler, the mask against the disk and the direct
segment_banded run, the finest level's iterations fewer than the direct
run's, one redistance a level boundary); segment_fused_fixed at 4K with
reinit_every = 10 against the plain route (and its rate beside the run
without a cadence) and segment_sharded on a 2x2 grid on the card (comm_k
1, reinit_every = 10) against the unsharded fused route, R1's and K1's
launches counted; and the CLI with --pyramid -1 --smooth 10
--reinit-every 10 on a 1080p image (.npy: the card's machine has no
Pillow), its mask against the truth.
Phase 33 drives the new modules' paths through the existing kernels at
4K gray: segment_sharded_with_checkpoints on a 2x2 grid on the card
(comm_k 8, 800 iterations, every 200: K2's shard mode) against the
unchunked segment_sharded, a run failed after its second save (a wrapped
save_sharded raises) and resumed bitwise the uninterrupted one, a torn
.tmp directory never picked by latest_sharded, the 1x1 packed (K3's shard
mode) and comm_k 1 halo='rdma' (K1's shard mode, K14) checkpointed runs;
the multiphase checkpoints at 1024^2 (K9 resident; K9's shard mode on the
2x2 grid) against the unchunked runs; the CLI's --mesh --trace-energy
(K1's shard mode) within 1e-5 of the unsharded segment_fixed's energy and
its --checkpoint-dir; the GIF helpers' last frames bitwise their main
runs' level sets (the sharded branch and the fixed one at 1080p), the
launches of every run, and the times of the checkpointed run beside the
plain one and of one save_sharded. Phase 34: utils.profiling.trace around
two K2 chunks (its JSON names the band kernel), time_fn against the CUDA
events, graft_entry.entry() against its plain version,
dryrun_multichip(4) on the card and demo.main into a temporary
directory (the .npy/.csv artifacts; the PNGs only with Pillow).
K1's force mode runs once under torch.cuda.set_sync_debug_mode("error")
(phase 9).
Any failure raises and exits non-zero.
The last lines are a JSON object per kernel, the card's name and power
limit, and {"ok": true, "device": {...}}. Without a CUDA device it exits
1 and prints no result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch finds no CUDA device")

import chan_vese_tpu_torch as ct  # noqa: E402
from chan_vese_tpu_torch import _build, compat  # noqa: E402
from chan_vese_tpu_torch.models import batched as batchedm  # noqa: E402
from chan_vese_tpu_torch.models import morph as morphm  # noqa: E402
from chan_vese_tpu_torch.models import morph_gac as gacm  # noqa: E402
from chan_vese_tpu_torch.models import multiphase as mpm  # noqa: E402
from chan_vese_tpu_torch.ops import (_cuda, banded_kernel,  # noqa: E402
                                     fused_kernel, fused_kernel_mc,
                                     morph_kernel, multiphase_kernel,
                                     packed_kernel, resident_kernel)
from chan_vese_tpu_torch.ops.morph import (  # noqa: E402
    binary_means, inverse_gaussian_gradient)
from chan_vese_tpu_torch.ops.reductions import region_means  # noqa: E402
from chan_vese_tpu_torch.parallel import halo_rdma  # noqa: E402
from chan_vese_tpu_torch.parallel import (  # noqa: E402
    exchange_halo2d, exchange_halo2d_batched, exchange_halo2d_rdma,
    grid_sharding, make_data_mesh, make_grid_mesh,
    segment_multiphase_sharded, segment_multiphase_sharded_fixed_trace,
    segment_sharded, segment_sharded_fixed_trace, segment_stack_sharded,
    shard_grid)
from chan_vese_tpu_torch.parallel.sharded import _shard_phis  # noqa: E402
from chan_vese_tpu_torch.parallel.sharded_morph import (  # noqa: E402
    segment_gac_sharded_chunked, segment_morph_sharded_chunked)
from chan_vese_tpu_torch.utils.init_phi import init_phi  # noqa: E402
from chan_vese_tpu_torch import cli as tcli  # noqa: E402
from chan_vese_tpu_torch import demo, graft_entry  # noqa: E402
from chan_vese_tpu_torch.utils import checkpoint as ckptm  # noqa: E402
from chan_vese_tpu_torch.utils import checkpoint_sharded as cks  # noqa: E402
from chan_vese_tpu_torch.utils import profiling  # noqa: E402
from chan_vese_tpu_torch.utils import trace as tracem  # noqa: E402

# the module of R1's wrapper (the ops package exports the function under
# the module's name), through which every caller reaches it
reinitm = sys.modules["chan_vese_tpu_torch.ops.reinit"]


def reinit_plain(phi, steps=20, dtau=0.5, h=1.0):
    return reinitm.reinit_reference(phi, steps, dtau, h)

H4K, W4K = 2160, 3840
SHAPES = ((H4K, W4K), (1080, 1920), (1000, 1500))  # 4K, 1080p, ragged
RGB = 3
# kernel vs plain on the card: rsqrtf/atanf/FMA contraction differ from
# PyTorch's ops in the last ulps and the stiff update amplifies that over
# k iterations; flips may differ at cells with |phi| below PHI_ATOL
PHI_RTOL, PHI_ATOL = 1e-4, 1e-4
PARTS_RTOL, PARTS_ATOL = 1e-4, 16.0
# per-channel weights of the extra k=1 check of the mc kernels (with
# lambda1 != lambda2 per channel the k-iteration chunk from the
# checkerboard start is ill-conditioned: plain f32 and f64 differ by 0.1 at
# k=8, so deeper chunks are held at the main path's default lambdas)
LAMBDAS = dict(lambda1=(1.0, 1.2, 0.8), lambda2=(0.9, 1.0, 1.1))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# operations per cell update of redblack.cuh::update_cell: 8 differences,
# 4 halvings, 4 face coefficients (2 squares, 2 adds, rsqrt, mu *), the
# Dirac factor (square, add, divide), num (4 products, 4 adds, 2) and den
# (3 adds, 2), the divide; rsqrt, divide and atan count as one operation
OPS_UPDATE = 55
# operations per pixel of the resident kernels' means, per iteration: the
# Heaviside (atan, divide, multiply, add) and its sum, plus a multiply and
# an add per channel; and of a partials row: d, d^2 and its sum, the flips
# (2 compares, not-equal, sum), |d| and its sum
OPS_MEANS, OPS_MEANS_CHANNEL, OPS_ROW = 4, 2, 8

KERNELS = {
    "K1 fused_iteration": dict(
        wrapper=fused_kernel.fused_iteration,
        plain=lambda phi, u0, c1, c2, p, k: (
            fused_kernel.fused_iteration_reference(phi, u0, c1, c2, p)),
        source="chan_vese_tpu_torch/csrc/sweep.cuh",
        replaces="chan_vese_tpu/ops/pallas_sweep.py:216", ks=(1,),
        packed=False, channels=0),
    "K2 banded_chunk": dict(
        wrapper=banded_kernel.banded_chunk,
        plain=banded_kernel.banded_chunk_reference,
        source="chan_vese_tpu_torch/csrc/band.cuh",
        replaces="chan_vese_tpu/ops/pallas_banded.py:104", ks=(1, 3, 8),
        packed=False, channels=0),
    "K3 packed_banded_chunk": dict(
        wrapper=packed_kernel.packed_banded_chunk,
        plain=packed_kernel.packed_banded_chunk_reference,
        source="chan_vese_tpu_torch/csrc/band.cuh",
        replaces="chan_vese_tpu/ops/pallas_packed.py:528", ks=(8,),
        packed=True, channels=0),
    "K4 fused_iteration_mc": dict(
        wrapper=fused_kernel_mc.fused_iteration_mc,
        plain=lambda phi, u0, c1, c2, p, k, **lam: (
            fused_kernel_mc.fused_iteration_mc_reference(phi, u0, c1, c2, p,
                                                         **lam)),
        source="chan_vese_tpu_torch/csrc/sweep.cuh",
        replaces="chan_vese_tpu/ops/pallas_sweep_mc.py:50", ks=(1,),
        packed=False, channels=RGB),
    "K5 banded_chunk_mc": dict(
        wrapper=banded_kernel.banded_chunk_mc,
        plain=banded_kernel.banded_chunk_mc_reference,
        source="chan_vese_tpu_torch/csrc/band.cuh",
        replaces="chan_vese_tpu/ops/pallas_banded.py:507", ks=(1, 3, 8),
        packed=False, channels=RGB),
    "K6 packed_banded_chunk_mc": dict(
        wrapper=packed_kernel.packed_banded_chunk_mc,
        plain=packed_kernel.packed_banded_chunk_mc_reference,
        source="chan_vese_tpu_torch/csrc/band.cuh",
        replaces="chan_vese_tpu/ops/pallas_packed.py:965", ks=(8,),
        packed=True, channels=RGB),
}
GRAY = [n for n, k in KERNELS.items() if not k["channels"]]
COLOR = [n for n, k in KERNELS.items() if k["channels"]]

# the resident modes: K7 (flat) and K8 (parity planes), each single-image
# scalar, batch and mc; the wrappers take (H, W) / (N, H, W) images
RESIDENT = {}
for _k, _mod, _pre, _src, _rep in (
        ("K7", resident_kernel, "resident", "resident",
         ("chan_vese_tpu/ops/pallas_resident.py", 58, 119, 177)),
        ("K8", packed_kernel, "packed_resident", "packed_resident",
         ("chan_vese_tpu/ops/pallas_packed.py", 1491, 1551, 1611))):
    for _mode, _line, _ch in (("", _rep[1], 0), ("_batch", _rep[2], 0),
                              ("_mc", _rep[3], RGB)):
        _fn = getattr(_mod, f"{_pre}_iterations{_mode}")
        RESIDENT[f"{_k} {_fn.__name__}"] = dict(
            wrapper=_fn, plain=getattr(_mod, f"{_fn.__name__}_reference"),
            module=_mod, source=f"chan_vese_tpu_torch/csrc/{_src}"
            f"{'_mc' if _ch else ''}.cu", replaces=f"{_rep[0]}:{_line}",
            mode=_mode, channels=_ch)
# the envelope shapes, a ragged even one, and the shapes phase 7 sends to
# K7: 1024x896 gray, stacks of 256x384 and 512x384 RGB (K8 gets 512^2 gray
# and RGB and stacks of 256^2 there)
RES_SHAPES = ((256, 256), (512, 512), (1024, 1024), (250, 398), (1024, 896),
              (256, 384), (512, 384))
# frames of the batch modes' stacks: 4, and at 256^2 the 8 of phase 7's K8
# stack (its K7 stack is 4 x 256x384)
RES_FRAMES = 4
RES_FRAMES_AT = {(256, 256): 8}
RES_TIMED = (1024, 1024)
# 16-iteration check of a resident mode against its plain version, from a
# circle start. The exact-means trajectory amplifies last-ulp differences
# (rsqrtf, atanf, FMA, f64 vs f32 means) every iteration: the plain
# version in f32 and in f64 differ by 2e-4 to 8e-3 of phi's largest value
# over these inputs, and that largest difference moves 10x between runs
# whose phi0 differs by 1e-7 relative, where the relative L2 difference
# moves under 3x (CPU runs of the plain version at 512^2 and 1024^2). So
# each run measures the plain f32 run's relative L2 difference from the
# plain f64 run and holds the kernel's to PHI16_FACTOR times it: no less
# accurate than the plain f32 run, within the factor. A cell may take the
# other sign than the plain f32 run only where its |phi| is at most
# FLIPS16_PHI, at most FLIPS16_FRAC of the cells; the rows' means sums are
# held at MEANS16_RTOL. From the
# checkerboard start at the default mu the run is chaotic in f32 (a 1e-7
# relative change of phi0 moves phi by 44 of 180 at 256^2), so it is not
# used here.
PHI16_FACTOR, MEANS16_RTOL, FLIPS16_FRAC = 4.0, 1e-5, 1e-4
FLIPS16_PHI = 10 * PHI_ATOL
# fixed iterations of the main-path stack and RGB runs (converged by then)
MAIN_FIXED_ITERS = 100
THROUGHPUT_ITERS = 1000

# the multiphase kernels (phases 9-11): the wrapper, its plain version,
# the shapes of the phase 9 checks (the main path's, a ragged even one for
# K9 banded) and the shape each is timed at
MP2 = {
    "K1 fused_sweep": dict(
        wrapper=fused_kernel.fused_sweep,
        plain=fused_kernel.fused_sweep_reference,
        source="chan_vese_tpu_torch/csrc/sweep.cuh",
        replaces="chan_vese_tpu/ops/pallas_sweep.py:216",
        shapes=((H4K, W4K), (512, 512)), timed=(H4K, W4K)),
    "K9 mp2_iteration": dict(
        wrapper=multiphase_kernel.mp2_iteration,
        plain=multiphase_kernel.mp2_iteration_reference,
        source="chan_vese_tpu_torch/csrc/mp2_band.cu",
        replaces="chan_vese_tpu/ops/pallas_multiphase.py:145",
        shapes=((H4K, W4K), (1024, 1152), (512, 512), (1000, 1152)),
        timed=(H4K, W4K)),
    "K9 mp2_resident_iterations": dict(
        wrapper=multiphase_kernel.mp2_resident_iterations,
        plain=multiphase_kernel.mp2_resident_iterations_reference,
        source="chan_vese_tpu_torch/csrc/mp2_resident.cu",
        replaces="chan_vese_tpu/ops/pallas_multiphase.py:346",
        shapes=((1024, 1024), (512, 384)), timed=(1024, 1024)),
    "K10 packed_mp2_resident_iterations": dict(
        wrapper=packed_kernel.packed_mp2_resident_iterations,
        plain=packed_kernel.packed_mp2_resident_iterations_reference,
        source="chan_vese_tpu_torch/csrc/packed_mp2_resident.cu",
        replaces="chan_vese_tpu/ops/pallas_packed.py:1343",
        shapes=((256, 256), (512, 512)), timed=(512, 512)),
}
# the JAX package's multiphase mu (tests/test_multiphase_mp2.py)
MU_MP = 0.003 * 255.0 ** 2
# one iteration of a 4-phase kernel against its plain version: the JAX
# package's bars for its kernels against jnp (tests/test_multiphase_mp2.py
# :36-37 banded, :84-85 resident; tests/test_multiphase_pallas.py:22-23 for
# the sweep); partial sums rtol 2e-4 (its means bar), label flips within
# FLIPS_CELLS cells (a cell whose new phi lies within an ulp of 0 may take
# either sign)
MP2_BARS = {"K1 fused_sweep": (2e-5, 2e-3), "K9 mp2_iteration": (2e-5, 2e-3),
            "K9 mp2_resident_iterations": (3e-4, 2e-3),
            "K10 packed_mp2_resident_iterations": (3e-4, 2e-3)}
MP2_PARTS_RTOL, FLIPS_CELLS = 2e-4, 16
# 25 iterations from init_multiphase: the coupling term amplifies last-ulp
# differences about 100x per iteration near phi = 0, so the runs are held
# on their labels: at most LABELS_FRAC of the cells differ (the JAX bar, 5
# of 8192 cells, tests/test_multiphase_mp2.py:90-103)
MP2_ITERS, LABELS_FRAC = 25, 1e-3
# iterations per resident launch in the timings: the tolerance driver's
# chunk
MP2_CHUNK = 32
# operations per pixel of a coupled iteration: two cell updates, the four
# squared distances (subtract, square), two Heavisides (atan, divide,
# multiply, add) and f0, f1 (1 - H, two differences, two products, two
# adds each); of the phase sums behind the means: two Heavisides, the four
# weights (two complements, four products) and u w_s and w_s summed (three
# each); of a partials row: the 2-bit labels and their flip count (six) and
# s_dphi2 (two differences, two squares, two adds)
OPS_MP2_ITER, OPS_MP2_SUMS, OPS_MP2_ROW = 2 * OPS_UPDATE + 8 + 8 + 14, 26, 12

# the morphological kernels (phases 12-14): K11's whole-image kinds and K12
_MORPH_SRC = "chan_vese_tpu_torch/csrc/morph_band.cu"
MORPH = {
    "K11 morph_chunk": dict(kind="acwe", source=_MORPH_SRC,
                            replaces="chan_vese_tpu/ops/pallas_morph.py:384"),
    "K11 gac_chunk": dict(kind="gac", source=_MORPH_SRC,
                          replaces="chan_vese_tpu/ops/pallas_morph.py:384"),
    "K11 gac_chunk pre_dg": dict(
        kind="gac_pre", source=_MORPH_SRC,
        replaces="chan_vese_tpu/ops/pallas_morph.py:384"),
    "K12 morph_chunk_fused": dict(
        kind="acwe_fused", source="chan_vese_tpu_torch/csrc/morph_fused.cu",
        replaces="chan_vese_tpu/ops/pallas_morph.py:281"),
}
MORPH_SHAPES = ((H4K, W4K), (1080, 1920), (1000, 1500))
# (k, smoothing, parity0[, balloon]) of each phase 12 check; the first is
# the one timed (the drivers' k)
MORPH_RUNS = {"acwe": ((8, 1, 0), (2, 3, 0), (8, 1, 1)),
              "gac": ((4, 1, 0, 1), (4, 1, 0, -1), (4, 1, 0, 0)),
              "acwe_fused": ((8, 1, 0), (3, 1, 0))}
MORPH_RUNS["gac_pre"] = MORPH_RUNS["gac"]
# K12's sum_in against the plain version's float64 sum
SUM_IN_RTOL = 1e-6
# operations per pixel (each min, max, compare, select, add and multiply
# one): per iteration the ACWE force step 8 (two differences, two |.|, an
# add, the product with f, two compare-selects), GAC's masked balloon 9
# and attraction 11 (two differences, two halvings, two products, an add,
# two compare-selects), per smoothing cycle 22 (two ops of four 2-wide
# line min/max, each 8 plus 3 to combine); once per launch K12's force 7
# and partials 3, the gac kind's dgx, dgy and mask 5
OPS_ACWE_FORCE, OPS_GAC_BALLOON, OPS_GAC_ATTRACT, OPS_CYCLE = 8, 9, 11, 22
OPS_MORPH_ONCE = {"acwe": 0, "gac": 5, "gac_pre": 0, "acwe_fused": 10}
# bytes per pixel a launch must move: ls and the force, edge map or image
# read, ls written; gac_pre reads the 3-plane stack
MORPH_BYTES = {"acwe": 12, "gac": 12, "gac_pre": 20, "acwe_fused": 12}
# the GAC scene: a bright disk of radius 28/96 of the short side on a dark
# ground, noise 3 (tests/test_morph_gac.py:91-99 scaled up), its edge map
# inverse_gaussian_gradient(alpha=5, sigma=2) and a disk seed 32 px larger
GAC_RADIUS, GAC_MARGIN, GAC_THRESHOLD = 28 / 96, 32, 0.3
MORPH_ITERS, MORPH_PLAIN_ITERS = 800, 40
# iterations of phase 30's fixed-iteration runs
MORPH_BITS_ITERS = 200
# the compat entry point's image (1080p)
COMPAT_SHAPE = (1080, 1920)

# frame stacks and the layout kernels (phases 15-17)
STACK = {
    "K1 fused_iteration_batch": dict(
        source="chan_vese_tpu_torch/csrc/sweep.cuh",
        replaces="chan_vese_tpu/ops/pallas_sweep.py:216"),
    "K13 packed_chunk (flat)": dict(
        source="chan_vese_tpu_torch/csrc/resident_chunk.cu",
        replaces="chan_vese_tpu/ops/pallas_packed.py:384", packed=False),
    "K13 packed_chunk (packed)": dict(
        source="chan_vese_tpu_torch/csrc/resident_chunk.cu",
        replaces="chan_vese_tpu/ops/pallas_packed.py:328", packed=True),
    "K15 pack_planes": dict(source="chan_vese_tpu_torch/csrc/pack.cu",
                            replaces="scripts/bench_pack.py:124"),
    "K16 unpack_planes": dict(source="chan_vese_tpu_torch/csrc/pack.cu",
                              replaces="scripts/bench_pack.py:148"),
}
# K1 batch: the 1080p video stack phase 16 sends it and a ragged one (1000
# rows: not a multiple of the 64-row tile) inside the fused envelope,
# which fused_iteration_batch holds to as the reference does
VIDEO_FRAMES = 16
K1B_STACKS = ((VIDEO_FRAMES, 1080, 1920), (3, 1000, 1408))
# K13: inside its envelope (supports_packed), 720p the ragged shape
K13_SHAPES, K13_KS, K13_TIMED = ((512, 512), (1024, 1024), (720, 1280)), \
    (1, 3, 8), (1024, 1024)
# K15/K16: 4K, 4K RGB channels-first, the 64 x 512^2 stack, W % 4 == 2
STACK_FRAMES = 64
PACK_SHAPES = ((H4K, W4K), (RGB, H4K, W4K), (STACK_FRAMES, 512, 512),
               (1000, 1502))
# the tolerance-mode stack of phase 16: frames with their own noise level
# (seeds 0-3), which stop at different iterations (7, 23, 27, 11 on the
# CPU, f32 and f64 alike)
TOL_STACK, TOL_NOISES = (4, 256, 256), (8.0, 20.0, 20.0, 12.0)

# the sharded two-phase PDE (phases 18-20): the shard-canvas modes of K1,
# K2, K3 and K5; k the chunk each is checked and timed at (K5 also at
# k = 1, the RGB per-iteration route)
SHARD = {
    "K1 fused_iteration (shard)": dict(
        source="chan_vese_tpu_torch/csrc/sweep.cuh",
        replaces="chan_vese_tpu/ops/pallas_sweep.py:381", ks=(1,),
        channels=0, counter=(fused_kernel.fused_iteration,
                             "shard_launches")),
    "K2 banded_chunk_sharded": dict(
        source="chan_vese_tpu_torch/csrc/band.cuh",
        replaces="chan_vese_tpu/ops/pallas_banded.py:399", ks=(8,),
        channels=0, counter=(banded_kernel.banded_chunk_sharded,
                             "launches")),
    "K3 packed_banded_chunk_sharded": dict(
        source="chan_vese_tpu_torch/csrc/band.cuh",
        replaces="chan_vese_tpu/ops/pallas_packed.py:857", ks=(8,),
        channels=0, counter=(packed_kernel.packed_banded_chunk_sharded,
                             "launches")),
    "K5 banded_chunk_mc_sharded": dict(
        source="chan_vese_tpu_torch/csrc/band.cuh",
        replaces="chan_vese_tpu/ops/pallas_banded.py:800", ks=(8, 1),
        channels=RGB, counter=(banded_kernel.banded_chunk_mc_sharded,
                               "launches")),
}
# grids of shards on the one card: 2x2 (1080x1920 shards, every shard a
# corner) and 3x3 (720x1280; side shards and a centre one without flags)
SHARD_GRIDS = ((2, 2), (3, 3))
# phase 19's runs: comm_k, and the iterations of the fixed runs
SHARD_K, SHARD_ITERS, SHARD_ITERS_K1, TRACE_ITERS = 8, 800, 100, 50
# the trace's energy against the unsharded plain trace (BASELINE.json:5)
TRACE_RTOL = 1e-5

# the sharded multiphase and morphological solvers (phases 21-23): K9's
# shard-canvas mode, K1's force mode with a parity and K11's shard kinds;
# the counter each wrapper adds to where it launches
MP_SHARD = {
    "K9 mp2_iteration_sharded": dict(
        source="chan_vese_tpu_torch/csrc/mp2_band.cu",
        replaces="chan_vese_tpu/ops/pallas_multiphase.py:279",
        counter=(multiphase_kernel.mp2_iteration_sharded, "launches")),
    "K1 fused_sweep (parity)": dict(
        source="chan_vese_tpu_torch/csrc/sweep.cuh",
        replaces="chan_vese_tpu/ops/pallas_sweep.py:467",
        counter=(fused_kernel.fused_sweep, "parity_launches")),
    "K11 morph_chunk_shard (acwe_sh)": dict(
        source=_MORPH_SRC, replaces="chan_vese_tpu/ops/pallas_morph.py:675",
        counter=(morph_kernel.morph_chunk_shard, "launches")),
    "K11 gac_chunk_shard (gac_pre_sh)": dict(
        source=_MORPH_SRC, replaces="chan_vese_tpu/ops/pallas_morph.py:694",
        counter=(morph_kernel.gac_chunk_shard, "launches")),
}
# K9 launches chained on one 8k-deep canvas (the comm_k chunk), phase 21
MP_CHAIN_KS = (2, 8)
# comm_k of the sharded morph runs and K11's shard launches (ACWE D = 24,
# GAC D = 32 at smoothing 1)
MORPH_SHARD_K = 8
# iterations: the multiphase runs (phases 22-23), its trace, the fixed
# morph runs of phase 22 and of the timings
MP_SHARD_ITERS, MP_TRACE_ITERS = 100, 20
MORPH_SHARD_ITERS, MORPH_SHARD_RATE_ITERS = 200, 800
# the trace's energy against segment_multiphase_fixed (phase 10's bar) and
# against the energy of its own final state assembled on one image. From
# the checkerboard the f32 trajectory passes a fast transition (the energy
# falls 20x in 6 iterations) where ulp-level differences of the means, as
# summing them per shard makes, move the energy by up to 2e-2 (the same
# sharding on the plain route, on an H100 80GB HBM3 at 700 W): the sharded
# trace is held within MP_ENERGY_RTOL of the unsharded kernel route or
# within twice the plain routes' sharded-vs-unsharded gap of the same run,
# whichever is larger, and its labels agree with the unsharded route's
MP_ENERGY_RTOL, MP_ENERGY_SELF_RTOL = 1e-3, 1e-5
# mu of phase 22's comm_k = 8 multiphase run held to the truth: at MU_MP
# the comm_k = 8 frozen-means class (the unsharded frozen-means K9 loop as
# well) merges two phases of the 4K image (accuracy 0.528 at 100 to 400
# iterations on an H100 80GB HBM3 at 700 W); at this mu it converges. The
# run at MU_MP is held to the unsharded frozen-means loop and its accuracy
# printed, without a bar.
MU_MP_SHARD = 0.001 * 255.0 ** 2

# the halo mechanisms (phases 24-26): K14's clamped gather, the exchange of
# halo='rdma'; the counter its wrapper adds to where it launches
HALO = {
    "K14 exchange_halo2d_rdma": dict(
        source="chan_vese_tpu_torch/csrc/halo_gather.cu",
        replaces="chan_vese_tpu/parallel/halo_rdma.py:54",
        counter=(exchange_halo2d_rdma, "launches")),
}
# the depths the main path exchanges at: comm_k = 1 (D = 4), the two-phase
# comm_k = 8 chunk (D = 32) and the multiphase one (D = 64); the JSON line
# carries K14's numbers at D = 32
HALO_DEPTHS, HALO_TIMED = (4, 32, 64), 32
# K14 launches an exchange on the main path: one a device, the four shards
# on the one card
K14_PER_EXCHANGE = 1

# the redistance (phase 32): R1, the port's kernel for the reference's jnp
# ops/reinit.py::reinit, counted a launch: a pass of the tile body
# (ceil(steps / k) a redistance, r1_launches)
REINIT = {
    "R1 reinit": dict(
        source="chan_vese_tpu_torch/csrc/reinit.cu",
        replaces="chan_vese_tpu/ops/reinit.py:61 (jnp, no Pallas kernel)"),
}
# the pyramid's levels at 4K (plan_levels(2160, 3840) = 4), coarse to
# fine, and the redistance's steps (CVParams.reinit_steps)
PYRAMID_SHAPES = ((135, 240), (270, 480), (540, 960), (1080, 1920),
                  (H4K, W4K))
REINIT_STEPS = 20
# the shapes R1 is held against its plain version at every step count of
# STEP_COUNTS: a ragged one and a stack
REINIT_RAGGED, REINIT_STACK = (257, 131), (2, 1080, 1920)
STEP_COUNTS = (1, 9, 20)
# operations a cell of the redistance needs (one of each pair of branches
# the plain version computes on every cell): the prepass (central
# differences and halvings 4, |grad|^2 3, the crossing test 11, and the
# smoothed sign or the clipped subcell estimate 6); a step off the
# crossing (4 differences, 4 clamps, 4 squares, 2 maxima, a sum, a square
# root: one Godunov branch; the PDE update 4) and on it (the subcell
# update 5)
OPS_REINIT_PRE, OPS_REINIT_PDE, OPS_REINIT_SUB = 24, 20, 5
# f64 outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAK_F64 = 34e12
# R1 against its plain version where it is not bitwise: identical signs,
# max |difference| within this fraction of max |phi|
REINIT_RTOL = 1e-5
# the pyramid cell (bench_families.py:166-180): a 4K disk of radius 800,
# 200 on 0, noise 5, from the circle start
PYR_PARAMS = dict(init="circle", tol=1e-4, patience=4, min_iter=4)
# iterations of the direct run carried on to the disk (segment_banded
# from the same start stops at ~320 by the tolerance, IoU 0.79 to the
# disk, its contour still travelling: the pyramid's basin-rescue case)
PYR_DIRECT_ITERS = 2400
# the cadence runs: iterations and the cadence
CADENCE_ITERS, CADENCE_EVERY = 100, 10
# iterations of the plain overlap route held bitwise at 1080p, and of the
# 4K overlap runs at comm_k 8 and 1: its rim strips are plain-torch
# launches, host-bound at 0.2-0.25 s a chunk on the 2x2 grid of an H100
# 80GB HBM3 at 700 W (PERF.md), so it runs 12 chunks, not phase 19's 100
OVERLAP_PLAIN_ITERS = 16
OVERLAP_ITERS = {SHARD_K: 96, 1: 20}


def two_disks(h, w, fg=217.0, bg=38.0, noise=8.0, seed=0):
    """Two bright disks on a dark background plus Gaussian noise, and the
    ground-truth mask (the recipe of tests/fixtures.py)."""
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(np.float64)
    gt = ((np.hypot(i - 0.3 * h, j - 0.3 * w) < 0.15 * min(h, w))
          | (np.hypot(i - 0.68 * h, j - 0.65 * w) < 0.2 * min(h, w)))
    img = np.where(gt, fg, bg) + noise * rng.standard_normal(gt.shape)
    return img.astype(np.float32), gt


def colored_squares(h, w, noise=8.0, seed=1):
    """RGB image: two differently colored squares on a gray background
    plus Gaussian noise, and the ground-truth mask (the recipe of
    tests/fixtures.py)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), (30.0, 40.0, 50.0))
    gt = np.zeros((h, w), dtype=bool)
    sq1 = np.s_[h // 8: h // 8 + h // 4, w // 8: w // 8 + w // 4]
    sq2 = np.s_[h // 2: h // 2 + h // 3, w // 2: w // 2 + w // 3]
    img[sq1], gt[sq1] = (230.0, 200.0, 60.0), True
    img[sq2], gt[sq2] = (210.0, 60.0, 230.0), True
    img = img + noise * rng.standard_normal(img.shape)
    return img.astype(np.float32), gt


def iou(a, b):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return float((a & b).sum() / max((a | b).sum(), 1))


def iou_phases(mask, gt):
    """IoU with the truth up to the swap of the two phases: from the
    checkerboard start the data decide which region ends as phi >= 0."""
    mask = np.asarray(mask, bool)
    return max(iou(mask, gt), iou(~mask, gt))


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, n):
    """Mean device time of fn over n calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# cycles of the spin that holds the stream while queued_ms enqueues its
# calls (~20 ms at the H100's clock: room for 50 calls of ~0.4 ms of host
# time each); doubled up to 16x where the host needs longer
QUEUE_SPIN_CYCLES = 40_000_000


def queued_ms(fn, n):
    """Mean device time of fn over n calls with the host out of the way: a
    spin kernel holds the stream while the n calls are queued behind it,
    so the events time their kernels back to back. For launches about as
    short as their host-side cost, which time_ms measures at the host's
    pace. Raises if even the longest spin ends before the calls are
    queued."""
    fn()
    torch.cuda.synchronize()
    for spin in (QUEUE_SPIN_CYCLES << s for s in range(5)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()  # the spin outlasted the enqueueing
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / n
    raise AssertionError(f"queued_ms: {n} calls took longer to enqueue "
                         f"than a spin of {spin} cycles")


def roofline(nbytes, ops):
    """(ms, "bytes" or "operations"): the larger of the two least times on
    an H100 SXM."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_mp2(h, w, iters, rows, resident):
    """Least time of one 4-phase launch at (h, w): phi0, phi1 and u0 read
    once, phi0 and phi1 written once (20 B/pixel), against ``iters``
    coupled iterations, the phase sums (every iteration on the resident
    route, once for the banded one) and ``rows`` partials rows."""
    sums = iters if resident else 1
    per_pixel = (iters * OPS_MP2_ITER + sums * OPS_MP2_SUMS
                 + rows * OPS_MP2_ROW)
    return roofline(20 * h * w, h * w * per_pixel)


def bound_sweep(h, w):
    """Least time of one force-mode sweep: phi and f read, phi written,
    against one cell update and the partials (14) per pixel."""
    return roofline(12 * h * w, h * w * (OPS_UPDATE + 14))


def bound(h, w, k, channels, frames=1, rows=None):
    """(ms, "bytes" or "operations"): the least time an H100 SXM takes for
    one launch's work at (h, w), k iterations, ``channels`` (0 = gray), on
    ``frames`` images: phi and every u0 channel read once and phi written
    once, against the operations of k updates per pixel plus the data term
    (8 per channel) and the partials (14 + 2 per channel) once per pixel.
    ``rows`` given: an exact-means resident launch, which computes the
    data term and the means (OPS_MEANS + OPS_MEANS_CHANNEL per channel) at
    every iteration and ``rows`` partials rows (OPS_ROW each)."""
    c = max(channels, 1)
    nbytes = 4 * h * w * (2 + c) * frames
    if rows is None:
        per_pixel = OPS_UPDATE * k + 8 * c + 14 + 2 * c
    else:
        per_pixel = (k * (OPS_UPDATE + 8 * c + OPS_MEANS
                          + OPS_MEANS_CHANNEL * c) + rows * OPS_ROW)
    return roofline(nbytes, h * w * frames * per_pixel)


def four_regions(h, w, noise=4.0, seed=2):
    """Piecewise-constant 4-region image (values 13/89/166/242, a disk of
    class 3 inside class 0) plus Gaussian noise, and its labels (the
    recipe of tests/fixtures.py)."""
    rng = np.random.default_rng(seed)
    labels = np.zeros((h, w), dtype=np.int32)
    labels[: h // 2, w // 2:] = 1
    labels[h // 2:, : w // 2] = 2
    labels[h // 2:, w // 2:] = 3
    i, j = np.mgrid[0:h, 0:w]
    labels[np.hypot(i - h // 4, j - w // 4) < min(h, w) // 8] = 3
    img = np.array([13.0, 89.0, 166.0, 242.0])[labels]
    img = img + noise * rng.standard_normal(img.shape)
    return img.astype(np.float32), labels


def rgb_four_regions(h, w, noise=3.0, seed=0):
    """RGB image: four colored quadrants plus Gaussian noise, and its
    labels (the recipe of tests/test_multiphase_vector.py)."""
    rng = np.random.default_rng(seed)
    colors = np.array([[220.0, 40.0, 40.0], [40.0, 220.0, 40.0],
                       [40.0, 40.0, 220.0], [200.0, 200.0, 200.0]])
    labels = np.zeros((h, w), np.int32)
    labels[: h // 2, w // 2:] = 1
    labels[h // 2:, : w // 2] = 2
    labels[h // 2:, w // 2:] = 3
    img = colors[labels] + noise * rng.standard_normal((h, w, 3))
    return img.astype(np.float32), labels


def best_accuracy(pred, gt):
    """Label accuracy against the truth under the best permutation of the
    four phases."""
    pred = np.asarray(pred)
    return max(float((np.asarray(perm)[pred] == gt).mean())
               for perm in itertools.permutations(range(4)))


def ptxas_summary():
    """Registers and spill stores of every band_kernel, sweep_kernel,
    tile_resident_kernel, mp2_coupled_kernel, mp2_tile_kernel,
    morph_bits_kernel and halo_gather_kernel instance, from ptxas's -v
    report of the build: 'kind flat/packed [C=n]: R regs, S B spill' (C =
    -1 is K1's force mode; 'frozen' the tile body's frozen-means mode,
    K13), 'morph_bits <kind>: ...', 'halo_gather f32/f64: ...'."""
    out, name = {}, None
    morph_kinds = ("acwe", "gac", "gac_pre", "acwe_fused", "acwe_sh",
                   "gac_pre_sh")
    for line in _build.ptxas_report().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:  # the lines up to the next entry describe this one
            mb = re.search(r"[^_]band_kernelILi(\d+)ELb(\d)ELb(\d)E",
                           m.group(1))
            msw = re.search(r"sweep_kernelILi(n?)(\d+)ELb(\d)E", m.group(1))
            mm = re.search(r"morph_bits_kernelILi(\d)E", m.group(1))
            mh = re.search(r"halo_gather_kernelI([fd])", m.group(1))
            m = re.search(r"(mp2_coupled|mp2_tile|tile_resident)_kernel"
                          r"(?:ILb(\d)E(?:Li(n?)(\d+)E)?(?:Lb(\d)E)?)?",
                          m.group(1))
            name = None
            if mb:
                nc = int(mb.group(1))
                name = ("band", ("flat", "packed")[mb.group(3) == "1"],
                        (f" C={nc}" if nc else "")
                        + (" shard" if mb.group(2) == "1" else ""))
            elif msw:
                nc = int(msw.group(2)) * (-1 if msw.group(1) else 1)
                name = ("sweep", "flat", (f" C={nc}" if nc else "")
                        + (" shard" if msw.group(3) == "1" else ""))
            elif mm:
                name = ("morph_bits", morph_kinds[int(mm.group(1))], "")
            elif mh:
                name = ("halo_gather", f"f{32 if mh.group(1) == 'f' else 64}",
                        "")
            elif m:
                c = ("" if m.group(4) is None else
                     f" C={'-' if m.group(3) else ''}{m.group(4)}")
                # K9's band body's one template flag is SHARD
                one = m.group(1) == "mp2_coupled"
                shard = (m.group(2) if one else m.group(5)) == "1"
                packed = not one and m.group(2) == "1"
                flag = (" frozen" if m.group(1) == "tile_resident" else
                        " shard")
                name = (m.group(1), ("flat", "packed")[packed],
                        c + (flag if shard else ""))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(name, {})["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["regs"] = int(m.group(1))
    return ", ".join(f"{kind} {lay}{c}: {v.get('regs')} regs "
                     f"{v.get('spill')} B spill"
                     for (kind, lay, c), v in sorted(out.items()))


@contextlib.contextmanager
def plain_route():
    """The drivers with every kernel call replaced by its plain version
    (the same driver code on the same card, without the kernels)."""
    saved = (fused_kernel.fused_iteration, banded_kernel.banded_chunk,
             packed_kernel.packed_banded_chunk,
             fused_kernel_mc.fused_iteration_mc,
             banded_kernel.banded_chunk_mc,
             packed_kernel.packed_banded_chunk_mc)
    # the resident wrappers take their plain versions' arguments
    saved_resident = {name: r["wrapper"] for name, r in RESIDENT.items()}
    for r in RESIDENT.values():
        setattr(r["module"], r["wrapper"].__name__, r["plain"])
    # the morph wrappers take their plain versions' arguments
    morph_names = ("morph_chunk", "gac_chunk", "morph_chunk_fused")
    saved_morph = {n: getattr(morph_kernel, n) for n in morph_names}
    for n in morph_names:
        setattr(morph_kernel, n, getattr(morph_kernel, f"{n}_reference"))
    # R1, reached through its module by every caller
    saved_reinit = reinitm.reinit
    reinitm.reinit = reinit_plain
    # K1 batch, K13 and the pack pair (every packed route packs through it)
    saved_stack = (fused_kernel.fused_iteration_batch,
                   packed_kernel.packed_chunk, packed_kernel.pack_planes,
                   packed_kernel.unpack_planes)
    fused_kernel.fused_iteration_batch = (
        fused_kernel.fused_iteration_batch_reference)
    packed_kernel.packed_chunk = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, packed=True:
        packed_kernel.packed_chunk_reference(phi, u0, c1, c2, p, k))
    packed_kernel.pack_planes = packed_kernel.pack_planes_reference
    packed_kernel.unpack_planes = packed_kernel.unpack_planes_reference
    fused_kernel.fused_iteration = fused_kernel.fused_iteration_reference
    banded_kernel.banded_chunk = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, fuse=False:
        banded_kernel.banded_chunk_reference(phi, u0, c1, c2, p, k))
    packed_kernel.packed_banded_chunk = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, fuse=False:
        packed_kernel.packed_banded_chunk_reference(phi, u0, c1, c2, p, k))
    fused_kernel_mc.fused_iteration_mc = (
        fused_kernel_mc.fused_iteration_mc_reference)
    banded_kernel.banded_chunk_mc = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, lambda1=None,
        lambda2=None, fuse=False: banded_kernel.banded_chunk_mc_reference(
            phi, u0, c1, c2, p, k, lambda1, lambda2))
    packed_kernel.packed_banded_chunk_mc = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, fuse=False, lambda1=None,
        lambda2=None: packed_kernel.packed_banded_chunk_mc_reference(
            phi, u0, c1, c2, p, k, lambda1, lambda2))
    try:
        yield
    finally:
        (fused_kernel.fused_iteration, banded_kernel.banded_chunk,
         packed_kernel.packed_banded_chunk,
         fused_kernel_mc.fused_iteration_mc, banded_kernel.banded_chunk_mc,
         packed_kernel.packed_banded_chunk_mc) = saved
        for name, fn in saved_resident.items():
            setattr(RESIDENT[name]["module"], fn.__name__, fn)
        for n, fn in saved_morph.items():
            setattr(morph_kernel, n, fn)
        (fused_kernel.fused_iteration_batch, packed_kernel.packed_chunk,
         packed_kernel.pack_planes, packed_kernel.unpack_planes) = saved_stack
        reinitm.reinit = saved_reinit


def check_kernel(name, kern, args, c1, c2, p, k, h, w, lam):
    """One kernel launch against its plain version; returns max |d phi|."""
    kw = {} if kern["ks"] == (1,) else {"k": k}
    got_phi, got_parts = kern["wrapper"](*args, c1, c2, p, **kw, **lam)
    ref_phi, ref_parts = kern["plain"](*args, c1, c2, p, k, **lam)
    torch.cuda.synchronize()
    err = float((got_phi - ref_phi).abs().max())
    ok_phi = torch.allclose(got_phi, ref_phi, rtol=PHI_RTOL, atol=PHI_ATOL)
    sure = ref_phi.abs() > PHI_ATOL
    ok_mask = bool(((got_phi >= 0) == (ref_phi >= 0))[sure].all())
    ok_parts = (got_parts.shape == ref_parts.shape
                and torch.allclose(got_parts, ref_parts, rtol=PARTS_RTOL,
                                   atol=PARTS_ATOL))
    tag = f"{h}x{w}" + (f"x{kern['channels']}" if kern["channels"] else "")
    print(f"phase 3 {name} k={k} {tag}{' per-channel lambda' if lam else ''}"
          f": phi max|d|={err:.3e} parts max|d|="
          f"{float((got_parts - ref_parts).abs().max()):.3e} "
          f"(phi rtol {PHI_RTOL} atol {PHI_ATOL}, parts rtol "
          f"{PARTS_RTOL} atol {PARTS_ATOL})", flush=True)
    if not (ok_phi and ok_mask and ok_parts and math.isfinite(err)):
        raise AssertionError(f"{name} k={k} at {tag} disagrees with its "
                             f"plain version")
    return err


def resident_inputs(r, phi, u0, ucf, stack):
    """The arguments of resident mode ``r`` before the params: one gray
    image, a stack of frames (each from phi), or a channels-first image."""
    if r["mode"] == "_batch":
        return phi.expand(stack.shape).contiguous(), stack
    return (phi, ucf) if r["channels"] else (phi, u0)


def rel_l2(x, ref):
    """||x - ref|| / ||ref|| over all cells, in f64."""
    return float((x.double() - ref).norm() / ref.norm())


def check_resident(name, r, args, p, iters, unroll, lam, tag):
    """One resident launch against its plain version; returns max |d phi|.
    One iteration is held at phase 3's bars; more at PHI16_FACTOR times
    the plain version's own f32 error, the sign flips at FLIPS16_FRAC and
    the rows' means sums at MEANS16_RTOL. A second launch must repeat the
    first bit for bit: the means are reduced in a fixed order without
    atomics, so a difference means a read raced a write across a grid
    sync."""
    got_phi, got_parts = r["wrapper"](*args, p, iters, unroll=unroll, **lam)
    again_phi, again_parts = r["wrapper"](*args, p, iters, unroll=unroll,
                                          **lam)
    ref_phi, ref_parts = r["plain"](*args, p, iters, unroll=unroll, **lam)
    torch.cuda.synchronize()
    if not (torch.equal(got_phi, again_phi)
            and torch.equal(got_parts, again_parts)):
        raise AssertionError(f"{name} iters={iters} at {tag}: two launches "
                             f"on the same input differ")
    err = float((got_phi - ref_phi).abs().max())
    sure = ref_phi.abs() > PHI_ATOL
    flips = ((got_phi >= 0) != (ref_phi >= 0)) & sure
    n_flips = int(flips.sum())
    flip_phi = float(ref_phi.abs()[flips].max()) if n_flips else 0.0
    if iters == 1:
        ok_phi = torch.allclose(got_phi, ref_phi, rtol=PHI_RTOL,
                                atol=PHI_ATOL)
        ok_mask = n_flips == 0
        bar = (f"phi rtol {PHI_RTOL} atol {PHI_ATOL}, no sign flip where "
               f"|phi| > {PHI_ATOL}")
    else:
        ref64, _ = r["plain"](*(a.double() for a in args), p, iters,
                              unroll=unroll, **lam)
        e32 = float((ref_phi.double() - ref64).abs().max())
        e_kern = float((got_phi.double() - ref64).abs().max())
        l2_32 = rel_l2(ref_phi, ref64)
        l2_kern = rel_l2(got_phi, ref64)
        ok_phi = l2_kern <= PHI16_FACTOR * l2_32
        ok_mask = (n_flips <= FLIPS16_FRAC * ref_phi.numel()
                   and flip_phi <= FLIPS16_PHI)
        bar = (f"relative L2 vs plain f64: kernel {l2_kern:.3e}, plain f32 "
               f"{l2_32:.3e}, bar {PHI16_FACTOR} x plain f32; max vs plain "
               f"f64: kernel {e_kern:.3e}, plain f32 {e32:.3e}; flips only "
               f"where |phi| <= {FLIPS16_PHI:g}, at most {FLIPS16_FRAC} of "
               f"cells")
    nrow = r["channels"] + 4 if r["channels"] else 8
    want_shape = ((args[0].shape[0], nrow) if r["mode"] == "_batch"
                  else (iters // unroll, nrow))
    ok_shape = tuple(got_parts.shape) == tuple(ref_parts.shape) == want_shape
    nmeans = max(r["channels"], 1) + 1
    means_err = float(((got_parts[:, :nmeans] - ref_parts[:, :nmeans]).abs()
                       / ref_parts[:, :nmeans].abs().clamp_min(1.0)).max())
    if iters == 1:
        ok_parts = ok_shape and torch.allclose(
            got_parts, ref_parts, rtol=PARTS_RTOL, atol=PARTS_ATOL)
    else:
        ok_parts = (ok_shape and bool(torch.isfinite(got_parts).all())
                    and means_err <= MEANS16_RTOL)
    print(f"phase 6 {name} {tag} iters={iters} unroll={unroll}"
          f"{' per-channel lambda' if lam else ''}: phi max|d|={err:.3e} "
          f"(scale {float(ref_phi.abs().max()):.3e}) parts "
          f"{tuple(got_parts.shape)} max|d|="
          f"{float((got_parts - ref_parts).abs().max()):.3e} means sums "
          f"rel {means_err:.3e}; {n_flips} sign flips where |phi| > "
          f"{PHI_ATOL}, largest |phi| there {flip_phi:.3e}; second launch "
          f"bitwise equal ({bar})", flush=True)
    if not (ok_phi and ok_mask and ok_parts and math.isfinite(err)):
        raise AssertionError(f"{name} iters={iters} at {tag} disagrees "
                             f"with its plain version")
    return err


def label_frac(a, b):
    """Fraction of cells whose phase labels differ between two stacks of
    level sets."""
    return float((mpm.labels_from_phis(a) != mpm.labels_from_phis(b))
                 .double().mean())


def mp2_inputs(h, w, dev, p):
    """The multiphase main path's inputs at (h, w): the four-regions image,
    the init_multiphase start, its phase means and phi0's coupling force
    (fused_sweep's input on the sweeps route)."""
    u = torch.from_numpy(four_regions(h, w)[0]).to(dev)
    phis = mpm.init_multiphase((h, w), 2, device=dev)
    cs = torch.stack(mpm.phase_means(u, phis, p.eps))
    return u, phis, cs, mpm._coupling_term(u, phis, cs, 0, p)


def mp2_calls(name, u, phis, cs, f, p):
    """(one call, a MP2_ITERS-iteration run) of 4-phase kernel ``name`` as
    functions of the wrapper or the plain version; each returns (level
    sets, partials)."""
    if name == "K1 fused_sweep":
        phi = phis[0].contiguous()

        def many(fn):
            x = phi
            for _ in range(MP2_ITERS):
                x, parts = fn(x, f, p)
            return x[None], parts
        return (lambda fn: (lambda r: (r[0][None], r[1]))(fn(phi, f, p)),
                many)
    if "resident" in name:
        return (lambda fn: fn(phis, u, p, 1),
                lambda fn: fn(phis, u, p, MP2_ITERS, unroll=5))

    def many(fn):  # the banded driver's loop: means from the partials
        x, c = phis, cs
        for _ in range(MP2_ITERS):
            x, parts = fn(x, u, c, p)
            c = parts[0:4] / torch.clamp(parts[4:8], min=1e-30)
        return x, parts
    return lambda fn: fn(phis, u, cs, p), many


def check_mp2(name, kern, u, phis, cs, f, p, tag):
    """One launch of 4-phase kernel ``name`` against its plain version at
    MP2_BARS, its partials at MP2_PARTS_RTOL / FLIPS_CELLS, a second
    launch bitwise equal to the first, and MP2_ITERS iterations held on
    their labels at LABELS_FRAC. Returns max |d phi| of the one call."""
    one, many = mp2_calls(name, u, phis, cs, f, p)
    got, gparts = one(kern["wrapper"])
    again, aparts = one(kern["wrapper"])
    ref, rparts = one(kern["plain"])
    torch.cuda.synchronize()
    repeat = torch.equal(got, again) and torch.equal(gparts, aparts)
    rtol, atol = MP2_BARS[name]
    err = float((got - ref).abs().max())
    ok_phi = torch.allclose(got, ref, rtol=rtol, atol=atol)
    g, r = gparts.reshape(-1).double(), rparts.reshape(-1).double()
    # (flips slot, summed slots, zero slots) of each partials layout
    flip, sums, zero = {"K1 fused_sweep": (3, [2, 4], [5, 6, 7]),
                        "K9 mp2_iteration": (8, list(range(8)) + [9],
                                             list(range(10, 16)))}.get(
        name, (0, [1], list(range(2, 8))))
    flips_d = float((g[flip] - r[flip]).abs())
    sums_rel = float(((g[sums] - r[sums]).abs() / r[sums].abs()).max())
    ok_parts = (gparts.shape == rparts.shape and flips_d <= FLIPS_CELLS
                and sums_rel <= MP2_PARTS_RTOL and not g[zero].any())
    got_n, parts_n = many(kern["wrapper"])
    ref_n, _ = many(kern["plain"])
    torch.cuda.synchronize()
    frac = label_frac(got_n, ref_n)
    ok_n = (frac <= LABELS_FRAC and bool(torch.isfinite(parts_n).all())
            and bool(torch.isfinite(got_n).all()))
    if "resident" in name:
        ok_n = ok_n and tuple(parts_n.shape) == (MP2_ITERS // 5, 8)
    print(f"phase 9 {name} {tag}: phi max|d|={err:.3e} (scale "
          f"{float(ref.abs().max()):.3e}; rtol {rtol} atol {atol}); flips "
          f"|d|={flips_d:g} (bar {FLIPS_CELLS}); partial sums rel "
          f"{sums_rel:.3e} (bar {MP2_PARTS_RTOL}); second launch bitwise "
          f"equal: {repeat}; {MP2_ITERS} iterations: labels differ at "
          f"{frac:.3e} of cells (bar {LABELS_FRAC})", flush=True)
    if not (repeat and ok_phi and ok_parts and ok_n and math.isfinite(err)):
        raise AssertionError(f"{name} at {tag} disagrees with its plain "
                             f"version")
    return err


def time_mp2(name, kern, u, phis, cs, f, p):
    """(ms, plain ms, bound ms, bound by) of one launch of ``name`` at the
    inputs' shape: one iteration for K9 banded and the sweep, MP2_CHUNK
    for the resident modes."""
    h, w = u.shape
    if "resident" in name:
        def call(fn):
            return fn(phis, u, p, MP2_CHUNK)
        bnd = bound_mp2(h, w, MP2_CHUNK, MP2_CHUNK, True)
        reps = 10
    else:
        one, _ = mp2_calls(name, u, phis, cs, f, p)
        call = one
        bnd = (bound_sweep(h, w) if name == "K1 fused_sweep"
               else bound_mp2(h, w, 1, 1, False))
        reps = 20
    # the force mode's launch is about as short as its host-side cost:
    # timed queued (its wrapper no longer waits for the stream)
    timer = queued_ms if name == "K1 fused_sweep" else time_ms
    return (timer(lambda: call(kern["wrapper"]), reps),
            time_ms(lambda: call(kern["plain"]), 2), *bnd)


def check_sweep_no_sync(dev, pm):
    """K1's force mode once under torch.cuda.set_sync_debug_mode("error"),
    with and without a parity: its wrapper must not wait for the stream
    (a host-to-device copy of its means did before). Returns its queued
    ms at 4K and 512^2: {(tag, parity): ms}."""
    times = {}
    for tag, (h, w) in (("4K", (H4K, W4K)), ("512^2", (512, 512))):
        _, phis, _, f = mp2_inputs(h, w, dev, pm)
        phi = phis[0].contiguous()
        for par in (None, 1):
            fused_kernel.fused_sweep(phi, f, pm, parity=par)  # warm up
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fused_kernel.fused_sweep(phi, f, pm, parity=par)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            times[tag, par] = queued_ms(
                lambda: fused_kernel.fused_sweep(phi, f, pm, parity=par), 20)
    return times


def gac_scene(h, w):
    """(image, truth, seed) of the GAC scene at (h, w), numpy float32."""
    rng = np.random.default_rng(0)
    r = GAC_RADIUS * min(h, w)
    i, j = np.ogrid[:h, :w]
    gt = (i - h / 2) ** 2 + (j - w / 2) ** 2 < r * r
    img = np.where(gt, 220.0, 20.0) + rng.normal(0, 3.0, (h, w))
    seed = compat.disk_level_set((h, w), radius=r + GAC_MARGIN)
    return img.astype(np.float32), gt, seed.astype(np.float32)


def bound_morph(kind, h, w, k, s, balloon):
    """Least time of one morphological launch at (h, w): MORPH_BYTES per
    pixel against the operations of k iterations with s smoothing cycles
    (the balloon op only where balloon != 0) and the once-per-launch
    work."""
    if kind.startswith("acwe"):
        per_iter = OPS_ACWE_FORCE
    else:
        per_iter = OPS_GAC_ATTRACT + (OPS_GAC_BALLOON if balloon else 0)
    per_pixel = k * (per_iter + s * OPS_CYCLE) + OPS_MORPH_ONCE[kind]
    return roofline(MORPH_BYTES[kind] * h * w, h * w * per_pixel)


def morph_inputs(dev, p, h, w):
    """The phase 12 inputs at (h, w): the two-disks image, its
    checkerboard binary start, frozen force plane, means and lambdas; the
    GAC scene's edge map, aux stacks (balloon -1, 0, 1) and seed."""
    u = torch.from_numpy(two_disks(h, w)[0]).to(dev)
    ls = gacm._init_ls(u, p, None)
    l1, l2 = morphm._lambdas(u, p, None, None)
    ci, co = binary_means(u, ls)
    gimg, _, seed = gac_scene(h, w)
    g = inverse_gaussian_gradient(
        torch.from_numpy(gimg).to(dev), 5.0, 2.0).contiguous()
    # lambdas as device tensors, as the drivers pass them (a Python float
    # would cost K12's wrapper a host-to-device copy per call)
    return dict(u=u, ls=ls, f=morphm._force_plane(u, ls, l1, l2), ci=ci,
                co=co, l1=l1, l2=l2, g=g,
                seed=torch.from_numpy(seed).to(dev),
                stacks={b: morph_kernel.gac_aux_stack(g, b, GAC_THRESHOLD)
                        for b in (-1, 0, 1)})


def morph_call(kind, inp, run):
    """A function of ``plain`` that runs one launch of ``kind`` (or its
    plain version) on the phase 12 inputs ``inp`` with ``run`` = (k,
    smoothing, parity0[, balloon]); it returns (level set, partials or
    None)."""
    mk = morph_kernel
    k, s, p0 = run[:3]
    if kind == "acwe":
        return lambda plain: ((mk.morph_chunk_reference if plain
                               else mk.morph_chunk)(inp["ls"], inp["f"], k,
                                                    s, p0), None)
    if kind == "acwe_fused":
        return lambda plain: (mk.morph_chunk_fused_reference if plain
                              else mk.morph_chunk_fused)(
            inp["ls"], inp["u"], inp["ci"], inp["co"], inp["l1"], inp["l2"],
            k, s, p0)
    b = run[3]
    aux = inp["stacks"][b] if kind == "gac_pre" else inp["g"]
    start = inp["seed"] if b <= 0 else inp["ls"]
    return lambda plain: ((mk.gac_chunk_reference if plain
                           else mk.gac_chunk)(
        start, aux, k, s, p0, b, GAC_THRESHOLD, kind == "gac_pre"), None)


def check_morph(name, kind, inp, run, st):
    """One launch of ``kind`` against its plain version: the level set
    bitwise equal, K12's n_in exact and sum_in within SUM_IN_RTOL, and a
    second launch bitwise equal to the first. Updates the stats ``st``."""
    call = morph_call(kind, inp, run)
    got, gparts = call(False)
    again, aparts = call(False)
    ref, rparts = call(True)
    torch.cuda.synchronize()
    ok = torch.equal(got, ref) and torch.equal(got, again)
    st["max_abs_err"] = max(st["max_abs_err"],
                            float((got - ref).abs().max()))
    if gparts is not None:
        ok = ok and torch.equal(gparts, aparts) and bool(
            gparts[0] == rparts[0])
        rel = float((gparts[1].double() - rparts[1].double()).abs()
                    / rparts[1].double().abs())
        st["sum_in_rel"] = max(st.get("sum_in_rel", 0.0), rel)
        ok = ok and rel <= SUM_IN_RTOL
    st["checks"] = st.get("checks", 0) + 1
    if not ok:
        raise AssertionError(f"{name} {run} at {tuple(got.shape)} "
                             f"disagrees with its plain version")


def morph_counts():
    """Launches of each morphological kernel kind so far."""
    return {"K11 morph_chunk": morph_kernel.morph_chunk.launches,
            "K11 gac_chunk": morph_kernel.gac_chunk.kind_launches["gac"],
            "K11 gac_chunk pre_dg":
                morph_kernel.gac_chunk.kind_launches["gac_pre"],
            "K12 morph_chunk_fused": morph_kernel.morph_chunk_fused.launches}


def reset_morph_counts():
    morph_kernel.morph_chunk.launches = 0
    morph_kernel.gac_chunk.launches = 0
    morph_kernel.gac_chunk.kind_launches = {"gac": 0, "gac_pre": 0}
    morph_kernel.morph_chunk_fused.launches = 0


def reset_pack_counts():
    packed_kernel.pack_planes.launches = 0
    packed_kernel.unpack_planes.launches = 0


def pack_counts():
    """(K15, K16) launches since the last reset."""
    return (packed_kernel.pack_planes.launches,
            packed_kernel.unpack_planes.launches)


def check_masks(checks):
    for key, (val, bar) in checks.items():
        if not val >= bar:
            raise AssertionError(f"{key} = {val} < {bar}")


def morph_phases(dev, card):
    """Phases 12-14, the morphological family; returns the kernels'
    stats for the JSON line."""
    # phase 12: each morphological kernel kind against its plain version on
    # the main paths' inputs (the two-disks image, its checkerboard binary
    # start and frozen force plane; the GAC scene's edge map, aux stacks and
    # seed), bitwise, at 4K, 1080p and a ragged shape; timed at 4K
    p = ct.CVParams()
    mo_stats = {name: dict(max_abs_err=0.0) for name in MORPH}
    for h, w in MORPH_SHAPES:
        inp = morph_inputs(dev, p, h, w)
        for name, m in MORPH.items():
            st = mo_stats[name]
            for run in MORPH_RUNS[m["kind"]]:
                check_morph(name, m["kind"], inp, run, st)
            if (h, w) == (H4K, W4K):
                run = MORPH_RUNS[m["kind"]][0]
                call = morph_call(m["kind"], inp, run)
                st["ms"] = time_ms(lambda: call(False), 20)
                st["plain_ms"] = time_ms(lambda: call(True), 2)
                st["bound_ms"], st["bound_by"] = bound_morph(
                    m["kind"], h, w, *run[:2], run[3] if len(run) > 3 else 0)
                st["timed"] = run
    for name, st in mo_stats.items():
        extra = (f", sum_in within {st['sum_in_rel']:.3e} relative of the "
                 f"plain f64 sum (bar {SUM_IN_RTOL}), n_in exact"
                 if "sum_in_rel" in st else "")
        print(f"phase 12 {name}: {st['checks']} launches at "
              f"{len(MORPH_SHAPES)} shapes (k, s, parity0[, balloon] in "
              f"{MORPH_RUNS[MORPH[name]['kind']]}), level set bitwise equal "
              f"to the plain version in all (max |d| {st['max_abs_err']:g}),"
              f" second launch bitwise equal{extra}; 4K {st['timed']}: "
              f"{st['ms']:.4f} ms (plain {st['plain_ms']:.3f}, bound "
              f"{st['bound_ms']:.4f} {st['bound_by']}) [{card}]", flush=True)

    # phase 13: the morphological path through the user entry points. All
    # shapes are on the reference's kernel envelope, so the auto routes
    # take K11 (segment_morph: acwe; segment_gac and compat: gac_pre;
    # segment_gac_iterations(pre_dg=False): gac) and K12 (fuse_force)
    img4k, gt4k = two_disks(H4K, W4K)
    u4k = torch.from_numpy(img4k).to(dev)
    v4k = torch.from_numpy(np.stack(
        [img4k, 0.5 * img4k + 30.0, 255.0 - img4k], axis=-1)).to(dev)
    gimg4k, gtg4k, seed4k = gac_scene(H4K, W4K)
    g4k = inverse_gaussian_gradient(
        torch.from_numpy(gimg4k).to(dev), 5.0, 2.0)
    s4k = torch.from_numpy(seed4k).to(dev)
    gimg1k, gtg1k, seed1k = gac_scene(*COMPAT_SHAPE)
    g1k = compat.inverse_gaussian_gradient(gimg1k, 5.0, 2.0, device=dev)
    gkw = dict(balloon=-1, threshold=GAC_THRESHOLD)

    def morph_path():
        return dict(
            gray=ct.segment_morph(u4k, p),
            rgb=ct.segment_morph(v4k, p),
            fused=ct.segment_morph_iterations(u4k, p, iters=64,
                                              fuse_force=True),
            gac=ct.segment_gac(g4k, p, ls0=s4k, **gkw),
            gac_it=ct.segment_gac_iterations(g4k, p, iters=64, ls0=s4k,
                                             pre_dg=False, **gkw),
            compat=compat.morphological_geodesic_active_contour(
                g1k, 80, init_level_set=seed1k, device=dev, **gkw))

    # the binary start of MorphACWE/MorphGAC (init_phi(...) >= 0, whose
    # sign on the checkerboard's zero rows rests on sin's last ulp) built
    # on the card against the same start built on the CPU
    start_diff = {}
    for h, w in ((H4K, W4K), (1080, 1920)):
        like = torch.empty((h, w), device=dev)
        start_diff[f"{h}x{w}"] = int((gacm._init_ls(like, p, None).cpu()
                                      != gacm._init_ls(like.cpu(), p, None))
                                     .sum())
    print(f"phase 13 binary start built on the card vs on the CPU: cells "
          f"differing {start_diff}", flush=True)
    if any(start_diff.values()):
        raise AssertionError(f"the binary start differs between the card "
                             f"and the CPU: {start_diff}")

    reset_morph_counts()
    got = morph_path()
    torch.cuda.synchronize()
    for name, n in morph_counts().items():
        mo_stats[name]["launches"] = n
    with plain_route():
        ref = morph_path()
    torch.cuda.synchronize()
    masks = {key: (np.asarray(r) > 0 if key == "compat"
                   else r.mask.cpu().numpy()) for key, r in got.items()}
    checks = {f"{key} IoU vs truth": (iou_phases(masks[key], gt4k), 0.98)
              for key in ("gray", "rgb", "fused")}
    checks.update({f"{key} IoU vs truth": (iou(masks[key], gt), 0.95)
                   for key, gt in (("gac", gtg4k), ("gac_it", gtg4k),
                                   ("compat", gtg1k))})
    same = {key: (np.array_equal(got[key], ref[key]) if key == "compat"
                  else torch.equal(got[key].ls, ref[key].ls))
            for key in got}
    print("phase 13 morph slice: segment_morph 4K gray "
          f"{got['gray'].iters} iters (plain route {ref['gray'].iters}), "
          f"4K RGB {got['rgb'].iters} (plain {ref['rgb'].iters}), "
          f"segment_gac 4K {got['gac'].iters} (plain {ref['gac'].iters}); "
          "segment_morph_iterations(fuse_force=True) and "
          "segment_gac_iterations(pre_dg=False) 64 iterations, compat "
          "morphological_geodesic_active_contour "
          f"{COMPAT_SHAPE[0]}x{COMPAT_SHAPE[1]} 80; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in
                      checks.items())
          + "; ACWE IoU up to the swap of the phases; level set bitwise "
          f"equal to the plain route: {same}; launches "
          + ", ".join(f"{n}={st['launches']}" for n, st in mo_stats.items()),
          flush=True)
    if not all(same.values()):
        raise AssertionError(f"morph route differs from the plain route: "
                             f"{same}")
    for key in ("gray", "rgb", "gac"):
        if not got[key].iters < p.max_iter:
            raise AssertionError(f"morph {key} did not converge within "
                                 f"max_iter")
    check_masks(checks)
    for name, st in mo_stats.items():
        if st["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    # phase 14: the morph-acwe and morph-gac families' throughput at 4K
    # (bench_families.py:137-164): the lean drivers, 800 iterations, the
    # GAC edge map uniform in [0.05, 1) (seed 0), balloon 1, threshold 0.3;
    # the plain route at 40 iterations
    gbench = torch.from_numpy(np.random.default_rng(0).uniform(
        0.05, 1.0, (H4K, W4K)).astype(np.float32)).to(dev)
    bkw = dict(balloon=1, threshold=GAC_THRESHOLD)
    for tag, fn in (
            ("segment_morph_iterations 4K gray (K11 acwe, k=8)",
             lambda it: ct.segment_morph_iterations(u4k, p, iters=it)),
            ("segment_morph_iterations 4K RGB (K11 acwe, k=8)",
             lambda it: ct.segment_morph_iterations(v4k, p, iters=it)),
            ("segment_morph_iterations 4K gray fuse_force (K12, k=8)",
             lambda it: ct.segment_morph_iterations(u4k, p, iters=it,
                                                    fuse_force=True)),
            ("segment_gac_iterations 4K pre_dg=True (default; K11 gac_pre,"
             " k=4)",
             lambda it: ct.segment_gac_iterations(gbench, p, iters=it,
                                                  **bkw)),
            ("segment_gac_iterations 4K pre_dg=False (K11 gac, k=4)",
             lambda it: ct.segment_gac_iterations(gbench, p, iters=it,
                                                  pre_dg=False, **bkw))):
        kern_ms = time_ms(lambda: fn(MORPH_ITERS), 1)
        with plain_route():
            plain_ms = time_ms(lambda: fn(MORPH_PLAIN_ITERS), 1)
        print(f"phase 14 throughput: {tag}, {MORPH_ITERS} iters "
              f"{kern_ms:.3f} ms = "
              f"{H4K * W4K * MORPH_ITERS / (kern_ms * 1e3):.1f} "
              f"Mpixel-iters/s; plain route {MORPH_PLAIN_ITERS} iters "
              f"{plain_ms:.3f} ms = "
              f"{H4K * W4K * MORPH_PLAIN_ITERS / (plain_ms * 1e3):.1f} "
              f"Mpixel-iters/s [{card}]", flush=True)
    return mo_stats


def frame_stack(n, h, w, dev, noises=(8.0,)):
    """n two-disks frames (seeds 0..n-1, noise levels taken in turn from
    ``noises``) on the card, and their truths."""
    frames = [two_disks(h, w, noise=noises[s % len(noises)], seed=s)
              for s in range(n)]
    return (torch.from_numpy(np.stack([f for f, _ in frames])).to(dev),
            [g for _, g in frames])


def chunk_inputs(u, p):
    """(phi, u0, c1, c2): the checkerboard start and its means on image u."""
    phi = init_phi(tuple(u.shape), p.init, torch.float32, device=u.device)
    return (phi, u, *region_means(u, phi, p.eps))


def hold(name, got, ref, tag):
    """A kernel's (phi, partials) against another version's at phase 3's
    bars; returns max |d phi|."""
    (gphi, gparts), (rphi, rparts) = got, ref
    err = float((gphi - rphi).abs().max())
    sure = rphi.abs() > PHI_ATOL
    ok = (torch.allclose(gphi, rphi, rtol=PHI_RTOL, atol=PHI_ATOL)
          and bool(((gphi >= 0) == (rphi >= 0))[sure].all())
          and gparts.shape == rparts.shape
          and torch.allclose(gparts, rparts, rtol=PARTS_RTOL,
                             atol=PARTS_ATOL) and math.isfinite(err))
    if not ok:
        raise AssertionError(f"{name} at {tag} disagrees: phi max|d| {err}, "
                             f"parts {gparts.tolist()} vs {rparts.tolist()}")
    return err


def check_stack_kernels(dev, p, img4k, rgb4k_cf):
    """Phase 15: K1 batch, K13 (both layouts) and K15/K16 against their
    plain versions; a second launch of each bitwise equal to the first;
    K13 on the tile body timed queued. Returns the stats dict of the five
    entries."""
    st = {name: dict(max_abs_err=0.0) for name in STACK}
    # K1 batch: each frame also bitwise the single-image K1 launch
    for n, h, w in K1B_STACKS:
        u, _ = frame_stack(n, h, w, dev)
        phi, _, _, _ = chunk_inputs(u[0], p)
        phis = phi.expand(n, h, w).contiguous()
        means = [region_means(f, phi, p.eps) for f in u]
        c1 = torch.stack([m[0] for m in means])
        c2 = torch.stack([m[1] for m in means])
        op = fused_kernel.fused_iteration_batch
        got, again = op(phis, u, c1, c2, p), op(phis, u, c1, c2, p)
        ref = fused_kernel.fused_iteration_batch_reference(phis, u, c1, c2, p)
        single = [fused_kernel.fused_iteration(phis[i], u[i], c1[i], c2[i], p)
                  for i in range(n)]
        torch.cuda.synchronize()
        repeat = torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                               again[1])
        alone = all(torch.equal(got[0][i], o[0]) and torch.equal(got[1][i],
                                                                 o[1])
                    for i, o in enumerate(single))
        if not (repeat and alone):
            raise AssertionError(f"K1 batch at {n}x{h}x{w}: second launch "
                                 f"equal {repeat}, frames equal to single "
                                 f"launches {alone}")
        err = hold("K1 fused_iteration_batch", got, ref, f"{n}x{h}x{w}")
        b = st["K1 fused_iteration_batch"]
        b["max_abs_err"] = max(b["max_abs_err"], err)
        print(f"phase 15 K1 fused_iteration_batch {n}x{h}x{w}: phi max|d|="
              f"{err:.3e} parts max|d|="
              f"{float((got[1] - ref[1]).abs().max()):.3e} (phi rtol "
              f"{PHI_RTOL} atol {PHI_ATOL}, parts rtol {PARTS_RTOL} atol "
              f"{PARTS_ATOL}); every frame bitwise equal to its own "
              f"fused_iteration launch; second launch bitwise equal",
              flush=True)
        if n == VIDEO_FRAMES:
            b["ms"] = time_ms(lambda: op(phis, u, c1, c2, p), 20)
            b["plain_ms"] = time_ms(
                lambda: fused_kernel.fused_iteration_batch_reference(
                    phis, u, c1, c2, p), 2)
            b["bound_ms"], b["bound_by"] = bound(h, w, 1, 0, frames=n)
            b["timed"] = f"{n}x{h}x{w}"
    # K13: against its plain version and K2 on the card
    for h, w in K13_SHAPES:
        args = chunk_inputs(torch.from_numpy(two_disks(h, w)[0]).to(dev), p)
        for k in K13_KS:
            band = banded_kernel.banded_chunk(*args, p, k)
            ref = packed_kernel.packed_chunk_reference(*args, p, k)
            for name in ("K13 packed_chunk (flat)",
                         "K13 packed_chunk (packed)"):
                packed = STACK[name]["packed"]
                got = packed_kernel.packed_chunk(*args, p, k, packed=packed)
                again = packed_kernel.packed_chunk(*args, p, k,
                                                   packed=packed)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], again[0])
                        and torch.equal(got[1], again[1])):
                    raise AssertionError(f"{name} k={k} at {h}x{w}: two "
                                         f"launches differ")
                err = hold(name, got, ref, f"{h}x{w} k={k}")
                err_band = hold(name, got, band, f"{h}x{w} k={k} vs K2")
                st[name]["max_abs_err"] = max(st[name]["max_abs_err"], err)
                print(f"phase 15 {name} {h}x{w} k={k}: phi "
                      f"max|d| vs plain {err:.3e}, vs K2 banded_chunk "
                      f"{err_band:.3e}; parts max|d| vs plain "
                      f"{float((got[1] - ref[1]).abs().max()):.3e} (phase "
                      f"3's bars); second launch bitwise equal", flush=True)
                if k == K13_KS[-1]:
                    # queued: with the pack inside, four launches whose
                    # host-side cost is about their device time
                    t = [queued_ms(lambda: packed_kernel.packed_chunk(
                        *args, p, k, packed=packed), 20) for _ in range(2)]
                    st[name].setdefault("turns", {})[h, w] = (
                        *t, bound(h, w, k, 0)[0])
                if (h, w) == K13_TIMED and k == K13_KS[-1]:
                    st[name]["ms"] = sum(t) / 2
                    st[name]["plain_ms"] = time_ms(
                        lambda: packed_kernel.packed_chunk_reference(
                            *args, p, k), 2)
                    st[name]["bound_ms"], st[name]["bound_by"] = bound(
                        h, w, k, 0)
    print(f"phase 15 K13 k={K13_KS[-1]} (queued device ms a call, two "
          f"runs; bound): "
          + "; ".join(
              f"{n} {h}x{w} " + ", ".join(f"{v:.4f}" for v in t)
              for n in STACK if "K13" in n
              for (h, w), t in st[n]["turns"].items())
          + "; tiles (TH, TW, GX, GY, u0 resident, bytes) " + ", ".join(
              f"{h}x{w} {_cuda.resident_tile_geometry(h, w)}"
              for h, w in K13_SHAPES), flush=True)
    # K15/K16 bitwise, on the main paths' images
    inputs = {(H4K, W4K): img4k, (RGB, H4K, W4K): rgb4k_cf}
    for shape in PACK_SHAPES:
        x = inputs.get(shape)
        if x is None:
            x = torch.from_numpy(np.random.default_rng(5).uniform(
                0, 255, shape).astype(np.float32)).to(dev)
        planes, planes2 = (packed_kernel.pack_planes(x),
                           packed_kernel.pack_planes(x))
        back, back2 = (packed_kernel.unpack_planes(planes),
                       packed_kernel.unpack_planes(planes))
        torch.cuda.synchronize()
        ok = (torch.equal(planes, packed_kernel.pack_planes_reference(x))
              and torch.equal(planes, planes2) and torch.equal(back, x)
              and torch.equal(back, back2)
              and torch.equal(back, packed_kernel.unpack_planes_reference(
                  planes)))
        print(f"phase 15 K15/K16 {'x'.join(map(str, shape))}: planes and "
              f"round trip bitwise equal to the plain versions and the "
              f"input: {ok}; second launches bitwise equal", flush=True)
        if not ok:
            raise AssertionError(f"K15/K16 at {shape} differ from the "
                                 f"plain versions")
    return st


def stack_phases(dev, card, img4k, rgb4k_cf):
    """Phases 15-17, frame stacks and the layout kernels; returns the five
    kernels' stats for the JSON line."""
    p = ct.CVParams()
    st = check_stack_kernels(dev, p, img4k, rgb4k_cf)

    # phase 16: the slice through the user entry points on a data mesh of
    # the card. 64 x 512^2 is inside the resident envelope: K8 batch, which
    # packs through K15/K16; 1080p frames are off it: K1 batch, one launch
    # an iteration. mu as phase 4 (the k=8 trap does not apply, but the
    # smoke's other mask checks use it). segment_fused on frame 0 sets the
    # video's iterations so that the run has converged.
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    mesh = make_data_mesh()
    s512, gt512 = frame_stack(STACK_FRAMES, 512, 512, dev)
    video, gtv = frame_stack(VIDEO_FRAMES, 1080, 1920, dev)
    small, gts = frame_stack(*TOL_STACK, dev, TOL_NOISES)
    video_iters = max(MAIN_FIXED_ITERS, ct.segment_fused(video[0], pt).iters)
    chunk = chunk_inputs(torch.from_numpy(two_disks(*K13_TIMED)[0]).to(dev),
                         p)

    def stack_path():
        out = dict(
            s512=segment_stack_sharded(s512, pt, mesh,
                                       iters=MAIN_FIXED_ITERS)[1],
            video=segment_stack_sharded(video, pt, mesh,
                                        iters=video_iters)[1])
        for name in ("K13 packed_chunk (flat)", "K13 packed_chunk (packed)"):
            out[name] = packed_kernel.packed_chunk(
                *chunk, p, 8, packed=STACK[name]["packed"])
        return out

    batch_op = fused_kernel.fused_iteration_batch
    batch_op.launches = 0
    packed_kernel.packed_chunk.launches = {"flat": 0, "packed": 0}
    packed_kernel.packed_resident_iterations_batch.launches = 0
    reset_pack_counts()
    got = stack_path()
    # tolerance mode launches no kernel (the reference runs the plain
    # segment under vmap): it is held against the same stack on the CPU
    got["tol"] = segment_stack_sharded(small, pt, mesh)
    torch.cuda.synchronize()
    st["K1 fused_iteration_batch"]["launches"] = batch_op.launches
    for name in ("K13 packed_chunk (flat)", "K13 packed_chunk (packed)"):
        st[name]["launches"] = packed_kernel.packed_chunk.launches[
            "packed" if STACK[name]["packed"] else "flat"]
    (st["K15 pack_planes"]["launches"],
     st["K16 unpack_planes"]["launches"]) = pack_counts()
    k8_batch = packed_kernel.packed_resident_iterations_batch.launches
    with plain_route():
        ref = stack_path()
    torch.cuda.synchronize()
    tol_cpu = segment_stack_sharded(small.cpu(), pt, make_data_mesh(
        devices=[torch.device("cpu")]))
    checks = {}
    for key, gt in (("s512", gt512), ("video", gtv)):
        checks[f"{key} min frame IoU vs truth"] = (
            min(iou_phases(m, g) for m, g in zip(got[key].cpu(), gt)), 0.99)
        checks[f"{key} IoU vs plain route"] = (
            iou(got[key].cpu(), ref[key].cpu()), 0.999)
    checks["tol min frame IoU vs truth"] = (
        min(iou_phases(m, g) for m, g in zip(got["tol"].mask.cpu(), gts)),
        0.99)
    checks["tol min frame IoU vs the CPU"] = (
        min(iou(m, c) for m, c in zip(got["tol"].mask.cpu(), tol_cpu.mask)),
        0.999)
    for name in ("K13 packed_chunk (flat)", "K13 packed_chunk (packed)"):
        hold(name, got[name], ref[name], "phase 16 1024^2 k=8")
    card_iters, cpu_iters = got["tol"].iters.tolist(), tol_cpu.iters.tolist()
    print(f"phase 16 stack slice on a data mesh of {mesh.shape}: "
          f"segment_stack_sharded {STACK_FRAMES}x512^2 {MAIN_FIXED_ITERS} "
          f"iterations (K8 batch launches {k8_batch}), {VIDEO_FRAMES}x1080p "
          f"{video_iters} iterations (segment_fused on frame 0 stopped "
          f"there or earlier), tolerance mode {'x'.join(map(str, TOL_STACK))}"
          f" noise {TOL_NOISES} iters on the card {card_iters} (CPU "
          f"{cpu_iters}); packed_chunk 1024^2 k=8 both "
          f"layouts within phase 3's bars of the plain route; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in checks.items())
          + "; launches " + ", ".join(f"{n}={v['launches']}"
                                     for n, v in st.items()), flush=True)
    check_masks(checks)
    if card_iters != cpu_iters or len(set(card_iters)) < 2:
        raise AssertionError(f"tolerance-mode iteration counts on the card "
                             f"{card_iters}, on the CPU {cpu_iters}: they "
                             f"must agree and differ between frames")
    if k8_batch < 1:
        raise AssertionError("the 512^2 stack did not run K8 batch")
    if batch_op.launches != video_iters * mesh.shape["data"]:
        raise AssertionError(f"K1 batch launched {batch_op.launches} times "
                             f"for {video_iters} iterations")
    for name, v in st.items():
        if v["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    # phase 17: times. The batched-stack configuration (bench_families.py
    # :121-135: 64 x 512^2 uniform in [0, 255), seed 0, default params) at
    # steady state; K1 batch beside the per-frame loop it replaced; the
    # layout A/B at 1024^2; K15/K16 beside the permute-copy
    bstack = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (STACK_FRAMES, 512, 512)).astype(np.float32)).to(dev)
    ms = time_ms(lambda: segment_stack_sharded(
        bstack, p, mesh, iters=THROUGHPUT_ITERS), 1)
    print(f"phase 17 batched-stack {STACK_FRAMES}x512^2 on the data mesh, "
          f"{THROUGHPUT_ITERS} iterations (K8 batch): {ms:.3f} ms = "
          f"{bstack.numel() * THROUGHPUT_ITERS / (ms * 1e3):.1f} "
          f"Mpixel-iters/s [{card}]", flush=True)

    def per_frame_loop():  # the per-frame driver K1 batch replaced
        return torch.stack([
            ct.segment_fused_fixed(u, p, MAIN_FIXED_ITERS, phi)[0]
            for u, phi in zip(video, batchedm._stack_phi0(video, p, None))])
    n_pix = video.numel() * MAIN_FIXED_ITERS
    batch_ms = time_ms(lambda: batchedm.segment_stack_fused_fixed(
        video, p, MAIN_FIXED_ITERS), 2)
    loop_ms = time_ms(per_frame_loop, 1)
    print(f"phase 17 {VIDEO_FRAMES}x1080p, {MAIN_FIXED_ITERS} iterations: "
          f"segment_stack_fused_fixed (K1 batch) {batch_ms:.3f} ms = "
          f"{n_pix / (batch_ms * 1e3):.1f} Mpixel-iters/s; per-frame "
          f"segment_fused_fixed loop {loop_ms:.3f} ms = "
          f"{n_pix / (loop_ms * 1e3):.1f} [{card}]", flush=True)

    phi, u, c1, c2 = chunk
    h, w = K13_TIMED
    phi_pl, u_pl = packed_kernel.pack_planes(phi), packed_kernel.pack_planes(u)
    runs = {
        "K13 flat": lambda: packed_kernel.packed_chunk(phi, u, c1, c2, p, 8,
                                                       packed=False),
        "K13 packed (pack inside)": lambda: packed_kernel.packed_chunk(
            phi, u, c1, c2, p, 8),
        "K13 packed (planes)": lambda: _cuda.launch_resident_chunk(
            "cv_packed_resident_chunk", phi_pl, u_pl, c1, c2, p, 8, h, w),
        "K2 k=8": lambda: banded_kernel.banded_chunk(phi, u, c1, c2, p, 8),
        "K3 k=8 (planes)": lambda: packed_kernel.packed_banded_chunk(
            phi_pl, u_pl, c1, c2, p, 8),
        "K7 16 it": lambda: resident_kernel.resident_iterations(phi, u, p,
                                                                16),
        "K8 16 it (pack inside)":
            lambda: packed_kernel.packed_resident_iterations(phi, u, p, 16),
    }
    order = list(runs) + list(runs)[::-1]  # in turns, then back
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(queued_ms(runs[name], 20))
    print(f"phase 17 layout A/B at {h}x{w} (queued device ms a launch, "
          f"forward and backward pass): "
          + ", ".join(f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in times.items())
          + f" [{card}]", flush=True)

    x = img4k
    planes = packed_kernel.pack_planes(x)
    hh, ww = x.shape
    lib = {"K15 pack_planes": lambda: x.reshape(hh // 2, 2, ww // 2, 2)
           .permute(1, 3, 0, 2).contiguous(),
           "K16 unpack_planes": lambda: planes.permute(2, 0, 3, 1)
           .reshape(hh, ww)}
    calls = {"K15 pack_planes": (lambda: packed_kernel.pack_planes(x),
                                 lambda: packed_kernel.pack_planes_reference(
                                     x)),
             "K16 unpack_planes": (
                 lambda: packed_kernel.unpack_planes(planes),
                 lambda: packed_kernel.unpack_planes_reference(planes))}
    # a 4K pack is about as short as its host-side cost: queued device
    # times, and the kernel's time at the host's pace beside them
    paced = {}
    for name, (kern, plain) in calls.items():
        st[name]["ms"] = queued_ms(kern, 50)
        st[name]["plain_ms"] = queued_ms(plain, 50)
        st[name]["library_ms"] = queued_ms(lib[name], 50)
        st[name]["bound_ms"], st[name]["bound_by"] = roofline(8 * hh * ww, 0)
        paced[name] = time_ms(kern, 50)
    print("phase 17 parity pack at 4K (2160x3840 f32), queued device time: "
          + ", ".join(
              f"{n} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, "
              f"permute-copy {v['library_ms']:.4f}, bound "
              f"{v['bound_ms']:.4f} bytes; at the host's pace "
              f"{paced[n]:.4f})"
              for n, v in st.items() if n in paced)
          + f"; K1 batch {st['K1 fused_iteration_batch']['timed']} "
          f"{st['K1 fused_iteration_batch']['ms']:.4f} ms an iteration "
          f"(bound {st['K1 fused_iteration_batch']['bound_ms']:.4f}) "
          f"[{card}]", flush=True)
    return st


def shard_counts():
    return {name: getattr(*v["counter"]) for name, v in SHARD.items()}


def reset_shard_counts():
    for v in SHARD.values():
        setattr(*v["counter"], 0)


def shard_call(name, p, k, plain=False):
    """fn(canvas, image canvas, c1, c2, parity, edges, crop) -> (canvas,
    partials) of a shard mode (or its plain version), flat canvases in
    and out (K3 packs and unpacks around its planes)."""
    if name.startswith("K1"):
        f = (fused_kernel.fused_iteration_reference if plain
             else fused_kernel.fused_iteration)
        return lambda x, u, a, b, par, e, cr: f(x, u, a, b, p, par, cr, e)
    if name.startswith("K3"):
        f = (packed_kernel.packed_banded_chunk_sharded_reference if plain
             else packed_kernel.packed_banded_chunk_sharded)

        def run(x, u, a, b, par, e, cr):
            out, parts = f(packed_kernel.pack_planes(x),
                           packed_kernel.pack_planes(u), a, b, p, k, e, cr)
            return packed_kernel.unpack_planes(out), parts
        return run
    if name.startswith("K2"):
        f = (banded_kernel.banded_chunk_sharded_reference if plain
             else banded_kernel.banded_chunk_sharded)
    else:
        f = (banded_kernel.banded_chunk_mc_sharded_reference if plain
             else banded_kernel.banded_chunk_mc_sharded)
    return lambda x, u, a, b, par, e, cr: f(x, u, a, b, p, k, par, e, cr)


def whole_call(name, phi, u, c1, c2, p, k):
    """The whole-image launch of the mode's kernel (K1, K2, K3, K5)."""
    if name.startswith("K1"):
        return fused_kernel.fused_iteration(phi, u, c1, c2, p)
    if name.startswith("K2"):
        return banded_kernel.banded_chunk(phi, u, c1, c2, p, k)
    if name.startswith("K3"):
        out, parts = packed_kernel.packed_banded_chunk(
            packed_kernel.pack_planes(phi), packed_kernel.pack_planes(u), c1,
            c2, p, k)
        return packed_kernel.unpack_planes(out), parts
    return banded_kernel.banded_chunk_mc(phi, u, c1, c2, p, k)


def shard_canvases(phi, u, nx, ny, D, dev):
    """Each shard's (position, phi canvas, image canvas, parity, edges,
    crop) of an nx x ny grid on ``dev``, built by the port's halo
    exchange: (h + 2D, w + 2D), the image channels-first."""
    mesh = make_grid_mesh(nx, ny, [dev] * (nx * ny))
    sharding = grid_sharding(mesh)
    phis = exchange_halo2d(shard_grid(phi, sharding), D)
    cf = u.ndim == 3
    ublocks = shard_grid(u.permute(1, 2, 0) if cf else u, sharding)
    if cf:
        ublocks = [[b.permute(2, 0, 1).contiguous() for b in row]
                   for row in ublocks]
    us = exchange_halo2d_batched(ublocks, D)
    h, w = phi.shape[0] // nx, phi.shape[1] // ny
    return [((ix, iy), phis[ix][iy], us[ix][iy], (ix * h + iy * w) % 2,
             (ix == 0, ix == nx - 1, iy == 0, iy == ny - 1),
             (D, D + h, D, D + w))
            for ix in range(nx) for iy in range(ny)]


def check_shard_kernels(dev, p, u4k, v4k):
    """Phase 18: each shard mode against its plain version on every shard
    of a 2x2 and a 3x3 grid of the 4K images (the checkerboard start and
    its means), a second launch bitwise the first, and each shard's crop
    against the matching window of the whole-image launch of the same
    kernel from the same means (bitwise expected: the arithmetic per cell
    is the same code). Returns the stats of the four entries."""
    st = {name: dict(max_abs_err=0.0) for name in SHARD}
    phi = init_phi((H4K, W4K), p.init, torch.float32, device=dev)
    inputs = {0: (u4k, *region_means(u4k, phi, p.eps)),
              RGB: (v4k.permute(2, 0, 1).contiguous(),
                    *region_means(v4k, phi, p.eps))}
    for name, kern in SHARD.items():
        u, c1, c2 = inputs[kern["channels"]]
        for k in kern["ks"]:
            D = 4 * k
            call, plain = shard_call(name, p, k), shard_call(name, p, k, True)
            whole, wparts = whole_call(name, phi, u, c1, c2, p, k)
            for nx, ny in SHARD_GRIDS:
                h, w = H4K // nx, W4K // ny
                errs, bitwise, psum = [], True, 0.0
                for pos, x, uc, par, edges, crop in shard_canvases(
                        phi, u, nx, ny, D, dev):
                    args = (x, uc, c1, c2, par, edges, crop)
                    got, again, ref = call(*args), call(*args), plain(*args)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], again[0])
                            and torch.equal(got[1], again[1])):
                        raise AssertionError(f"{name} k={k} shard {pos} of "
                                             f"{nx}x{ny}: two launches "
                                             f"differ")
                    tag = f"k={k} shard {pos} of {nx}x{ny} edges {edges}"
                    errs.append(hold(name, got, ref, tag))
                    ix, iy = pos
                    mine = got[0][D:D + h, D:D + w]
                    win = whole[ix * h:(ix + 1) * h, iy * w:(iy + 1) * w]
                    if not torch.equal(mine, win):
                        bitwise = False
                        hold(name, (mine, got[1]), (win, got[1]),
                             f"{tag} vs the whole-image launch")
                    psum = psum + got[1].double()
                st[name]["max_abs_err"] = max(st[name]["max_abs_err"],
                                              *errs)
                n = kern["channels"] + 4 if kern["channels"] else 5
                hold(name, (whole, psum[:n].float()), (whole, wparts[:n]),
                     f"k={k} {nx}x{ny}: the shards' partials summed vs the "
                     f"whole image's")
                crops = ("bitwise equal to" if bitwise
                         else "within the bars of")
                print(f"phase 18 {name} k={k} {nx}x{ny} ({h}x{w} shards, "
                      f"D={D}): phi max|d| vs plain {max(errs):.3e} (phase "
                      f"3's bars), crops {crops} the whole-image launch, "
                      f"the shards' partials summed "
                      f"within the bars of the whole image's; second "
                      f"launches bitwise equal", flush=True)
    return st


def shard_phases(dev, card, u4k, gt4k, v4k, gtc4k):
    """Phases 18-20, the sharded two-phase PDE at 4K on a 2x2 grid of four
    shards on the card (and the 1x1 mesh); returns the four shard modes'
    stats for the JSON line."""
    p = ct.CVParams()
    st = check_shard_kernels(dev, p, u4k, v4k)

    # phase 19: the slice through segment_sharded. mu as phase 4's gray
    # and RGB checks
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    pv = ct.CVParams(mu=0.0001 * 255.0 ** 2, max_iter=500)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    mesh1 = make_grid_mesh(1, 1, [dev])
    nsh = 4
    chunks = SHARD_ITERS // SHARD_K
    tol_ref = ct.segment_banded(u4k, pt, k=SHARD_K)
    runs = {  # run, image, unsharded run of the same class, its launches
        "gray k=8": (lambda: segment_sharded(
            u4k, pt, mesh, fixed=True, max_iter=SHARD_ITERS, comm_k=SHARD_K),
            "gray", lambda: ct.segment_banded_fixed(
                u4k, pt, SHARD_ITERS, k=SHARD_K)[1],
            {"K2 banded_chunk_sharded": nsh * chunks}),
        # the reference's packed predicate needs the canvas height (h + 8k)
        # to be a multiple of 16: 2160 + 64 is, 1080 + 64 is not, so the
        # packed route runs on the 1x1 mesh
        "1x1 gray k=8 packed": (lambda: segment_sharded(
            u4k, pt, mesh1, fixed=True, max_iter=SHARD_ITERS, comm_k=SHARD_K,
            packed=True), "gray", None,
            {"K3 packed_banded_chunk_sharded": chunks}),
        "gray k=1": (lambda: segment_sharded(
            u4k, pt, mesh, fixed=True, max_iter=SHARD_ITERS_K1), "gray",
            lambda: ct.segment_fused_fixed(u4k, pt, SHARD_ITERS_K1)[1],
            {"K1 fused_iteration (shard)": nsh * SHARD_ITERS_K1}),
        "rgb k=8": (lambda: segment_sharded(
            v4k, pv, mesh, fixed=True, max_iter=SHARD_ITERS, comm_k=SHARD_K),
            "rgb", lambda: ct.segment_banded_fixed(
                v4k, pv, SHARD_ITERS, k=SHARD_K)[1],
            {"K5 banded_chunk_mc_sharded": nsh * chunks}),
        "rgb k=1": (lambda: segment_sharded(
            v4k, pv, mesh, fixed=True, max_iter=SHARD_ITERS_K1), "rgb",
            lambda: ct.segment_fused_fixed(v4k, pv, SHARD_ITERS_K1)[1],
            {"K5 banded_chunk_mc_sharded": nsh * SHARD_ITERS_K1}),
        "gray tolerance k=8": (lambda: segment_sharded(
            u4k, pt, mesh, comm_k=SHARD_K), "gray",
            lambda: tol_ref.mask, None),
        "1x1 gray k=8": (lambda: segment_sharded(
            u4k, pt, mesh1, fixed=True, max_iter=SHARD_ITERS,
            comm_k=SHARD_K), "gray", None,
            {"K2 banded_chunk_sharded": chunks}),
    }
    truth = {"gray": gt4k, "rgb": gtc4k}
    reset_shard_counts()
    reset_pack_counts()
    got, launches = {}, {}
    for tag, (run_fn, _, _, _) in runs.items():
        before = shard_counts()
        got[tag] = run_fn()
        torch.cuda.synchronize()
        launches[tag] = {n: v - before[n] for n, v in shard_counts().items()}
    # the trace at the default parameters of the parity artifact
    # (BASELINE.json:5, configuration 1's default mu/nu/dt): at phase 4's
    # mu the f32 trajectory from the checkerboard drifts 1e-4 to 1e-3 in
    # energy from f64 within 20 iterations, sharded or not (CPU runs of
    # the plain route at 544x960)
    before = shard_counts()
    trace = segment_sharded_fixed_trace(u4k, p, mesh, iters=TRACE_ITERS)
    torch.cuda.synchronize()
    launches["trace"] = {n: v - before[n] for n, v in shard_counts().items()}
    for name in SHARD:
        st[name]["launches"] = shard_counts()[name]
    packs = pack_counts()

    tol_iters = got["gray tolerance k=8"].iters
    tol_chunks = -(-tol_iters // SHARD_K)
    runs["gray tolerance k=8"] = runs["gray tolerance k=8"][:3] + (
        {"K2 banded_chunk_sharded": nsh * tol_chunks},)
    launches_want = {tag: r[3] for tag, r in runs.items()}
    launches_want["trace"] = {"K1 fused_iteration (shard)":
                              nsh * TRACE_ITERS}
    checks, unsharded = {}, {}
    for tag, (_, img, ref_fn, _) in runs.items():
        mask = got[tag].mask.cpu()
        checks[f"{tag} IoU vs truth"] = (iou_phases(mask, truth[img]), 0.99)
        if ref_fn is not None:
            unsharded[tag] = ref_fn()
            checks[f"{tag} IoU vs unsharded"] = (
                iou(mask, unsharded[tag].cpu()), 0.999)
    checks["1x1 gray k=8 IoU vs 2x2"] = (
        iou(got["1x1 gray k=8"].mask.cpu(), got["gray k=8"].mask.cpu()),
        0.999)
    plain_trace = ct.segment_fixed(u4k, p, iters=TRACE_ITERS)
    e_rel = float(((trace.energy.double() - plain_trace.energy.double()).abs()
                   / plain_trace.energy.double().abs()).max())
    packed_equal = torch.equal(got["1x1 gray k=8 packed"].mask,
                               got["1x1 gray k=8"].mask)
    print(f"phase 19 sharded slice at 4K on a 2x2 grid of shards on "
          f"{dev} (and the 1x1 mesh): segment_sharded fixed {SHARD_ITERS} "
          f"iterations comm_k={SHARD_K} gray (flat and packed) and RGB, "
          f"{SHARD_ITERS_K1} comm_k=1 gray and RGB, tolerance comm_k="
          f"{SHARD_K} {tol_iters} iterations (unsharded segment_banded "
          f"{tol_ref.iters}); "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in checks.items())
          + f"; packed mask equal to flat {packed_equal}; trace "
          f"{TRACE_ITERS} iterations energy max rel diff vs unsharded "
          f"segment_fixed {e_rel:.3e} (<= {TRACE_RTOL}); launches "
          + "; ".join(f"{t}: " + ", ".join(f"{n.split()[0]}={v}"
                                          for n, v in c.items() if v)
                      for t, c in launches.items())
          + f"; K15={packs[0]}, K16={packs[1]}", flush=True)
    check_masks(checks)
    if not packed_equal:
        raise AssertionError("the packed and flat shard routes' masks "
                             "differ")
    if not e_rel <= TRACE_RTOL:
        raise AssertionError(f"sharded trace energy {e_rel} from the "
                             f"unsharded one")
    for tag, want in launches_want.items():
        have = {n: v for n, v in launches[tag].items() if v}
        if have != want:
            raise AssertionError(f"{tag} launched {have}, expected {want}")
    if packs != (2, 1):  # the phi and image canvases, then phi back
        raise AssertionError(f"the packed run packed/unpacked {packs} "
                             f"times, expected (2, 1)")
    if not tol_iters < pt.max_iter:
        raise AssertionError("the sharded tolerance run did not converge")

    # phase 20: times. Each fixed run beside the unsharded banded driver
    # at 4K, k = 8; each shard mode at the 2x2 canvas of shard (0, 0)
    rates = {}
    base_ms = time_ms(lambda: ct.segment_banded_fixed(u4k, pt, SHARD_ITERS,
                                                      k=SHARD_K), 1)
    rates["unsharded segment_banded_fixed k=8"] = (SHARD_ITERS, base_ms)
    for tag, (run_fn, _, _, want) in runs.items():
        if tag.startswith("gray tolerance"):
            continue
        iters = SHARD_ITERS_K1 if tag.endswith("k=1") else SHARD_ITERS
        rates[tag] = (iters, time_ms(run_fn, 1))
    rates["trace"] = (TRACE_ITERS, time_ms(
        lambda: segment_sharded_fixed_trace(u4k, p, mesh,
                                            iters=TRACE_ITERS), 1))
    print("phase 20 sharded throughput at 4K (Mpixel-iters/s, the whole "
          "run): " + "; ".join(
              f"{t} {it} iterations {ms:.3f} ms = "
              f"{H4K * W4K * it / (ms * 1e3):.1f}"
              for t, (it, ms) in rates.items()) + f" [{card}]", flush=True)

    phi = init_phi((H4K, W4K), p.init, torch.float32, device=dev)
    inputs = {0: (u4k, *region_means(u4k, phi, p.eps)),
              RGB: (v4k.permute(2, 0, 1).contiguous(),
                    *region_means(v4k, phi, p.eps))}
    h, w = H4K // 2, W4K // 2
    per_mode = []
    for name, kern in SHARD.items():
        u, c1, c2 = inputs[kern["channels"]]
        for k in kern["ks"]:
            D = 4 * k
            (_, x, uc, par, edges, crop), = [
                c for c in shard_canvases(phi, u, 2, 2, D, dev)
                if c[0] == (0, 0)]
            if name.startswith("K3"):  # time the launch on its planes
                xp, up = packed_kernel.pack_planes(x), \
                    packed_kernel.pack_planes(uc)
                fn = (lambda xp=xp, up=up, c1=c1, c2=c2, k=k, e=edges,
                      cr=crop: packed_kernel.packed_banded_chunk_sharded(
                          xp, up, c1, c2, p, k, e, cr))
                pl = (lambda xp=xp, up=up, c1=c1, c2=c2, k=k, e=edges,
                      cr=crop: packed_kernel.
                      packed_banded_chunk_sharded_reference(
                          xp, up, c1, c2, p, k, e, cr))
            else:
                args = (x, uc, c1, c2, par, edges, crop)
                fn = (lambda f=shard_call(name, p, k), a=args: f(*a))
                pl = (lambda f=shard_call(name, p, k, True), a=args: f(*a))
            ms = queued_ms(fn, 20)
            plain_ms = time_ms(pl, 2)
            b_ms, b_by = bound(h, w, k, kern["channels"])
            per_mode.append(f"{name} k={k} {ms:.4f} ms (plain "
                            f"{plain_ms:.3f}, bound {b_ms:.4f} {b_by})")
            if k == kern["ks"][0]:
                st[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None)
    # K3's main-path launches run on the 1x1 mesh's canvas (phase 19's
    # packed route): timed there too
    (_, x, uc, par, edges, crop), = shard_canvases(phi, u4k, 1, 1,
                                                   4 * SHARD_K, dev)
    xp, up = packed_kernel.pack_planes(x), packed_kernel.pack_planes(uc)
    c1, c2 = inputs[0][1:]
    ms = queued_ms(lambda: packed_kernel.packed_banded_chunk_sharded(
        xp, up, c1, c2, p, SHARD_K, edges, crop), 20)
    per_mode.append(f"K3 packed_banded_chunk_sharded k={SHARD_K} at the 1x1 "
                    f"canvas {ms:.4f} ms (bound "
                    f"{bound(H4K, W4K, SHARD_K, 0)[0]:.4f})")
    # the canvases' cost a chunk: the exchange of the four shards' phi, its
    # host time (enqueueing) and its device time (queued behind a spin: at
    # the host's pace time_ms would read the host time)
    blocks = shard_grid(phi, grid_sharding(mesh))
    canv = {}
    for D in (4, 4 * SHARD_K):
        exchange_halo2d(blocks, D)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            exchange_halo2d(blocks, D)
        host = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        canv[D] = (host, queued_ms(lambda: exchange_halo2d(blocks, D), 20))
    print("phase 20 shard modes at the 2x2 canvas of shard (0, 0) (queued "
          "device ms a launch): " + "; ".join(per_mode)
          + "; building the four shards' canvases (halo exchange): "
          + ", ".join(f"D={D} host {hst:.3f} ms, device {dv:.4f} ms a "
                      f"chunk" for D, (hst, dv) in canv.items())
          + f" [{card}]", flush=True)
    return st


def mp_shard_counts():
    return {name: getattr(*v["counter"]) for name, v in MP_SHARD.items()}


def reset_mp_shard_counts():
    for v in MP_SHARD.values():
        setattr(*v["counter"], 0)


def mp_canvases(phis, u, nx, ny, D, dev):
    """Each shard's (position, level-set canvas (2, h + 2D, w + 2D), image
    canvas, parity, edges, crop) of an nx x ny grid on ``dev``, built by
    the port's halo exchange (the driver's canvases)."""
    mesh = make_grid_mesh(nx, ny, [dev] * (nx * ny))
    pads = exchange_halo2d_batched(_shard_phis(phis, mesh), D)
    us = exchange_halo2d(shard_grid(u, grid_sharding(mesh)), D)
    h, w = u.shape[0] // nx, u.shape[1] // ny
    return [((ix, iy), pads[ix][iy], us[ix][iy], (ix * h + iy * w) % 2,
             (ix == 0, ix == nx - 1, iy == 0, iy == ny - 1),
             (D, D + h, D, D + w))
            for ix in range(nx) for iy in range(ny)]


def mp2_parts_ok(gparts, rparts, nshards=1):
    """K9 partials against another version's: the summed slots within
    MP2_PARTS_RTOL, the flips within FLIPS_CELLS a shard, the rest 0.
    Returns (ok, flips |d|, sums relative |d|)."""
    g, r = gparts.reshape(-1).double(), rparts.reshape(-1).double()
    sums = list(range(8)) + [9]
    flips_d = float((g[8] - r[8]).abs())
    sums_rel = float(((g[sums] - r[sums]).abs() / r[sums].abs()).max())
    ok = (gparts.shape == rparts.shape and flips_d <= FLIPS_CELLS * nshards
          and sums_rel <= MP2_PARTS_RTOL and not g[10:].any())
    return ok, flips_d, sums_rel


def check_mp2_shard(dev, pm, st):
    """Phase 21, K9's shard mode on every shard of a 2x2 and a 3x3 grid of
    the 4K four-regions image (the init_multiphase start and its means):
    one launch against its plain version on the whole canvas at phase 9's K9
    bars, a second launch bitwise the first, each crop against the
    whole-image K9 launch's window (bitwise expected: the same arithmetic
    per cell) and the shards' partials summed against the whole image's;
    then MP_CHAIN_KS launches chained on an 8k-deep canvas (the comm_k
    chunk, whose halo cells advance between launches): each crop against
    the whole-image K9 loop of as many iterations, its labels against the
    plain version's."""
    mk = multiphase_kernel
    name = "K9 mp2_iteration_sharded"
    u, phis, cs, _ = mp2_inputs(H4K, W4K, dev, pm)
    rtol, atol = MP2_BARS["K9 mp2_iteration"]
    whole, wparts = mk.mp2_iteration(phis, u, cs, pm)
    chains = {}
    for k in MP_CHAIN_KS:
        x = phis
        for _ in range(k):
            x, _ = mk.mp2_iteration(x, u, cs, pm)
        chains[k] = x
    for nx, ny in SHARD_GRIDS:
        h, w = H4K // nx, W4K // ny
        errs, bitwise, psum, bad = [], True, 0.0, 0
        for pos, x, uc, par, edges, crop in mp_canvases(phis, u, nx, ny, 4,
                                                        dev):
            args = (x, uc, cs, pm, par, edges, crop)
            got, again = mk.mp2_iteration_sharded(*args), \
                mk.mp2_iteration_sharded(*args)
            ref = mk.mp2_iteration_sharded_reference(*args)
            torch.cuda.synchronize()
            tag = f"shard {pos} of {nx}x{ny} edges {edges}"
            repeat = (torch.equal(got[0], again[0])
                      and torch.equal(got[1], again[1]))
            ok, flips_d, sums_rel = mp2_parts_ok(got[1], ref[1])
            err = float((got[0] - ref[0]).abs().max())
            if not (repeat and ok and math.isfinite(err) and torch.allclose(
                    got[0], ref[0], rtol=rtol, atol=atol)):
                raise AssertionError(
                    f"{name} at {tag} disagrees with its plain version: phi "
                    f"max|d| {err}, flips |d| {flips_d}, sums rel "
                    f"{sums_rel}, repeat {repeat}")
            errs.append(err)
            ix, iy = pos
            mine = got[0][:, 4:4 + h, 4:4 + w]
            win = whole[:, ix * h:(ix + 1) * h, iy * w:(iy + 1) * w]
            if not torch.equal(mine, win):
                bitwise = False
                bad += int((mine != win).sum())
            psum = psum + got[1].double()
        ok, flips_d, sums_rel = mp2_parts_ok(psum.float(), wparts, nx * ny)
        if not ok or bad > 0:
            raise AssertionError(
                f"{name} {nx}x{ny}: {bad} crop cells differ from the "
                f"whole-image launch; partials summed: flips |d| {flips_d},"
                f" sums rel {sums_rel}")
        st["max_abs_err"] = max(st["max_abs_err"], *errs)
        print(f"phase 21 {name} {nx}x{ny} ({h}x{w} shards, D=4): phi "
              f"max|d| vs plain {max(errs):.3e} (rtol {rtol} atol {atol}), "
              f"crops bitwise equal to the whole-image K9 launch "
              f"{bitwise}, the shards' partials summed vs the whole image's"
              f" flips |d| {flips_d:g}, sums rel {sums_rel:.3e}; second "
              f"launches bitwise equal", flush=True)
        for k in MP_CHAIN_KS:
            D = 8 * k
            fracs, same = [], True
            for pos, x, uc, par, edges, crop in mp_canvases(
                    phis, u, nx, ny, D, dev):
                got = ref = x
                for _ in range(k):
                    got, gparts = mk.mp2_iteration_sharded(
                        got, uc, cs, pm, par, edges, crop)
                    ref, _ = mk.mp2_iteration_sharded_reference(
                        ref, uc, cs, pm, par, edges, crop)
                torch.cuda.synchronize()
                ix, iy = pos
                mine = got[:, D:D + h, D:D + w]
                fracs.append(label_frac(mine, ref[:, D:D + h, D:D + w]))
                same = same and torch.equal(
                    mine, chains[k][:, ix * h:(ix + 1) * h,
                                    iy * w:(iy + 1) * w])
                if not bool(torch.isfinite(gparts).all()):
                    raise AssertionError(f"{name} k={k}: partials not "
                                         f"finite")
            print(f"phase 21 {name} {nx}x{ny}: {k} launches chained on a "
                  f"{D}-deep canvas: crops bitwise equal to the whole-image"
                  f" K9 loop of {k} iterations {same}; labels differ from "
                  f"the plain version's at {max(fracs):.3e} of the cells "
                  f"(bar {LABELS_FRAC})", flush=True)
            if not same or max(fracs) > LABELS_FRAC:
                raise AssertionError(f"{name} chained k={k} on {nx}x{ny} "
                                     f"disagrees")
    return u, phis, cs


def check_sweep_parity(dev, pm, st):
    """Phase 21, K1's force mode with a parity: parity 1 against its plain
    version at phase 3's bars at the multiphase main path's shapes (phi0's
    coupling force on the init_multiphase start), a second launch bitwise
    the first, and parity 0 (through the same instantiation) bitwise equal
    to the whole-image force mode."""
    name = "K1 fused_sweep (parity)"
    fk = fused_kernel
    for h, w in ((H4K, W4K), (512, 512)):
        _, phis, _, f = mp2_inputs(h, w, dev, pm)
        phi = phis[0].contiguous()
        got = fk.fused_sweep(phi, f, pm, parity=1)
        again = fk.fused_sweep(phi, f, pm, parity=1)
        ref = fk.fused_sweep_reference(phi, f, pm, parity=1)
        zero, base = fk.fused_sweep(phi, f, pm, parity=0), \
            fk.fused_sweep(phi, f, pm)
        torch.cuda.synchronize()
        err = hold(name, got, ref, f"{h}x{w} parity 1")
        same0 = torch.equal(zero[0], base[0]) and torch.equal(zero[1],
                                                              base[1])
        repeat = torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                               again[1])
        st["max_abs_err"] = max(st["max_abs_err"], err)
        print(f"phase 21 {name} {h}x{w}: parity 1 phi max|d| vs plain "
              f"{err:.3e} (phase 3's bars); parity 0 bitwise equal to the "
              f"whole-image force mode {same0}; second launch bitwise equal "
              f"{repeat}", flush=True)
        if not (same0 and repeat):
            raise AssertionError(f"{name} at {h}x{w}: parity 0 or a second "
                                 f"launch differs")


def morph_shard_inputs(dev, p):
    """The 4K morph inputs of the shard checks: the two-disks image's
    checkerboard binary start and its frozen force, the GAC scene's edge
    map (whose aux stack the driver builds per shard)."""
    u = torch.from_numpy(two_disks(H4K, W4K)[0]).to(dev)
    ls = gacm._init_ls(u, p, None)
    l1, l2 = morphm._lambdas(u, p, None, None)
    g = inverse_gaussian_gradient(
        torch.from_numpy(gac_scene(H4K, W4K)[0]).to(dev), 5.0,
        2.0).contiguous()
    return ls, morphm._force_plane(u, ls, l1, l2), g


def morph_blocks(ls, aux, nx, ny, D, dev, gac):
    """Each shard's (position, padded level set, padded aux, edges) of an
    nx x ny grid: the force padded as the image is, or the (dgx, dgy,
    mask) stack of the padded edge map (the drivers' blocks)."""
    mesh = make_grid_mesh(nx, ny, [dev] * (nx * ny))
    sharding = grid_sharding(mesh)
    lsp = exchange_halo2d(shard_grid(ls, sharding), D)
    ap = exchange_halo2d(shard_grid(aux, sharding), D)
    return [((ix, iy), lsp[ix][iy],
             (morph_kernel.gac_aux_stack(ap[ix][iy], 1, GAC_THRESHOLD)
              if gac else ap[ix][iy]),
             (ix == 0, ix == nx - 1, iy == 0, iy == ny - 1))
            for ix in range(nx) for iy in range(ny)]


def morph_shard_call(gac, k, D, plain=False):
    """fn(block, aux, edges) of a K11 shard kind (or its plain version):
    k iterations, smoothing 1, parity0 0, GAC with balloon 1."""
    mk = morph_kernel
    if gac:
        f = mk.gac_chunk_shard_reference if plain else mk.gac_chunk_shard
        return lambda x, a, e: f(x, a, e, (D,) * 4, k, 1, 0, 1,
                                 GAC_THRESHOLD)
    f = mk.morph_chunk_shard_reference if plain else mk.morph_chunk_shard
    return lambda x, a, e: f(x, a, e, (D,) * 4, k, 1, 0)


def check_morph_shard(dev, p, stats):
    """Phase 21, K11's shard kinds on every shard of a 2x2 and a 3x3 grid
    of the 4K inputs (k = MORPH_SHARD_K on the driver's D-deep blocks):
    bitwise equal to the plain version on the whole block, a second launch
    bitwise the first, and each owned block bitwise equal to the
    whole-image K11 launch's window."""
    ls, f, g = morph_shard_inputs(dev, p)
    k = MORPH_SHARD_K
    whole = {False: morph_kernel.morph_chunk(ls, f, k, 1, 0),
             True: morph_kernel.gac_chunk(
                 ls, morph_kernel.gac_aux_stack(g, 1, GAC_THRESHOLD), k, 1, 0,
                 1, GAC_THRESHOLD, pre_dg=True)}
    for name, gac in (("K11 morph_chunk_shard (acwe_sh)", False),
                      ("K11 gac_chunk_shard (gac_pre_sh)", True)):
        D = morph_kernel._reach("gac" if gac else "acwe", 1) * k
        call, plain = morph_shard_call(gac, k, D), \
            morph_shard_call(gac, k, D, True)
        for nx, ny in SHARD_GRIDS:
            h, w = H4K // nx, W4K // ny
            for pos, x, a, edges in morph_blocks(ls, g if gac else f, nx, ny,
                                                 D, dev, gac):
                got, again, ref = call(x, a, edges), call(x, a, edges), \
                    plain(x, a, edges)
                torch.cuda.synchronize()
                ix, iy = pos
                win = whole[gac][ix * h:(ix + 1) * h, iy * w:(iy + 1) * w]
                if not (torch.equal(got, ref) and torch.equal(got, again)
                        and torch.equal(got[D:D + h, D:D + w], win)):
                    raise AssertionError(
                        f"{name} at shard {pos} of {nx}x{ny} edges {edges} "
                        f"differs: vs plain "
                        f"{int((got != ref).sum())} cells, vs the whole "
                        f"image {int((got[D:D + h, D:D + w] != win).sum())}")
            print(f"phase 21 {name} k={k} {nx}x{ny} ({h}x{w} shards, "
                  f"D={D}): every block bitwise equal to the plain version, "
                  f"every owned block bitwise equal to the whole-image K11 "
                  f"launch; second launches bitwise equal", flush=True)
    return ls, f, g


def frozen_mp2_loop(u, phis, pm, iters, k):
    """The unsharded K9 loop of the comm_k class: ``iters`` iterations,
    the means frozen over each k-chunk and refreshed from its last
    launch's partials."""
    cs = torch.stack(mpm.phase_means(u, phis, pm.eps))
    done = 0
    while done < iters:
        for _ in range(min(k, iters - done)):
            phis, parts = multiphase_kernel.mp2_iteration(phis, u, cs, pm)
        cs = parts[0:4] / torch.clamp(parts[4:8], min=1e-30)
        done += k
    return phis


def parity_sweeps(u, phis, pm, sweep):
    """One coupled iteration of the multiphase sweeps route with the
    red-black lattice offset by one (parity 1): the means, then each level
    set's force and its sweep through ``sweep`` (K1's force mode or its
    plain version). Returns the new level sets."""
    cs = mpm.phase_means(u, phis, pm.eps)
    new = [phis[m] for m in range(phis.shape[0])]
    for m in range(len(new)):
        f = mpm._coupling_term(u, new, cs, m, pm)
        new[m] = sweep(new[m].contiguous(), f, pm, parity=1)[0]
    return torch.stack(new)


def mp_morph_main_paths(dev, card, u, gt, pm, p):
    """Phase 22: the slice through the user entry points at 4K on a 2x2
    grid of four shards on the card, every launch counted. Returns the
    multiphase and morph inputs phase 23 times."""
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    nsh = 4
    img4k, gt4k = two_disks(H4K, W4K)
    u2 = torch.from_numpy(img4k).to(dev)
    gimg, gtg, seed = gac_scene(H4K, W4K)
    g4k = inverse_gaussian_gradient(torch.from_numpy(gimg).to(dev), 5.0,
                                    2.0).contiguous()
    s4k = torch.from_numpy(seed).to(dev)
    img1k = two_disks(1080, 1920)[0]
    u1k = torch.from_numpy(img1k).to(dev)
    gimg1k, gtg1k, seed1k = gac_scene(1080, 1920)
    g1k = inverse_gaussian_gradient(torch.from_numpy(gimg1k).to(dev), 5.0,
                                    2.0).contiguous()
    s1k = torch.from_numpy(seed1k).to(dev)
    gkw = dict(balloon=-1, threshold=GAC_THRESHOLD)
    phis0 = mpm.init_multiphase((H4K, W4K), 2, device=dev)
    pk = ct.CVParams(mu=MU_MP_SHARD, max_iter=500)
    runs = {
        "multiphase fixed comm_k=1": lambda: segment_multiphase_sharded(
            u, pm, mesh, max_iter=MP_SHARD_ITERS, fixed=True),
        "multiphase fixed comm_k=8": lambda: segment_multiphase_sharded(
            u, pm, mesh, max_iter=MP_SHARD_ITERS, fixed=True,
            comm_k=SHARD_K),
        "multiphase fixed comm_k=8 mu=0.001": lambda: (
            segment_multiphase_sharded(u, pk, mesh, max_iter=MP_SHARD_ITERS,
                                       fixed=True, comm_k=SHARD_K)),
        "multiphase tolerance": lambda: segment_multiphase_sharded(
            u, pm, mesh),
        "multiphase trace": lambda: segment_multiphase_sharded_fixed_trace(
            u, pm, mesh, iters=MP_TRACE_ITERS),
        "multiphase trace, plain route": lambda: (
            segment_multiphase_sharded_fixed_trace(
                u, pm, mesh, iters=MP_TRACE_ITERS, use_pallas=False)),
        "sweeps parity 1": lambda: parity_sweeps(u, phis0, pm,
                                                 fused_kernel.fused_sweep),
        "morph-acwe comm_k=8": lambda: segment_morph_sharded_chunked(
            u2, p, mesh=mesh, comm_k=MORPH_SHARD_K),
        "morph-gac comm_k=8": lambda: segment_gac_sharded_chunked(
            g4k, p, mesh=mesh, ls0=s4k, comm_k=MORPH_SHARD_K, **gkw),
        "segment_morph_sharded 1080p": lambda: morphm.segment_morph_sharded(
            u1k, p, mesh=mesh),
        "segment_gac_sharded 1080p": lambda: gacm.segment_gac_sharded(
            g1k, p, mesh=mesh, ls0=s1k, **gkw),
    }
    reset_mp_shard_counts()
    got, launches = {}, {}
    for tag, fn in runs.items():
        before = mp_shard_counts()
        got[tag] = fn()
        torch.cuda.synchronize()
        launches[tag] = {n.split()[0] + " " + n.split()[1]: v - before[n]
                         for n, v in mp_shard_counts().items()
                         if v != before[n]}
    counts = mp_shard_counts()

    # the unsharded runs of the same trajectory classes
    ref = {
        "multiphase fixed comm_k=1": ct.segment_multiphase(
            u, pm, fixed=True, max_iter=MP_SHARD_ITERS),
        "multiphase tolerance": ct.segment_multiphase(u, pm),
    }
    frozen = {tag: frozen_mp2_loop(u, phis0, q, MP_SHARD_ITERS, SHARD_K)
              for tag, q in (("multiphase fixed comm_k=8", pm),
                             ("multiphase fixed comm_k=8 mu=0.001", pk))}
    trace_ref = ct.segment_multiphase_fixed(u, pm, iters=MP_TRACE_ITERS)
    trace_plain = ct.segment_multiphase_fixed(u, pm, iters=MP_TRACE_ITERS,
                                              use_pallas=False)
    trace = got["multiphase trace"]
    e_final = mpm.multiphase_energy(u, trace.phis, pm).double()
    plain_sweeps = parity_sweeps(u, phis0, pm,
                                 fused_kernel.fused_sweep_reference)
    acwe, gac = got["morph-acwe comm_k=8"], got["morph-gac comm_k=8"]
    acwe_ref = ct.segment_morph_iterations(u2, p, iters=acwe.iters,
                                           k=MORPH_SHARD_K)
    gac_ref = ct.segment_gac_iterations(g4k, p, iters=gac.iters, ls0=s4k,
                                        **gkw)
    wm, wg = got["segment_morph_sharded 1080p"], \
        got["segment_gac_sharded 1080p"]
    wm_ref = ct.segment_morph(u1k, p, use_pallas=False)
    wg_ref = ct.segment_gac(g1k, p, ls0=s1k, use_pallas=False, **gkw)
    torch.cuda.synchronize()

    checks = {}
    for tag in ("multiphase fixed comm_k=1",
                "multiphase fixed comm_k=8 mu=0.001", "multiphase tolerance"):
        checks[f"{tag} accuracy vs truth"] = (
            best_accuracy(got[tag].labels.cpu(), gt), 0.99)
    checks["multiphase fixed comm_k=1 labels vs unsharded"] = (
        1.0 - label_frac(got["multiphase fixed comm_k=1"].phis,
                         ref["multiphase fixed comm_k=1"].phis), 0.999)
    for tag, phis in frozen.items():
        checks[f"{tag} labels vs the unsharded frozen-means loop"] = (
            1.0 - label_frac(got[tag].phis, phis), 0.999)
    merged = best_accuracy(got["multiphase fixed comm_k=8"].labels.cpu(),
                           gt)
    checks["multiphase tolerance labels vs unsharded"] = (
        1.0 - label_frac(got["multiphase tolerance"].phis,
                         ref["multiphase tolerance"].phis), 0.999)
    checks["sweeps parity 1 labels vs plain"] = (
        1.0 - label_frac(got["sweeps parity 1"], plain_sweeps), 0.999)
    checks["morph-acwe IoU vs truth"] = (iou_phases(acwe.mask.cpu(), gt4k),
                                         0.98)
    checks["morph-acwe IoU vs unsharded K11 route"] = (
        iou(acwe.mask.cpu(), acwe_ref.mask.cpu()), 0.999)
    checks["morph-gac IoU vs truth"] = (iou(gac.mask.cpu(), gtg), 0.95)
    checks["segment_morph_sharded IoU vs unsharded"] = (
        iou(wm.mask.cpu(), wm_ref.mask.cpu()), 0.999)
    ties = {"morph-acwe": int((acwe.ls != acwe_ref.ls).sum()),
            "segment_morph_sharded": int((wm.ls != wm_ref.ls).sum())}
    def e_gap(a, b):
        a, b = a.energy.double(), b.energy.double()
        return float(((a - b).abs() / b.abs()).max())

    e_rel = e_gap(trace, trace_ref)
    e_plain = e_gap(got["multiphase trace, plain route"], trace_plain)
    e_bar = max(MP_ENERGY_RTOL, 2.0 * e_plain)
    e_self = float((trace.energy[-1].double() - e_final).abs()
                   / e_final.abs())
    checks["multiphase trace labels vs unsharded"] = (
        1.0 - label_frac(trace.phis, trace_ref.phis), 0.999)
    gac_same = torch.equal(gac.ls, gac_ref.ls)
    wg_same = torch.equal(wg.ls, wg_ref.ls) and wg.iters == wg_ref.iters
    mp_tol = got["multiphase tolerance"]
    print(f"phase 22 sharded multiphase and morph slice at 4K on a 2x2 grid "
          f"of shards on {dev}: segment_multiphase_sharded fixed "
          f"{MP_SHARD_ITERS} iterations at comm_k 1 and {SHARD_K}, "
          f"tolerance {mp_tol.iters} iterations (unsharded "
          f"{ref['multiphase tolerance'].iters}); comm_k={SHARD_K} at mu "
          f"{MU_MP:g} accuracy vs truth {merged:.6f} (the frozen-means "
          f"class merges two phases there; no bar); trace {MP_TRACE_ITERS} "
          f"iterations: energy max rel diff vs segment_multiphase_fixed "
          f"{e_rel:.3e} (<= {e_bar:.3e}: the larger of {MP_ENERGY_RTOL} and "
          f"twice the plain routes' sharded-vs-unsharded gap {e_plain:.3e};"
          f" the unsharded kernel route vs the plain one "
          f"{e_gap(trace_ref, trace_plain):.3e}), its last energy vs the "
          f"assembled final state's {e_self:.3e} (<= "
          f"{MP_ENERGY_SELF_RTOL}); morph-acwe comm_k="
          f"{MORPH_SHARD_K} {acwe.iters} iterations, cells differing from "
          f"the unsharded K11 route (mean-order ties) {ties['morph-acwe']};"
          f" morph-gac comm_k={MORPH_SHARD_K} {gac.iters} iterations, level"
          f" set bitwise equal to segment_gac_iterations {gac_same}; "
          f"1080p segment_morph_sharded {wm.iters} iterations (unsharded "
          f"{wm_ref.iters}), ties {ties['segment_morph_sharded']}, "
          f"segment_gac_sharded {wg.iters} (unsharded {wg_ref.iters}), "
          f"bitwise with equal iterations {wg_same}; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in checks.items())
          + "; launches " + "; ".join(
              f"{t}: " + (", ".join(f"{n}={v}" for n, v in c.items())
                          or "none") for t, c in launches.items()),
          flush=True)
    want = {
        "multiphase fixed comm_k=1": {"K9 mp2_iteration_sharded":
                                      nsh * MP_SHARD_ITERS},
        "multiphase fixed comm_k=8": {"K9 mp2_iteration_sharded":
                                      nsh * MP_SHARD_ITERS},
        "multiphase fixed comm_k=8 mu=0.001": {
            "K9 mp2_iteration_sharded": nsh * MP_SHARD_ITERS},
        "multiphase tolerance": {"K9 mp2_iteration_sharded":
                                 nsh * mp_tol.iters},
        "multiphase trace": {"K9 mp2_iteration_sharded":
                             nsh * MP_TRACE_ITERS},
        "multiphase trace, plain route": {},
        "sweeps parity 1": {"K1 fused_sweep": 2},
        "morph-acwe comm_k=8": {"K11 morph_chunk_shard":
                                nsh * (acwe.iters // MORPH_SHARD_K)},
        "morph-gac comm_k=8": {"K11 gac_chunk_shard":
                               nsh * (gac.iters // MORPH_SHARD_K)},
        "segment_morph_sharded 1080p": {},
        "segment_gac_sharded 1080p": {},
    }
    for tag, w in want.items():
        if launches[tag] != w:
            raise AssertionError(f"{tag} launched {launches[tag]}, "
                                 f"expected {w}")
    check_masks(checks)
    if not (e_rel <= e_bar and e_self <= MP_ENERGY_SELF_RTOL and gac_same
            and wg_same and wm.iters == wm_ref.iters):
        raise AssertionError("a sharded run differs from its unsharded "
                             "counterpart (trace energy, GAC level set or "
                             "iterations)")
    if not (mp_tol.iters < pm.max_iter and acwe.iters < p.max_iter
            and gac.iters < p.max_iter):
        raise AssertionError("a sharded tolerance run did not converge")
    for res in got.values():
        phis = res if isinstance(res, torch.Tensor) else (
            res.phis if hasattr(res, "phis") else res.ls)
        if not torch.isfinite(phis).all():
            raise AssertionError("non-finite level set")
    return counts, mesh, u2, g4k, s4k


def mp_morph_rates(dev, card, st, u, pm, p, mesh, u2, g4k, s4k):
    """Phase 23: each run's Mpixel-it/s beside the unsharded route in the
    same run, each kernel mode's time a launch (ms, plain ms, bound), and
    the halo exchange's host and device ms a chunk."""
    gkw = dict(balloon=-1, threshold=GAC_THRESHOLD)
    p0 = ct.CVParams(tol=0.0, max_iter=MORPH_SHARD_RATE_ITERS)
    its, mits = MP_SHARD_ITERS, MORPH_SHARD_RATE_ITERS
    rates = {
        "multiphase unsharded segment_multiphase(fixed) (K9)": (its, lambda: (
            ct.segment_multiphase(u, pm, fixed=True, max_iter=its))),
        "multiphase 2x2 comm_k=1": (its, lambda: segment_multiphase_sharded(
            u, pm, mesh, max_iter=its, fixed=True)),
        "multiphase 2x2 comm_k=8": (its, lambda: segment_multiphase_sharded(
            u, pm, mesh, max_iter=its, fixed=True, comm_k=SHARD_K)),
        "morph-acwe unsharded segment_morph_iterations k=8": (
            mits, lambda: ct.segment_morph_iterations(u2, p, iters=mits)),
        "morph-acwe 2x2 comm_k=8": (mits, lambda: (
            segment_morph_sharded_chunked(u2, p0, mesh=mesh,
                                          comm_k=MORPH_SHARD_K))),
        "morph-gac unsharded segment_gac_iterations k=4": (
            mits, lambda: ct.segment_gac_iterations(g4k, p, iters=mits,
                                                    ls0=s4k, **gkw)),
        "morph-gac 2x2 comm_k=8": (mits, lambda: segment_gac_sharded_chunked(
            g4k, p0, mesh=mesh, ls0=s4k, comm_k=MORPH_SHARD_K, **gkw)),
    }
    out = {tag: (it, time_ms(fn, 1)) for tag, (it, fn) in rates.items()}
    print("phase 23 sharded multiphase and morph throughput at 4K "
          "(Mpixel-iters/s, the whole run): " + "; ".join(
              f"{t} {it} iterations {ms:.3f} ms = "
              f"{H4K * W4K * it / (ms * 1e3):.1f}"
              for t, (it, ms) in out.items()) + f" [{card}]", flush=True)

    # each mode a launch: K9 and K11 at the 2x2 canvas of shard (0, 0),
    # K1 with a parity at 4K
    h, w = H4K // 2, W4K // 2
    mk = multiphase_kernel
    phis = mpm.init_multiphase((H4K, W4K), 2, device=dev)
    cs = torch.stack(mpm.phase_means(u, phis, pm.eps))
    (_, x, uc, par, edges, crop), = [
        c for c in mp_canvases(phis, u, 2, 2, 4, dev) if c[0] == (0, 0)]
    args = (x, uc, cs, pm, par, edges, crop)
    f = mpm._coupling_term(u, phis, cs, 0, pm)
    phi0 = phis[0].contiguous()
    ls, fm, g = morph_shard_inputs(dev, p)
    modes = {
        "K9 mp2_iteration_sharded": (
            lambda: mk.mp2_iteration_sharded(*args),
            lambda: mk.mp2_iteration_sharded_reference(*args),
            bound_mp2(h, w, 1, 1, False)),
        "K1 fused_sweep (parity)": (
            lambda: fused_kernel.fused_sweep(phi0, f, pm, parity=1),
            lambda: fused_kernel.fused_sweep_reference(phi0, f, pm, 1),
            bound_sweep(H4K, W4K)),
    }
    k = MORPH_SHARD_K
    for name, gac in (("K11 morph_chunk_shard (acwe_sh)", False),
                      ("K11 gac_chunk_shard (gac_pre_sh)", True)):
        D = morph_kernel._reach("gac" if gac else "acwe", 1) * k
        (_, xb, a, e), = [b for b in morph_blocks(
            ls, g if gac else fm, 2, 2, D, dev, gac) if b[0] == (0, 0)]
        call, plain = morph_shard_call(gac, k, D), \
            morph_shard_call(gac, k, D, True)
        modes[name] = (lambda c=call, xb=xb, a=a, e=e: c(xb, a, e),
                       lambda c=plain, xb=xb, a=a, e=e: c(xb, a, e),
                       bound_morph("gac_pre" if gac else "acwe", h, w, k, 1,
                                   1 if gac else 0))
    per_mode = []
    for name, (fn, pl, (b_ms, b_by)) in modes.items():
        ms = queued_ms(fn, 20)
        plain_ms = time_ms(pl, 2)
        st[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
        per_mode.append(f"{name} {ms:.4f} ms (plain {plain_ms:.3f}, bound "
                        f"{b_ms:.4f} {b_by})")
    # the exchange a chunk: both level sets (D = 4 and 8 comm_k), the
    # morph level set (D = 24 ACWE, 32 GAC); host time (enqueueing) and
    # device time (queued behind a spin)
    stacks = _shard_phis(phis, mesh)
    lsb = shard_grid(ls, grid_sharding(mesh))
    canv = {}
    for tag, blocks, D in (("level sets D=4", stacks, 4),
                           (f"level sets D={8 * SHARD_K}", stacks,
                            8 * SHARD_K),
                           ("morph D=24", lsb, 24), ("morph D=32", lsb, 32)):
        def ex(blocks=blocks, D=D):
            return exchange_halo2d_batched(blocks, D)
        ex()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            ex()
        host = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        canv[tag] = (host, queued_ms(ex, 20))
    _, p512, _, f512 = mp2_inputs(512, 512, dev, pm)
    q512 = p512[0].contiguous()
    per_mode.append("K1 fused_sweep (parity) at 512^2 " + "%.4f" % queued_ms(
        lambda: fused_kernel.fused_sweep(q512, f512, pm, parity=1), 20)
        + " ms")
    print("phase 23 modes a launch (queued device ms; K9 and K11 at the "
          "2x2 canvas of shard (0, 0), K1 at 4K and 512^2): "
          + "; ".join(per_mode) + "; the halo exchange a chunk: "
          + ", ".join(f"{t} host {hst:.3f} ms, device {dv:.4f} ms"
                      for t, (hst, dv) in canv.items()) + f" [{card}]",
          flush=True)


def mp_morph_shard_phases(dev, card):
    """Phases 21-23, the sharded multiphase and morphological solvers at
    4K on a 2x2 grid of four shards on the card; returns the four kernel
    modes' stats for the JSON line."""
    pm = ct.CVParams(mu=MU_MP, max_iter=500)
    p = ct.CVParams()
    st = {name: dict(max_abs_err=0.0) for name in MP_SHARD}
    check_mp2_shard(dev, pm, st["K9 mp2_iteration_sharded"])
    check_sweep_parity(dev, pm, st["K1 fused_sweep (parity)"])
    check_morph_shard(dev, p, st)
    img, gt = four_regions(H4K, W4K)
    u = torch.from_numpy(img).to(dev)
    counts, mesh, u2, g4k, s4k = mp_morph_main_paths(dev, card, u, gt, pm, p)
    for name, n in counts.items():
        st[name]["launches"] = n
        if n < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    mp_morph_rates(dev, card, st, u, pm, p, mesh, u2, g4k, s4k)
    return st


# the halo mechanisms (phases 24-26) ----------------------------------------

def grids_err(a, b):
    """Largest |a - b| over two grids of blocks; inf where shapes differ."""
    err = 0.0
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if x.shape != y.shape:
                return math.inf
            err = max(err, float((x.double() - y.double()).abs().max()))
    return err


def grids_equal(a, b):
    return all(torch.equal(x, y) for ra, rb in zip(a, b)
               for x, y in zip(ra, rb))


def check_halo_kernel(dev, u4k, st):
    """Phase 24: K14 against its plain version and exchange_halo2d,
    bitwise, on every shard of a
    2x2 and a 3x3 grid of the 4K image and on the 1x1 self-ring, at the
    main path's depths, for the image and for a stack of two level sets
    (the multiphase exchange); a second launch bitwise the first; one
    launch an exchange; and, where there is more than one CUDA device, a
    2x2 grid laid over the cards (peer reads)."""
    phis = mpm.init_multiphase((H4K, W4K), 2, device=dev)
    err = 0.0
    for nx, ny in SHARD_GRIDS + ((1, 1),):
        mesh = make_grid_mesh(nx, ny, [dev] * (nx * ny))
        inputs = {"image": shard_grid(u4k, grid_sharding(mesh)),
                  "2 level sets": _shard_phis(phis, mesh)}
        for D in HALO_DEPTHS:
            for tag, blocks in inputs.items():
                n0 = exchange_halo2d_rdma.launches
                got = exchange_halo2d_rdma(blocks, D)
                once = exchange_halo2d_rdma.launches - n0
                again = exchange_halo2d_rdma(blocks, D)
                plain = halo_rdma.exchange_halo2d_rdma_reference(blocks, D)
                cat = exchange_halo2d(blocks, D)
                torch.cuda.synchronize()
                err = max(err, grids_err(got, plain))
                if not (grids_equal(got, plain) and grids_equal(got, cat)
                        and grids_equal(got, again) and once == 1):
                    raise AssertionError(
                        f"K14 on the {nx}x{ny} grid, {tag}, D={D}: not "
                        f"bitwise its plain version, exchange_halo2d and "
                        f"its own second launch (max|d| "
                        f"{err}), or {once} launches")
        print(f"phase 24 K14 {nx}x{ny} grid of the 4K image "
              f"({H4K // nx}x{W4K // ny} shards"
              + (", the self-ring" if nx * ny == 1 else "")
              + f"), D={HALO_DEPTHS}, the image and two level sets: one "
              f"launch an exchange, bitwise equal to its plain version and "
              f"to exchange_halo2d; second launches "
              f"bitwise equal", flush=True)
    st["max_abs_err"] = err
    n = torch.cuda.device_count()
    if n < 2:
        print("phase 24 K14 across cards (peer stores): skipped, one CUDA "
              "device", flush=True)
        return
    cards = [torch.device("cuda", i % n) for i in range(4)]
    mesh = make_grid_mesh(2, 2, cards)
    blocks = shard_grid(u4k, grid_sharding(mesh))
    for D in HALO_DEPTHS:
        n0 = exchange_halo2d_rdma.launches
        got = exchange_halo2d_rdma(blocks, D)
        once = exchange_halo2d_rdma.launches - n0
        plain = halo_rdma.exchange_halo2d_rdma_reference(blocks, D)
        torch.cuda.synchronize()
        if not (grids_equal(got, plain) and once == len(set(cards))):
            raise AssertionError(f"K14 across {n} cards, D={D}: not bitwise "
                                 f"its plain version, or {once} launches")
    print(f"phase 24 K14 2x2 grid over {n} cards (peer reads), "
          f"D={HALO_DEPTHS}: one launch a card, bitwise equal to its plain "
          f"version", flush=True)


def halo_main_paths(dev, card, u4k, gt4k, st):
    """Phase 25: halo='rdma' and halo='overlap' through the user entry
    points at 4K on a 2x2 grid of four shards on the card, K14's launches
    counted over exactly the rdma calls. Returns the runs phase 26
    times."""
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    pm = ct.CVParams(mu=MU_MP, max_iter=500)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    u_mp = torch.from_numpy(four_regions(H4K, W4K)[0]).to(dev)
    def gray(k):
        return lambda halo, iters=SHARD_ITERS if k > 1 else SHARD_ITERS_K1, \
            use_pallas=None: segment_sharded(
                u4k, pt, mesh, fixed=True, max_iter=iters, comm_k=k,
                halo=halo, use_pallas=use_pallas)

    runs = {  # tag: (run with a halo, exchanges of its rdma run)
        "gray comm_k=8": (gray(SHARD_K), SHARD_ITERS // SHARD_K),
        "gray comm_k=1": (gray(1), SHARD_ITERS_K1),
        "multiphase comm_k=1": (lambda halo: segment_multiphase_sharded(
            u_mp, pm, mesh, max_iter=MP_SHARD_ITERS, fixed=True, halo=halo),
            MP_SHARD_ITERS),
        "multiphase comm_k=8": (lambda halo: segment_multiphase_sharded(
            u_mp, pm, mesh, max_iter=MP_SHARD_ITERS, fixed=True,
            comm_k=SHARD_K, halo=halo), -(-MP_SHARD_ITERS // SHARD_K)),
        "trace": (lambda halo: segment_sharded_fixed_trace(
            u4k, ct.CVParams(), mesh, iters=TRACE_ITERS, halo=halo),
            TRACE_ITERS),
    }
    k9 = multiphase_kernel.mp2_iteration_sharded
    exchange_halo2d_rdma.launches = 0
    k9_before = k9.launches
    got, launches = {}, {}
    for tag, (fn, _) in runs.items():
        before = exchange_halo2d_rdma.launches
        got[tag] = fn("rdma")
        torch.cuda.synchronize()
        launches[tag] = exchange_halo2d_rdma.launches - before
    st["launches"] = exchange_halo2d_rdma.launches
    k9_launches = k9.launches - k9_before
    pp = {tag: fn("ppermute") for tag, (fn, _) in runs.items()}
    torch.cuda.synchronize()
    same = {}
    for tag, res in got.items():
        if tag.startswith("multiphase"):
            same[tag] = torch.equal(res.phis, pp[tag].phis)
        elif tag == "trace":
            same[tag] = (torch.equal(res.phi, pp[tag].phi)
                         and torch.equal(res.energy, pp[tag].energy))
        else:
            same[tag] = torch.equal(res.phi, pp[tag].phi)
    checks = {f"rdma {tag} IoU vs truth": (
        iou_phases(got[tag].mask.cpu(), gt4k), 0.99)
        for tag in ("gray comm_k=8", "gray comm_k=1")}

    # overlap: the kernels' hybrid at 4K against ppermute at the same
    # iterations, the plain route at 1080p
    before = exchange_halo2d_rdma.launches
    ovl, ovl_pp, gaps = {}, {}, {}
    for k in (SHARD_K, 1):
        tag, n = f"gray comm_k={k}", OVERLAP_ITERS[k]
        ovl[tag] = runs[tag][0]("overlap", n)
        ovl_pp[tag] = runs[tag][0]("ppermute", n)
        # the hybrid's two parents, the kernel and the plain route, differ
        # by as much: the f32 trajectory from the checkerboard is chaotic
        plain = runs[tag][0]("ppermute", n, False)
        gaps[tag] = (float((ovl[tag].phi - ovl_pp[tag].phi).abs().max()),
                     float((plain.phi - ovl_pp[tag].phi).abs().max()),
                     float(ovl_pp[tag].phi.abs().max()))
    u1k = torch.from_numpy(two_disks(1080, 1920)[0]).to(dev)
    plain_same = {}
    for k in (1, SHARD_K):
        kw = dict(fixed=True, max_iter=OVERLAP_PLAIN_ITERS, comm_k=k,
                  use_pallas=False)
        a = segment_sharded(u1k, pt, mesh, halo="overlap", **kw)
        b = segment_sharded(u1k, pt, mesh, **kw)
        plain_same[k] = torch.equal(a.phi, b.phi)
    torch.cuda.synchronize()
    if exchange_halo2d_rdma.launches != before:
        raise AssertionError("the overlap route launched K14")
    for tag, res in ovl.items():
        checks[f"overlap {tag} IoU vs ppermute"] = (
            iou(res.mask.cpu(), ovl_pp[tag].mask.cpu()), 0.999)
    print(f"phase 25 halo slice at 4K on a 2x2 grid of shards on {dev}: "
          f"halo='rdma' bitwise equal to halo='ppermute' "
          + ", ".join(f"{t} {v}" for t, v in same.items())
          + "; K14 launches " + ", ".join(f"{t} {v}" for t, v in
                                         launches.items())
          + f" (total {st['launches']}); K9 shard launches in the rdma "
          f"multiphase runs {k9_launches}; halo='overlap' (K1/K2 shard "
          f"interior), {OVERLAP_ITERS[SHARD_K]} and {OVERLAP_ITERS[1]} "
          f"iterations: max |phi - ppermute kernel route| (and the plain "
          f"route's, of max |phi|) "
          + ", ".join(f"{t} {a:.3e} ({b:.3e}, of {c:.3e})"
                      for t, (a, b, c) in gaps.items())
          + f"; plain overlap route at 1080p, {OVERLAP_PLAIN_ITERS} "
          f"iterations, bitwise equal to ppermute: "
          + ", ".join(f"comm_k={k} {v}" for k, v in plain_same.items())
          + "; " + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in
                              checks.items()) + f" [{card}]", flush=True)
    if not all(same.values()):
        raise AssertionError(f"halo='rdma' differs from ppermute: {same}")
    if not all(plain_same.values()):
        raise AssertionError(f"the plain overlap route differs from "
                             f"exchange-then-sweep: {plain_same}")
    want = {tag: n * K14_PER_EXCHANGE for tag, (_, n) in runs.items()}
    if launches != want:
        raise AssertionError(f"K14 launched {launches}, expected {want}")
    if k9_launches != 4 * 2 * MP_SHARD_ITERS:
        raise AssertionError(f"the rdma multiphase runs launched K9's shard "
                             f"mode {k9_launches} times")
    check_masks(checks)
    return runs


def host_ms(fn, n):
    """Host ms a call of fn over n calls, the stream drained before and
    after (what the caller's thread spends queueing one)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return t


def halo_rates(dev, card, u4k, st, runs):
    """Phase 26: K14 per exchange at the main path's depths, the gather
    twice (queued device ms, host ms a call), beside
    exchange_halo2d (its torch.cat route), the plain version and the
    bound; the two-level-set exchanges of phase 25's multiphase runs (D = 4
    at comm_k 1, 64 at comm_k 8) timed the same way; and the 4K 2x2 rates
    of the three halo mechanisms."""
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    blocks = shard_grid(u4k, grid_sharding(mesh))
    sets = _shard_phis(mpm.init_multiphase((H4K, W4K), 2, device=dev), mesh)
    h, w = H4K // 2, W4K // 2
    per_depth = []
    for tag, xs, depths in (("image", blocks, HALO_DEPTHS),
                            ("two level sets", sets, (4, 64))):
        m = xs[0][0].numel() // (h * w)
        for D in depths:
            t, host = [], []
            for _ in range(2):
                t.append(queued_ms(lambda: exchange_halo2d_rdma(xs, D), 20))
                host.append(host_ms(lambda: exchange_halo2d_rdma(xs, D), 20))
            ms = sum(t) / 2
            lib_ms = queued_ms(lambda: exchange_halo2d(xs, D), 20)
            plain_ms = time_ms(
                lambda: halo_rdma.exchange_halo2d_rdma_reference(xs, D), 5)
            nbytes = 4 * 4 * m * (h * w + (h + 2 * D) * (w + 2 * D))
            b_ms, b_by = roofline(nbytes, 0)
            per_depth.append(
                f"{tag} D={D} {ms:.4f} ms [{t[0]:.4f}, {t[1]:.4f}] "
                f"(exchange_halo2d {lib_ms:.4f}, plain "
                f"{plain_ms:.4f}, bound {b_ms:.4f} {b_by}, "
                f"{nbytes / 1e6:.1f} MB; host ms a call {min(host):.4f})")
            st.setdefault("times", {})[(tag, D)] = (ms, b_ms)
            if tag == "image" and D == HALO_TIMED:
                st.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms)
    print(f"phase 26 K14 an exchange of the four {h}x{w} shards (queued "
          "device ms, two runs): " + "; ".join(per_depth) + f" [{card}]",
          flush=True)
    # launches x (ms - bound) over phase 25's 363 exchanges
    times = st["times"]
    counts = {("image", 4): SHARD_ITERS_K1 + TRACE_ITERS,
              ("image", 32): SHARD_ITERS // SHARD_K,
              ("two level sets", 4): MP_SHARD_ITERS,
              ("two level sets", 64): -(-MP_SHARD_ITERS // SHARD_K)}
    print("phase 26 K14 over phase 25's exchanges, count x (ms - bound "
          "ms): " + "; ".join(
              f"{tag} D={D} {n} x ({times[tag, D][0]:.4f} - "
              f"{times[tag, D][1]:.4f}) = "
              f"{n * (times[tag, D][0] - times[tag, D][1]):.2f} ms"
              for (tag, D), n in counts.items()) + f" [{card}]", flush=True)
    rates = []
    for k, iters in ((SHARD_K, SHARD_ITERS), (1, SHARD_ITERS_K1)):
        fn = runs[f"gray comm_k={k}"][0]
        got = {}
        for halo in ("ppermute", "rdma", "overlap", "rdma", "ppermute"):
            n = OVERLAP_ITERS[k] if halo == "overlap" else iters
            t = time_ms(lambda: fn(halo, n), 1)
            got.setdefault(halo, []).append(
                f"{H4K * W4K * n / (t * 1e3):.1f}")
        rates.append(f"comm_k={k}: " + ", ".join(
            f"{halo} " + " / ".join(r) for halo, r in got.items()))
    print(f"phase 26 4K 2x2 rates (Mpixel-iters/s, the whole run, in turns "
          f"ppermute, rdma, overlap, rdma, ppermute; {SHARD_ITERS} and "
          f"{SHARD_ITERS_K1} iterations at comm_k {SHARD_K} and 1, overlap "
          f"{OVERLAP_ITERS[SHARD_K]} and {OVERLAP_ITERS[1]}): "
          + "; ".join(rates) + f" [{card}]", flush=True)


def halo_phases(dev, card, u4k, gt4k):
    """Phases 24-26, the halo mechanisms; returns K14's stats for the JSON
    line."""
    st = {name: dict(max_abs_err=0.0) for name in HALO}
    k14 = st["K14 exchange_halo2d_rdma"]
    check_halo_kernel(dev, u4k, k14)
    runs = halo_main_paths(dev, card, u4k, gt4k, k14)
    if k14["launches"] < 1:
        raise AssertionError("K14 was not launched on the main path")
    halo_rates(dev, card, u4k, k14, runs)
    return st


# the band body (phase 27): K2 and K5 on csrc/band.cuh, K3 and K6 on it
# with parity planes, in their whole-image and shard-canvas modes, against
# their plain versions and their second launches: (channels, shard mode,
# packed, the counter
# each wrapper adds to where it launches)
BAND = {
    "K2 banded_chunk": (0, False, False, banded_kernel.banded_chunk),
    "K2 banded_chunk_sharded": (0, True, False,
                                banded_kernel.banded_chunk_sharded),
    "K5 banded_chunk_mc": (RGB, False, False, banded_kernel.banded_chunk_mc),
    "K5 banded_chunk_mc_sharded": (RGB, True, False,
                                   banded_kernel.banded_chunk_mc_sharded),
    "K3 packed_banded_chunk": (0, False, True,
                               packed_kernel.packed_banded_chunk),
    "K3 packed_banded_chunk_sharded": (
        0, True, True, packed_kernel.packed_banded_chunk_sharded),
    "K6 packed_banded_chunk_mc": (RGB, False, True,
                                  packed_kernel.packed_banded_chunk_mc),
}
# chunk depths of the whole-image checks, the ragged even shape (its last
# tiles partial), and the shard checks' k (K5 also at the per-iteration
# route's k = 1)
BAND_KS, BAND_RAGGED, BAND_SHARD_KS = (1, 8, 21), (1000, 1500), (8, 1)
# phase 27's reruns of phase 19's sharded runs and the flat 4K runs:
# iterations (k = 1 runs: SHARD_ITERS_K1)
BAND_ITERS = 800


def band_counts():
    return {name: fn.launches for name, (*_, fn) in BAND.items()}


def band_call(c, p, k, packed=False):
    """fn(phi, image, c1, c2, shard ints or None) -> (phi, partials) of the
    band body through its wrappers; the image channels-first for K5 and
    K6; with ``packed`` (K3, K6) phi and the image are parity planes, and
    the shard ints those of the unpacked canvas (lattice parity 0)."""
    if packed:
        def run(x, u, a, b, shard):
            if shard is None:
                return (packed_kernel.packed_banded_chunk_mc if c
                        else packed_kernel.packed_banded_chunk)(x, u, a, b,
                                                                p, k)
            par, r0, r1, c0, c1, *edges = shard
            assert par == 0, shard
            return packed_kernel.packed_banded_chunk_sharded(
                x, u, a, b, p, k, edges, (r0, r1, c0, c1))
        return run

    def run(x, u, a, b, shard):
        if shard is None:
            return (banded_kernel.banded_chunk_mc if c
                    else banded_kernel.banded_chunk)(x, u, a, b, p, k)
        par, r0, r1, c0, c1, *edges = shard
        return (banded_kernel.banded_chunk_mc_sharded if c
                else banded_kernel.banded_chunk_sharded)(
            x, u, a, b, p, k, par, edges, (r0, r1, c0, c1))
    return run


def band_plain(c, p, k, packed=False):
    if packed:
        def run(x, u, a, b, shard):
            if shard is None:
                return (packed_kernel.packed_banded_chunk_mc_reference if c
                        else packed_kernel.packed_banded_chunk_reference)(
                    x, u, a, b, p, k)
            _, r0, r1, c0, c1, *edges = shard
            return packed_kernel.packed_banded_chunk_sharded_reference(
                x, u, a, b, p, k, edges, (r0, r1, c0, c1))
        return run

    def run(x, u, a, b, shard):
        if shard is None:
            return (banded_kernel.banded_chunk_mc_reference if c
                    else banded_kernel.banded_chunk_reference)(x, u, a, b,
                                                               p, k)
        par, r0, r1, c0, c1, *edges = shard
        return (banded_kernel.banded_chunk_mc_sharded_reference if c
                else banded_kernel.banded_chunk_sharded_reference)(
            x, u, a, b, p, k, par, edges, (r0, r1, c0, c1))
    return run


def check_band(name, c, p, k, args, tag, packed=False):
    """The band body's launch against its plain version (phase 3's bars)
    and its own second launch (bitwise); a packed launch (K3, K6) also
    against the flat kernel's launch on the unpacked inputs, packed (phi
    and every partial bitwise). Returns ((phi, partials), max |d phi| vs
    plain)."""
    got = band_call(c, p, k, packed=packed)(*args)
    again = band_call(c, p, k, packed=packed)(*args)
    ref = band_plain(c, p, k, packed=packed)(*args)
    if packed:
        x, u, a, b, shard = args
        flat = band_call(c, p, k)(packed_kernel.unpack_planes(x),
                                  packed_kernel.unpack_planes(u), a, b,
                                  shard)
        if not (torch.equal(got[0], packed_kernel.pack_planes(flat[0]))
                and torch.equal(got[1], flat[1])):
            raise AssertionError(f"{name} {tag}: differs from the flat "
                                 f"kernel's launch on the unpacked inputs")
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"{name} {tag}: two launches differ")
    return got, hold(name, got, ref, tag)


def band_inputs(dev, p, u4k, v4k):
    """{channels: (image (channels-first for RGB), c1, c2)} of the 4K
    checkerboard start, and the start itself."""
    phi = init_phi((H4K, W4K), p.init, torch.float32, device=dev)
    return phi, {0: (u4k, *region_means(u4k, phi, p.eps)),
                 RGB: (v4k.permute(2, 0, 1).contiguous(),
                       *region_means(v4k, phi, p.eps))}


def band_checks(dev, p, u4k, v4k, stats):
    """Phase 27's checks: every band launch of the listed shapes against
    the plain version and itself; each shard crop bitwise equal to the
    whole-image launch's window."""
    phi, inputs = band_inputs(dev, p, u4k, v4k)
    img, _ = two_disks(*BAND_RAGGED)
    rgb, _ = colored_squares(*BAND_RAGGED)
    ur = torch.from_numpy(img).to(dev)
    vr = torch.from_numpy(rgb).to(dev)
    phir = init_phi(BAND_RAGGED, p.init, torch.float32, device=dev)
    ragged = {0: (ur, *region_means(ur, phir, p.eps)),
              RGB: (vr.permute(2, 0, 1).contiguous(),
                    *region_means(vr, phir, p.eps))}
    pack, unpack = packed_kernel.pack_planes, packed_kernel.unpack_planes
    lines = []
    for name, (c, shard, packed, _) in BAND.items():
        st = stats[name]
        lay = pack if packed else (lambda t: t)
        also = (f"; phi and every partial bitwise {'K5' if c else 'K2'}'s "
                f"on the unpacked inputs" if packed else "")
        if not shard:
            whole = [(phi, inputs, H4K, W4K, k) for k in BAND_KS] + [
                (phir, ragged, *BAND_RAGGED, 8)]
            for x, inp, h, w, k in whole:
                u, c1, c2 = inp[c]
                _, err = check_band(name, c, p, k,
                                    (lay(x), lay(u), c1, c2, None),
                                    f"{h}x{w} k={k}", packed)
                st["max_abs_err"] = max(st["max_abs_err"], err)
            lines.append(f"{name} 4K k={BAND_KS} and {BAND_RAGGED[0]}x"
                         f"{BAND_RAGGED[1]} k=8: within phase 3's bars of "
                         f"the plain version, second launches bitwise"
                         f"{also}")
            continue
        u, c1, c2 = inputs[c]
        for k in BAND_SHARD_KS if c else BAND_SHARD_KS[:1]:
            D = 4 * k
            whole = band_call(c, p, k, packed=packed)(lay(phi), lay(u), c1,
                                                      c2, None)[0]
            whole = unpack(whole) if packed else whole
            for nx, ny in SHARD_GRIDS + ((1, 1),):
                h, w = H4K // nx, W4K // ny
                for pos, x, uc, par, edges, crop in shard_canvases(
                        phi, u, nx, ny, D, dev):
                    sh = _cuda.shard_args(*x.shape, k, par, crop, edges)
                    tag = f"k={k} shard {pos} of {nx}x{ny}"
                    got, err = check_band(
                        name, c, p, k, (lay(x), lay(uc), c1, c2, sh), tag,
                        packed)
                    st["max_abs_err"] = max(st["max_abs_err"], err)
                    ix, iy = pos
                    mine = unpack(got[0]) if packed else got[0]
                    if not torch.equal(mine[D:D + h, D:D + w],
                                       whole[ix * h:(ix + 1) * h,
                                             iy * w:(iy + 1) * w]):
                        raise AssertionError(f"{name} {tag}: the crop "
                                             f"differs from the whole-image "
                                             f"launch")
            lines.append(f"{name} k={k} every shard of 2x2, 3x3 and the 1x1 "
                         f"canvas: within phase 3's bars of the plain "
                         f"version, each crop bitwise the whole-image "
                         f"launch's{also}")
    return lines


def band_times(dev, card, p, u4k, v4k, stats, sh_stats):
    """Phase 27's times: the band body twice (queued) at the main path's
    shapes, beside the bound, the card's blocks per SM and the waves a
    launch takes."""
    phi, inputs = band_inputs(dev, p, u4k, v4k)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [("K2 banded_chunk", "4K", 8, None),
             ("K5 banded_chunk_mc", "4K RGB", 8, None),
             ("K2 banded_chunk_sharded", "2x2 canvas", 8, (2, 2)),
             ("K5 banded_chunk_mc_sharded", "2x2 canvas RGB", 8, (2, 2)),
             ("K5 banded_chunk_mc_sharded", "2x2 canvas RGB", 1, (2, 2)),
             ("K2 banded_chunk_sharded", "1x1 canvas", 8, (1, 1)),
             ("K3 packed_banded_chunk", "4K", 8, None),
             ("K6 packed_banded_chunk_mc", "4K RGB", 8, None),
             ("K3 packed_banded_chunk_sharded", "2x2 canvas", 8, (2, 2)),
             ("K3 packed_banded_chunk_sharded", "1x1 canvas", 8, (1, 1))]
    out = []
    for name, tag, k, grid in cases:
        c, _, packed, _ = BAND[name]
        lay = packed_kernel.pack_planes if packed else (lambda t: t)
        u, c1, c2 = inputs[c]
        if grid is None:
            x, uc, sh, (h, w) = phi, u, None, (H4K, W4K)
        else:
            (_, x, uc, par, edges, crop), = [
                s for s in shard_canvases(phi, u, *grid, 4 * k, dev)
                if s[0] == (0, 0)]
            sh = _cuda.shard_args(*x.shape, k, par, crop, edges)
            h, w = crop[1] - crop[0], crop[3] - crop[2]
        geo = _cuda.band_geometry(
            *x.shape, k, None if sh is None else tuple(sh[1:5]),
            (c or 1) + 4 if c else 5, 4 * c if c else 2, sms)
        args = (lay(x), lay(uc), c1, c2, sh)
        new = band_call(c, p, k, packed=packed)
        t = [queued_ms(lambda: new(*args), 20) for _ in range(2)]
        th, tw, px, py, cap = geo
        occ = _cuda.band_occupancy(c, sh is not None, px * py, cap, packed)
        nblocks = math.ceil(h / th) * math.ceil(w / tw)
        b_ms, b_by = bound(h, w, k, c)
        ms = sum(t) / 2
        out.append(f"{name} {tag} k={k}: {t[0]:.4f}, {t[1]:.4f} ms (bound "
                   f"{b_ms:.4f} {b_by}); tile {th}x{tw}, "
                   f"{-(-px * py // 32) * 32} threads, window <= {cap} "
                   f"cells ({8 * cap} B), {occ} blocks/SM, {nblocks} blocks "
                   f"= {nblocks / (occ * sms):.2f} waves")
        st = (stats if grid is None else sh_stats)[name]
        if k == 8 and tag != "1x1 canvas":
            st.update(ms=ms, bound_ms=b_ms, bound_by=b_by)
    print("phase 27 band body (queued device ms a launch, two runs): "
          + "; ".join(out) + f" [{card}]", flush=True)


def band_runs(dev, card, u4k, gt4k, v4k, gtc4k):
    """Phase 27's runs through the entry points: phase 19's sharded runs
    (gray and RGB k = 8, RGB k = 1, the 1x1 mesh flat and packed) and the
    flat and default-routed (packed) 4K segment_banded_fixed runs, their
    masks against the truth and their K2/K3/K5/K6 launches counted; then
    their rates."""
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    pv = ct.CVParams(mu=0.0001 * 255.0 ** 2, max_iter=500)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    mesh1 = make_grid_mesh(1, 1, [dev])
    chunks = BAND_ITERS // SHARD_K
    runs = {  # run, truth, iterations, launches
        "2x2 gray k=8": (lambda: segment_sharded(
            u4k, pt, mesh, fixed=True, max_iter=BAND_ITERS, comm_k=SHARD_K),
            gt4k, BAND_ITERS, {"K2 banded_chunk_sharded": 4 * chunks}),
        "2x2 rgb k=8": (lambda: segment_sharded(
            v4k, pv, mesh, fixed=True, max_iter=BAND_ITERS, comm_k=SHARD_K),
            gtc4k, BAND_ITERS, {"K5 banded_chunk_mc_sharded": 4 * chunks}),
        "2x2 rgb k=1": (lambda: segment_sharded(
            v4k, pv, mesh, fixed=True, max_iter=SHARD_ITERS_K1), gtc4k,
            SHARD_ITERS_K1,
            {"K5 banded_chunk_mc_sharded": 4 * SHARD_ITERS_K1}),
        "1x1 gray k=8": (lambda: segment_sharded(
            u4k, pt, mesh1, fixed=True, max_iter=BAND_ITERS,
            comm_k=SHARD_K), gt4k, BAND_ITERS,
            {"K2 banded_chunk_sharded": chunks}),
        "4K gray packed=False": (lambda: ct.segment_banded_fixed(
            u4k, pt, BAND_ITERS, k=SHARD_K, packed=False), gt4k,
            BAND_ITERS, {"K2 banded_chunk": chunks}),
        "4K rgb packed=False": (lambda: ct.segment_banded_fixed(
            v4k, pv, BAND_ITERS, k=SHARD_K, packed=False), gtc4k,
            BAND_ITERS, {"K5 banded_chunk_mc": chunks}),
        "1x1 gray k=8 packed": (lambda: segment_sharded(
            u4k, pt, mesh1, fixed=True, max_iter=BAND_ITERS,
            comm_k=SHARD_K, packed=True), gt4k, BAND_ITERS,
            {"K3 packed_banded_chunk_sharded": chunks}),
        "4K gray default route": (lambda: ct.segment_banded_fixed(
            u4k, pt, BAND_ITERS, k=SHARD_K), gt4k, BAND_ITERS,
            {"K3 packed_banded_chunk": chunks}),
        "4K rgb default route": (lambda: ct.segment_banded_fixed(
            v4k, pv, BAND_ITERS, k=SHARD_K), gtc4k, BAND_ITERS,
            {"K6 packed_banded_chunk_mc": chunks}),
    }
    checks, launches = {}, {}
    for tag, (fn, gt, _, want) in runs.items():
        before = band_counts()
        res = fn()
        torch.cuda.synchronize()
        have = {n: v - before[n] for n, v in band_counts().items()
                if v - before[n]}
        if have != want:
            raise AssertionError(f"{tag} launched {have}, expected {want}")
        launches[tag] = have
        mask = res.mask if hasattr(res, "mask") else res[1]
        checks[f"{tag} IoU vs truth"] = (iou_phases(mask.cpu(), gt), 0.99)
    print("phase 27 runs through the band body: "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in
                      checks.items())
          + "; launches " + "; ".join(
              f"{t}: " + ", ".join(f"{n}={v}" for n, v in c.items())
              for t, c in launches.items()), flush=True)
    check_masks(checks)
    rates = {tag: (it, time_ms(fn, 1))
             for tag, (fn, _, it, _) in runs.items()}
    print("phase 27 rates at 4K (Mpixel-iters/s, the whole run): "
          + "; ".join(f"{t} {it} iterations {ms:.3f} ms = "
                      f"{H4K * W4K * it / (ms * 1e3):.1f}"
                      for t, (it, ms) in rates.items()) + f" [{card}]",
          flush=True)


def band_phase(dev, card, u4k, gt4k, v4k, gtc4k, stats, sh_stats,
               sass_parent):
    """Phase 27: the band body. Registers, spills and the SASS check
    against a parent checkout (given), then the checks, times and runs.
    Returns whether the SASS check ran (it raises where it fails)."""
    regs = [s for s in ptxas_summary().split(", ") if s.startswith("band")]
    print("phase 27 band body ptxas: " + ", ".join(regs), flush=True)
    if sass_parent:
        proc = subprocess.run([sys.executable, "sass_diff.py", sass_parent],
                              capture_output=True, text=True)
        print("phase 27 " + proc.stdout.strip().replace("\n", " | "),
              flush=True)
        if proc.returncode:
            raise AssertionError(f"sass_diff.py failed ({proc.returncode}): "
                                 f"{proc.stderr[-2000:]}")
    else:
        print("phase 27 sass_diff: not run (no --sass-parent checkout)",
              flush=True)
    p = ct.CVParams()
    for line in band_checks(dev, p, u4k, v4k, {**stats, **sh_stats}):
        print(f"phase 27 {line}", flush=True)
    band_times(dev, card, p, u4k, v4k, stats, sh_stats)
    band_runs(dev, card, u4k, gt4k, v4k, gtc4k)
    return bool(sass_parent)


# K9's band body (phase 28): the whole-image and shard-canvas wrappers
# (phases 9 and 21 hold them against their plain versions); the ragged
# even shape of the whole-image check (its last tiles partial)
MP2_BAND_RAGGED = (1000, 1152)


def mp2_same(tag, got, again):
    """The band body's second launch bitwise its first."""
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"K9 band body {tag}: two launches differ")


def mp2_band_checks(dev, pm):
    """Phase 28's checks: the band body's second launches at 4K and the
    ragged shape, on every shard of the 2x2 and 3x3 grids at D = 4, and
    over MP_CHAIN_KS launches chained on the 8k-deep canvases (after every
    launch), bitwise its first."""
    mk = multiphase_kernel
    lines = []
    for h, w in ((H4K, W4K), MP2_BAND_RAGGED):
        u, phis, cs, _ = mp2_inputs(h, w, dev, pm)
        got, again = mk.mp2_iteration(phis, u, cs, pm), \
            mk.mp2_iteration(phis, u, cs, pm)
        torch.cuda.synchronize()
        mp2_same(f"{h}x{w}", got, again)
    lines.append(f"K9 mp2_iteration 4K and {MP2_BAND_RAGGED[0]}x"
                 f"{MP2_BAND_RAGGED[1]}: second launch bitwise")
    u, phis, cs, _ = mp2_inputs(H4K, W4K, dev, pm)
    for nx, ny in SHARD_GRIDS:
        n = 0
        for D, k in ((4, 1),) + tuple((8 * k, k) for k in MP_CHAIN_KS):
            for pos, x, uc, par, edges, crop in mp_canvases(phis, u, nx, ny,
                                                            D, dev):
                new = x
                for i in range(k):
                    args = (new, uc, cs, pm, par, edges, crop)
                    got, again = mk.mp2_iteration_sharded(*args), \
                        mk.mp2_iteration_sharded(*args)
                    torch.cuda.synchronize()
                    mp2_same(f"shard {pos} of {nx}x{ny} D={D} launch {i + 1}",
                             got, again)
                    new = got[0]
                    n += 1
        lines.append(f"K9 mp2_iteration_sharded every shard of {nx}x{ny} at "
                     f"D=4 and {MP_CHAIN_KS} launches chained on 8k-deep "
                     f"canvases ({n} launches): second launches bitwise")
    return lines


def mp2_band_times(dev, card, pm, st9, st9s):
    """Phase 28's times: the band body twice (queued) at 4K and on the 2x2
    canvas of shard (0, 0), beside the bound, the tiling, the card's
    blocks per SM and the waves."""
    mk = multiphase_kernel
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    u, phis, cs, _ = mp2_inputs(H4K, W4K, dev, pm)
    (_, x, uc, par, edges, crop), = [
        c for c in mp_canvases(phis, u, 2, 2, 4, dev) if c[0] == (0, 0)]
    sh = _cuda.shard_args(*uc.shape, 1, par, crop, edges)
    cases = {"4K": ("K9 mp2_iteration", (phis, u, cs, pm), None,
                    (H4K, W4K), st9),
             "2x2 canvas": ("K9 mp2_iteration_sharded",
                            (x, uc, cs, pm, par, edges, crop), sh,
                            (crop[1] - crop[0], crop[3] - crop[2]), st9s)}
    out = []
    for tag, (name, args, shard, (h, w), st) in cases.items():
        wrapper = (mk.mp2_iteration if shard is None
                   else mk.mp2_iteration_sharded)
        ua = args[1]
        t = [queued_ms(lambda: wrapper(*args), 20) for _ in range(2)]
        geo, nblocks = _cuda.mp2_plan(*ua.shape, shard, sms)
        th, tw, fold, px, py, cap = geo
        threads = -(-px * py // 32) * 32
        occ = _cuda.mp2_occupancy(shard is not None, threads, cap)
        b_ms, b_by = bound_mp2(h, w, 1, 1, False)
        ms = sum(t) / 2
        st.update(ms=ms, bound_ms=b_ms, bound_by=b_by)
        out.append(f"{name} {tag}: {t[0]:.4f}, {t[1]:.4f} ms (bound "
                   f"{b_ms:.4f} {b_by}); tile {th}x{tw} fold {fold}, "
                   f"{threads} threads, window <= {cap} cells "
                   f"({_cuda.MP2_BAND_CELL_BYTES * cap} B), {occ} blocks/SM, "
                   f"{nblocks} blocks = {nblocks / (occ * sms):.2f} waves")
    print("phase 28 K9 band body (queued device ms a launch, two runs): "
          + "; ".join(out) + f" [{card}]", flush=True)


def mp2_band_rates(dev, card, pm):
    """Phase 28's runs through the entry points: phase 23's three 4-phase
    runs at 4K (unsharded fixed, 2x2 comm_k 1 and 8), their K9 launches
    counted (the counts set to 0 just before each), then their rates, two
    runs each."""
    mk = multiphase_kernel
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    u = torch.from_numpy(four_regions(H4K, W4K)[0]).to(dev)
    its = MP_SHARD_ITERS
    runs = {
        "unsharded segment_multiphase(fixed)": (lambda: ct.segment_multiphase(
            u, pm, fixed=True, max_iter=its), {"mp2_iteration": its}),
        "2x2 comm_k=1": (lambda: segment_multiphase_sharded(
            u, pm, mesh, max_iter=its, fixed=True),
            {"mp2_iteration_sharded": 4 * its}),
        "2x2 comm_k=8": (lambda: segment_multiphase_sharded(
            u, pm, mesh, max_iter=its, fixed=True, comm_k=SHARD_K),
            {"mp2_iteration_sharded": 4 * its}),
    }
    counted = {}
    for tag, (fn, want) in runs.items():
        mk.mp2_iteration.launches = mk.mp2_iteration_sharded.launches = 0
        res = fn()
        torch.cuda.synchronize()
        have = {n: getattr(mk, n).launches for n in
                ("mp2_iteration", "mp2_iteration_sharded")
                if getattr(mk, n).launches}
        if have != want:
            raise AssertionError(f"phase 28 {tag} launched {have}, expected "
                                 f"{want}")
        if not torch.isfinite(res.phis).all():
            raise AssertionError(f"phase 28 {tag}: the band body's run is "
                                 f"not finite")
        counted[tag] = have
    rates = {}
    for tag, (fn, _) in runs.items():
        t = [time_ms(fn, 1) for _ in range(2)]
        rates[tag] = [H4K * W4K * its / (ms * 1e3) for ms in t]
    print("phase 28 4-phase runs through the band body: "
          + "; ".join(f"{t} launches {c}" for t, c in counted.items())
          + "; rates at 4K (Mpixel-iters/s, the whole run of "
          f"{its} iterations; two runs): "
          + "; ".join(f"{t} " + ", ".join(f"{r:.1f}" for r in rs)
                      for t, rs in rates.items()) + f" [{card}]", flush=True)


def mp2_band_phase(dev, card, st9, st9s):
    """Phase 28: K9's band body. Registers, spills and blocks an SM, then
    the checks, the times and the runs."""
    regs = [x for x in ptxas_summary().split(", ")
            if x.startswith("mp2_coupled")]
    print("phase 28 K9 ptxas: " + ", ".join(regs), flush=True)
    pm = ct.CVParams(mu=MU_MP, max_iter=500)
    for line in mp2_band_checks(dev, pm):
        print(f"phase 28 {line}", flush=True)
    mp2_band_times(dev, card, pm, st9, st9s)
    mp2_band_rates(dev, card, pm)


# the single-sweep body (phase 29): K1's whole-image, force (with and
# without a parity), batch and shard-canvas modes and K4 on csrc/sweep.cuh;
# the ragged even shape of the checks (its last tiles partial, inside the
# fused envelope), the frames of the ragged batch check, and the
# iterations of phase 29's runs through the entry points
SWEEP_RAGGED, SWEEP_RAGGED_FRAMES, SWEEP_ITERS = (1000, 1408), 3, 100


def sweep_same(tag, got, again):
    """The single-sweep body's second launch bitwise its first."""
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"{tag}: two launches differ")


def sweep_checks(dev, p, u4k, v4k):
    """Phase 29's checks: every mode of the single-sweep body against its
    plain version (phase 3's bars; the force mode's last three sums) and
    its second launch,
    at 512^2, 4K gray and RGB, 16 x 1080p, the ragged shape and every shard
    of the 2x2 and 3x3 grids (each crop bitwise the whole-image launch);
    each batch frame bitwise its own single-image launch."""
    fk, fm = fused_kernel, fused_kernel_mc
    lines = []
    img, _ = two_disks(*SWEEP_RAGGED)
    rgb, _ = colored_squares(*SWEEP_RAGGED)
    ur = torch.from_numpy(img).to(dev)
    vr = torch.from_numpy(rgb).to(dev).permute(2, 0, 1).contiguous()
    u512 = torch.from_numpy(two_disks(512, 512)[0]).to(dev)
    v512 = torch.from_numpy(colored_squares(512, 512)[0]).to(dev)
    v4cf = v4k.permute(2, 0, 1).contiguous()
    gray = {"512^2": u512, "4K": u4k,
            f"{SWEEP_RAGGED[0]}x{SWEEP_RAGGED[1]}": ur}
    color = {"512^2": v512.permute(2, 0, 1).contiguous(), "4K": v4cf,
             f"{SWEEP_RAGGED[0]}x{SWEEP_RAGGED[1]}": vr}
    err = {}
    for tag, u in gray.items():
        phi, _, c1, c2 = chunk_inputs(u, p)
        args = (phi, u, c1, c2, p)
        got, again = fk.fused_iteration(*args), fk.fused_iteration(*args)
        sweep_same(f"K1 whole {tag}", got, again)
        err["K1 fused_iteration"] = max(err.get("K1 fused_iteration", 0.0),
                                        hold("K1 fused_iteration", got,
                                             fk.fused_iteration_reference(
                                                 *args), tag))
        f = data_term_f(u, c1, c2, p)
        for par in (None, 1):
            got = fk.fused_sweep(phi, f, p, par)
            again = fk.fused_sweep(phi, f, p, par)
            name = "K1 force" + ("" if par is None else " parity")
            sweep_same(f"{name} {tag}", got, again)
            ref = fk.fused_sweep_reference(phi, f, p, par)
            hold(name, (got[0], got[1][2:]), (ref[0], ref[1][2:]), tag)
    lines.append(f"K1 whole image and force mode (parity none and 1) at "
                 f"{', '.join(gray)}: second launches bitwise, phase 3's "
                 f"bars against the plain versions")
    for tag, u in color.items():
        phi = init_phi(tuple(u.shape[1:]), p.init, torch.float32, device=dev)
        c1, c2 = region_means(u.permute(1, 2, 0), phi, p.eps)
        for lam in ({}, LAMBDAS):
            args = (phi, u, c1, c2, p)
            got, again = fm.fused_iteration_mc(*args, **lam), \
                fm.fused_iteration_mc(*args, **lam)
            sweep_same(f"K4 {tag}", got, again)
            err["K4 fused_iteration_mc"] = max(
                err.get("K4 fused_iteration_mc", 0.0),
                hold("K4 fused_iteration_mc", got,
                     fm.fused_iteration_mc_reference(*args, **lam), tag))
    lines.append(f"K4 at {', '.join(color)} (default and per-channel "
                 f"lambdas): second launches bitwise, phase 3's bars against "
                 f"the plain version")
    for n, (h, w) in ((VIDEO_FRAMES, (1080, 1920)),
                      (SWEEP_RAGGED_FRAMES, SWEEP_RAGGED)):
        u, _ = frame_stack(n, h, w, dev)
        phi, _, _, _ = chunk_inputs(u[0], p)
        phis = phi.expand(n, h, w).contiguous()
        means = [region_means(fr, phi, p.eps) for fr in u]
        c1 = torch.stack([m[0] for m in means])
        c2 = torch.stack([m[1] for m in means])
        args = (phis, u, c1, c2, p)
        got = fk.fused_iteration_batch(*args)
        again = fk.fused_iteration_batch(*args)
        single = [fk.fused_iteration(phis[i], u[i], c1[i], c2[i], p)
                  for i in range(n)]
        sweep_same(f"K1 batch {n}x{h}x{w}", got, again)
        if not all(torch.equal(got[0][i], o[0]) and torch.equal(got[1][i],
                                                                o[1])
                   for i, o in enumerate(single)):
            raise AssertionError(f"K1 batch {n}x{h}x{w}: a frame differs "
                                 f"from its single-image launch")
    lines.append(f"K1 batch {VIDEO_FRAMES}x1080x1920 and "
                 f"{SWEEP_RAGGED_FRAMES}x{SWEEP_RAGGED[0]}x{SWEEP_RAGGED[1]}: "
                 f"every frame bitwise its own single-image launch (phi and "
                 f"partials), second launches bitwise")
    phi, _, c1, c2 = chunk_inputs(u4k, p)
    whole = fk.fused_iteration(phi, u4k, c1, c2, p)[0]
    n = 0
    for nx, ny in SHARD_GRIDS:
        h, w = H4K // nx, W4K // ny
        for pos, x, uc, par, edges, crop in shard_canvases(phi, u4k, nx, ny,
                                                           4, dev):
            args = (x, uc, c1, c2, p, par, crop, edges)
            got = fk.fused_iteration(*args)
            again = fk.fused_iteration(*args)
            tag = f"K1 shard {pos} of {nx}x{ny}"
            sweep_same(tag, got, again)
            ix, iy = pos
            if not torch.equal(got[0][4:4 + h, 4:4 + w],
                               whole[ix * h:(ix + 1) * h,
                                     iy * w:(iy + 1) * w]):
                raise AssertionError(f"{tag}: the crop differs from the "
                                     f"whole-image launch")
            n += 1
    lines.append(f"K1 shard every shard of 2x2 and 3x3 at D=4 ({n} canvases): "
                 f"each crop bitwise the whole-image launch's, second "
                 f"launches bitwise")
    return lines, err


def data_term_f(u, c1, c2, p):
    """The gray force f of image u and means c1, c2 (fused_sweep's input)."""
    d1, d2 = u - c1, u - c2
    return -p.nu - p.lambda1 * d1 * d1 + p.lambda2 * d2 * d2


def sweep_times(dev, card, p, u4k, v4k, stats):
    """Phase 29's times: the single-sweep body twice (queued) at the main
    path's shapes, beside the bound, the tiling, the card's blocks per SM
    and the waves. Fills the kernels' stats (``stats``: name -> its
    dict)."""
    fk, fm = fused_kernel, fused_kernel_mc
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    u512 = torch.from_numpy(two_disks(512, 512)[0]).to(dev)
    phi512, _, c1s, c2s = chunk_inputs(u512, p)
    f512 = data_term_f(u512, c1s, c2s, p)
    phi, _, c1, c2 = chunk_inputs(u4k, p)
    f4k = data_term_f(u4k, c1, c2, p)
    v4cf = v4k.permute(2, 0, 1).contiguous()
    cv1, cv2 = region_means(v4k, phi, p.eps)
    video, _ = frame_stack(VIDEO_FRAMES, 1080, 1920, dev)
    vphi = phi[:1080, :1920].contiguous().expand(VIDEO_FRAMES, 1080,
                                                1920).contiguous()
    vm = [region_means(fr, vphi[0], p.eps) for fr in video]
    vc1, vc2 = (torch.stack([m[i] for m in vm]) for i in (0, 1))
    (_, x, uc, par, edges, crop), = [
        s for s in shard_canvases(phi, u4k, 2, 2, 4, dev) if s[0] == (0, 0)]
    cases = [  # the stats entry it times (None: reported only), tag,
        #        wrapper call, (h, w, frames, crop, c), force, bound
        (None, "force 512^2",
         lambda: fk.fused_sweep(phi512, f512, p),
         (512, 512, 1, None, 0), True, bound_sweep(512, 512)),
        ("K1 fused_sweep", "force 4K",
         lambda: fk.fused_sweep(phi, f4k, p),
         (H4K, W4K, 1, None, 0), True, bound_sweep(H4K, W4K)),
        ("K1 fused_iteration", "whole 4K",
         lambda: fk.fused_iteration(phi, u4k, c1, c2, p),
         (H4K, W4K, 1, None, 0), False, bound(H4K, W4K, 1, 0)),
        ("K1 fused_sweep (parity)", "force + parity 4K",
         lambda: fk.fused_sweep(phi, f4k, p, 1),
         (H4K, W4K, 1, (0, H4K, 0, W4K), 0), True, bound_sweep(H4K, W4K)),
        ("K1 fused_iteration_batch", "batch 16x1080p",
         lambda: fk.fused_iteration_batch(vphi, video, vc1, vc2, p),
         (1080, 1920, VIDEO_FRAMES, None, 0), False,
         bound(1080, 1920, 1, 0, frames=VIDEO_FRAMES)),
        ("K1 fused_iteration (shard)", "shard 2x2 canvas",
         lambda: fk.fused_iteration(x, uc, c1, c2, p, par, crop, edges),
         (*x.shape, 1, crop, 0), False,
         bound(crop[1] - crop[0], crop[3] - crop[2], 1, 0)),
        ("K4 fused_iteration_mc", "4K RGB",
         lambda: fm.fused_iteration_mc(phi, v4cf, cv1, cv2, p),
         (H4K, W4K, 1, None, RGB), False, bound(H4K, W4K, 1, RGB)),
    ]
    out, queued = [], {}
    for name, tag, new, (h, w, n, cr, c), force, (b_ms, b_by) in cases:
        t = [queued_ms(new, 20) for _ in range(2)]
        geo = _cuda.sweep_geometry(h, w, cr)
        th, tw, px, py, cap = geo
        threads = -(-px * py // 32) * 32
        occ = _cuda.sweep_occupancy(c, cr is not None, threads, cap, force)
        th_all, tw_all = (h, w) if cr is None else (cr[1] - cr[0],
                                                    cr[3] - cr[2])
        nblocks = n * math.ceil(th_all / th) * math.ceil(tw_all / tw)
        ms = sum(t) / 2
        if name is not None:
            stats[name].update(ms=ms, bound_ms=b_ms, bound_by=b_by)
        queued[name or "K1 fused_sweep 512^2"] = ms
        out.append(f"{name or 'K1 fused_sweep'} {tag}: {t[0]:.4f}, "
                   f"{t[1]:.4f} ms (bound {b_ms:.4f} {b_by}, ms/bound "
                   f"{ms / b_ms:.2f}); "
                   f"tile {th}x{tw}, {threads} threads, window <= {cap} "
                   f"cells ({_cuda.sweep_cell_bytes(c) * cap} B), {occ} "
                   f"blocks/SM, {nblocks} blocks = "
                   f"{nblocks / (occ * sms):.2f} waves")
    print("phase 29 single-sweep body (queued device ms a launch, two "
          "runs): " + "; ".join(out) + f" [{card}]", flush=True)
    # the host's side of a launch: 512^2 force-mode calls back to back (a
    # launch's device time is a third of the host's)
    pace = [host_pace_us(lambda: fk.fused_sweep(phi512, f512, p), 500)
            for _ in range(2)]
    print(f"phase 29 host's pace of K1's force mode at 512^2 (us a call, "
          f"calls back to back; two runs): "
          + ", ".join(f"{t:.2f}" for t in pace) + f" [{card}]", flush=True)
    return queued


def host_pace_us(fn, n):
    """Mean wall time of n back-to-back calls of fn, in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _mask(res):
    return res.mask if hasattr(res, "mask") else res[1]


def sweep_runs(dev, card, u4k, gt4k, v4k, gtc4k, queued):
    """Phase 29's runs through the entry points, each with its K1/K4
    launches counted (the counts set to 0 just before it) and its masks
    against the truth (the sweeps route: its level sets finite), then
    their rates (two runs) and the share of each run that its launches'
    queued time (``queued``: ms a launch by kernel name, at the run's
    shape) accounts for: the rest is the host's."""
    fk, fm = fused_kernel, fused_kernel_mc
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    pv = ct.CVParams(mu=0.0001 * 255.0 ** 2, max_iter=500)
    pm = ct.CVParams(mu=MU_MP, max_iter=500)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    video, vgts = frame_stack(VIDEO_FRAMES, 1080, 1920, dev)
    u512, gt512 = four_regions(512, 512)
    u512 = torch.from_numpy(u512).to(dev)
    its = SWEEP_ITERS
    counters = {"fused_iteration": (fk.fused_iteration, "launches"),
                "fused_iteration shard": (fk.fused_iteration,
                                          "shard_launches"),
                "fused_sweep": (fk.fused_sweep, "launches"),
                "fused_iteration_batch": (fk.fused_iteration_batch,
                                          "launches"),
                "fused_iteration_mc": (fm.fused_iteration_mc, "launches")}
    runs = {  # run, pixels an iteration, launches, the truth, the kernel
        # whose queued ms (phase 29's times) each launch takes
        f"segment_stack_fused_fixed {VIDEO_FRAMES}x1080p": (
            lambda: batchedm.segment_stack_fused_fixed(video, pt, its),
            video.numel(), {"fused_iteration_batch": its}, vgts,
            "K1 fused_iteration_batch"),
        "segment_fused_fixed 4K gray": (
            lambda: ct.segment_fused_fixed(u4k, pt, its), H4K * W4K,
            {"fused_iteration": its}, [gt4k], "K1 fused_iteration"),
        "segment_fused_fixed 4K RGB": (
            lambda: ct.segment_fused_fixed(v4k, pv, its), H4K * W4K,
            {"fused_iteration_mc": its}, [gtc4k], "K4 fused_iteration_mc"),
        "segment_multiphase sweeps 512^2 M=3": (
            lambda: ct.segment_multiphase(u512, pm, m_sets=3, fixed=True,
                                          max_iter=its, use_pallas=True),
            512 * 512, {"fused_sweep": 3 * its}, None,
            "K1 fused_sweep 512^2"),
        "segment_sharded 2x2 comm_k=1": (
            lambda: segment_sharded(u4k, pt, mesh, fixed=True,
                                    max_iter=its), H4K * W4K,
            {"fused_iteration shard": 4 * its}, [gt4k],
            "K1 fused_iteration (shard)"),
    }
    lines = []
    for tag, (fn, _, want, truths, _) in runs.items():
        for f, attr in counters.values():
            setattr(f, attr, 0)
        res = fn()
        torch.cuda.synchronize()
        have = {n: getattr(f, a) for n, (f, a) in counters.items()
                if getattr(f, a)}
        if have != want:
            raise AssertionError(f"phase 29 {tag} launched {have}, expected "
                                 f"{want}")
        if truths is None:
            if not torch.isfinite(res.phis).all():
                raise AssertionError(f"phase 29 {tag}: the level sets are "
                                     f"not finite")
            lines.append(f"{tag} launches {have}, level sets finite")
        else:
            new_m = _mask(res).cpu()
            new_m = new_m.reshape(-1, *new_m.shape[-2:])
            truth = min(iou_phases(m, g) for m, g in zip(new_m, truths))
            lines.append(f"{tag} launches {have}, IoU with the truth "
                         f"{truth:.6f}")
    print("phase 29 runs through the single-sweep body: " + "; ".join(lines),
          flush=True)
    rates = []
    for tag, (fn, pix, want, _, kern) in runs.items():
        t = [time_ms(fn, 1) for _ in range(2)]
        r = [pix * its / (ms * 1e3) for ms in t]
        new_ms = sum(t) / 2
        share = sum(want.values()) * queued[kern] / new_ms
        rates.append(f"{tag} {its} iterations " + ", ".join(
            f"{x:.1f}" for x in r) + f" ({new_ms / its:.4f} ms an "
            f"iteration, its launches' queued time {share:.1%} of it)")
    print("phase 29 rates (Mpixel-iters/s, the whole run; two runs): "
          + "; ".join(rates) + f" [{card}]", flush=True)


def sweep_phase(dev, card, u4k, gt4k, v4k, gtc4k, stats):
    """Phase 29: the single-sweep body. Registers, spills and blocks an
    SM, then the checks, the times and the runs.
    ``stats``: the K1 and K4 entries' stats dicts by name."""
    regs = [s for s in ptxas_summary().split(", ")
            if s.startswith("sweep")]
    # the card's blocks an SM of every instantiation at the 4K tile (the
    # shard-canvas ones at the 2x2 canvas's)
    geo = _cuda.sweep_geometry(H4K, W4K)
    sgeo = _cuda.sweep_geometry(1088, 1928, (4, 1084, 4, 1924))
    cases = [("K1", 0, False, False, geo), ("K1 shard", 0, True, False, sgeo),
             ("force", 0, False, True, geo),
             ("force + parity", 0, True, True, sgeo)] + [
                 (f"K4 C={c}", c, False, False, geo)
                 for c in range(1, _cuda.MAX_CHANNELS + 1)]
    occ = []
    for tag, c, shard, force, (_, _, px, py, cap) in cases:
        threads = -(-px * py // 32) * 32
        n = _cuda.sweep_occupancy(c, shard, threads, cap, force)
        occ.append(f"{tag} {n}")
    print("phase 29 single-sweep body ptxas: " + ", ".join(regs)
          + "; blocks an SM: " + ", ".join(occ), flush=True)
    p = ct.CVParams()
    lines, err = sweep_checks(dev, p, u4k, v4k)
    for line in lines:
        print(f"phase 29 {line}", flush=True)
    for name, e in err.items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], e)
    queued = sweep_times(dev, card, p, u4k, v4k, stats)
    sweep_runs(dev, card, u4k, gt4k, v4k, gtc4k, queued)


# the bit body (phase 30): K11's five kinds and K12 on csrc/morph_bits.cuh;
# each entry: the stats entry it times, its kind, and whether it runs on a
# shard block (the 2x2 grid's shard (0, 0) at the driver's D)
MORPH_BITS = {
    "K11 morph_chunk": ("acwe", False),
    "K11 gac_chunk": ("gac", False),
    "K11 gac_chunk pre_dg": ("gac_pre", False),
    "K12 morph_chunk_fused": ("acwe_fused", False),
    "K11 morph_chunk_shard (acwe_sh)": ("acwe_sh", True),
    "K11 gac_chunk_shard (gac_pre_sh)": ("gac_pre_sh", True),
}


def morph_bits_same(tag, new, again):
    """The bit body's second launch (the level set and K12's partials)
    bitwise its first."""
    (g, gp), (a, ap) = new, again
    if not torch.equal(g, a) or (gp is not None and not torch.equal(gp, ap)):
        raise AssertionError(f"{tag}: two launches differ")


def morph_bits_checks(dev, p):
    """Phase 30's checks: every whole-image kind's second launch and a
    launch on a second stream bitwise its first at phase 12's shapes and
    runs (4K, 1080p, 1000x1500); the shard kinds' second launches on every
    shard of the 2x2 and 3x3 grids (phases 12 and 21 hold the same
    launches against the plain versions and the crops against the whole
    image)."""
    lines = []
    side = torch.cuda.Stream()
    for h, w in MORPH_SHAPES:
        inp = morph_inputs(dev, p, h, w)
        n = 0
        for name, m in MORPH.items():
            for run in MORPH_RUNS[m["kind"]]:
                call = morph_call(m["kind"], inp, run)
                new, again = call(False), call(False)
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    other = call(False)
                torch.cuda.current_stream().wait_stream(side)
                torch.cuda.synchronize()
                tag = f"phase 30 {name} {run} at {h}x{w}"
                morph_bits_same(tag, new, again)
                morph_bits_same(tag + " (second stream)", other, new)
                n += 1
        lines.append(f"{h}x{w}: {n} launches of the four whole-image kinds "
                     f"bitwise their second launches and launches on a "
                     f"second stream")
    ls, fm, g = morph_shard_inputs(dev, p)
    k = MORPH_SHARD_K
    for gac in (False, True):
        D = morph_kernel._reach("gac" if gac else "acwe", 1) * k
        call = morph_shard_call(gac, k, D)
        for nx, ny in SHARD_GRIDS:
            for pos, x, a, e in morph_blocks(ls, g if gac else fm, nx, ny, D,
                                             dev, gac):
                new, again = (call(x, a, e), None), (call(x, a, e), None)
                torch.cuda.synchronize()
                morph_bits_same(f"phase 30 {'gac_pre_sh' if gac else 'acwe_sh'}"
                                f" shard {pos} of {nx}x{ny}", new, again)
            lines.append(f"{'gac_pre_sh' if gac else 'acwe_sh'} k={k} D={D} "
                         f"{nx}x{ny}: every block bitwise its second launch")
    return lines


def morph_bits_times(dev, card, p, stats):
    """Phase 30's times: the bit body twice (queued) at 4K (phase 12's
    timed runs) and on the 2x2 grid's shard (0, 0) block, beside the bound,
    the tiling, the card's blocks an SM and the waves. Fills the kernels'
    stats (``stats``: name -> its dict); returns ms a launch by name."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    inp = morph_inputs(dev, p, H4K, W4K)
    ls, fm, g = morph_shard_inputs(dev, p)
    k = MORPH_SHARD_K
    out, queued = [], {}
    for name, (kind, shard) in MORPH_BITS.items():
        if shard:
            gac = kind == "gac_pre_sh"
            D = morph_kernel._reach(kind, 1) * k
            (_, x, a, e), = [b for b in morph_blocks(
                ls, g if gac else fm, 2, 2, D, dev, gac) if b[0] == (0, 0)]
            call = morph_shard_call(gac, k, D)

            def fn(c=call, x=x, a=a, e=e):
                return c(x, a, e)
            h, w = x.shape
            crop = (D, h - D, D, w - D)
            halo, run = D, (k, 1, 0, 1 if gac else 0)
            b_ms, b_by = bound_morph("gac_pre" if gac else "acwe", h - 2 * D,
                                     w - 2 * D, k, 1, run[3])
        else:
            run = MORPH_RUNS[kind][0]
            c = morph_call(kind, inp, run)

            def fn(c=c):
                return c(False)
            h, w, crop = H4K, W4K, None
            halo = morph_kernel._reach(kind, run[1]) * run[0]
            b_ms, b_by = bound_morph(kind, h, w, *run[:2],
                                     run[3] if len(run) > 3 else 0)
        t = [queued_ms(fn, 20) for _ in range(2)]
        th, tw, ww, cap, nblocks = _cuda.morph_geometry(kind, h, w, halo,
                                                        crop)
        occ = _cuda.morph_occupancy(kind, cap)
        ms = sum(t) / 2
        stats[name].update(ms=ms, bound_ms=b_ms, bound_by=b_by)
        queued[name] = ms
        out.append(f"{name} {run} at {h}x{w}: {t[0]:.4f}, {t[1]:.4f} ms "
                   f"(bound {b_ms:.4f} {b_by}, ms/bound {ms / b_ms:.2f}); "
                   f"tile {th}x{tw}, windows <= {ww} words "
                   f"x {cap // ww} rows ({4 * _cuda.MORPH_WORDS[kind] * cap} "
                   f"B), {occ} blocks/SM, {nblocks} blocks = "
                   f"{nblocks / (occ * sms):.2f} waves")
    print("phase 30 bit body (queued device ms a launch, two runs): "
          + "; ".join(out) + f" [{card}]", flush=True)
    return queued


def morph_bits_runs(dev, card, queued):
    """Phase 30's runs through the entry points, each with its K11/K12
    launches counted (the counts set to 0 just before it), then their
    rates (two runs) and the share of each run that its launches' queued
    time (``queued``) accounts for: the rest is the driver's (the means and
    the force plane, the exchange)."""
    p = ct.CVParams()
    mk = morph_kernel
    img4k, _ = two_disks(H4K, W4K)
    u4k = torch.from_numpy(img4k).to(dev)
    v4k = torch.from_numpy(np.stack(
        [img4k, 0.5 * img4k + 30.0, 255.0 - img4k], axis=-1)).to(dev)
    gimg4k, _, seed4k = gac_scene(H4K, W4K)
    g4k = inverse_gaussian_gradient(
        torch.from_numpy(gimg4k).to(dev), 5.0, 2.0)
    s4k = torch.from_numpy(seed4k).to(dev)
    gimg1k, _, seed1k = gac_scene(*COMPAT_SHAPE)
    g1k = compat.inverse_gaussian_gradient(gimg1k, 5.0, 2.0, device=dev)
    gkw = dict(balloon=-1, threshold=GAC_THRESHOLD)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    its = MORPH_BITS_ITERS
    counters = {"K11 morph_chunk": (mk.morph_chunk, "launches"),
                "K11 gac_chunk": (mk.gac_chunk, "launches"),
                "K12 morph_chunk_fused": (mk.morph_chunk_fused, "launches"),
                "K11 morph_chunk_shard (acwe_sh)": (mk.morph_chunk_shard,
                                                    "launches"),
                "K11 gac_chunk_shard (gac_pre_sh)": (mk.gac_chunk_shard,
                                                     "launches")}
    kinds = {"gac": "K11 gac_chunk", "gac_pre": "K11 gac_chunk pre_dg"}
    runs = {  # run, pixels an iteration
        "segment_morph 4K gray": (lambda: ct.segment_morph(u4k, p),
                                  H4K * W4K),
        "segment_morph 4K RGB": (lambda: ct.segment_morph(v4k, p),
                                 H4K * W4K),
        f"segment_morph_iterations 4K gray {its}": (
            lambda: ct.segment_morph_iterations(u4k, p, iters=its),
            H4K * W4K),
        f"segment_morph_iterations 4K RGB {its}": (
            lambda: ct.segment_morph_iterations(v4k, p, iters=its),
            H4K * W4K),
        f"segment_morph_iterations fuse_force 4K {its}": (
            lambda: ct.segment_morph_iterations(u4k, p, iters=its,
                                                fuse_force=True), H4K * W4K),
        "segment_gac 4K": (lambda: ct.segment_gac(g4k, p, ls0=s4k, **gkw),
                           H4K * W4K),
        f"segment_gac_iterations 4K {its}": (
            lambda: ct.segment_gac_iterations(g4k, p, iters=its, ls0=s4k,
                                              **gkw), H4K * W4K),
        f"segment_gac_iterations pre_dg=False 4K {its}": (
            lambda: ct.segment_gac_iterations(g4k, p, iters=its, ls0=s4k,
                                              pre_dg=False, **gkw),
            H4K * W4K),
        "compat GAC 1080p 80": (
            lambda: compat.morphological_geodesic_active_contour(
                g1k, 80, init_level_set=seed1k, device=dev, **gkw),
            COMPAT_SHAPE[0] * COMPAT_SHAPE[1]),
        "segment_morph_sharded_chunked 2x2 comm_k=8": (
            lambda: segment_morph_sharded_chunked(u4k, p, mesh=mesh,
                                                  comm_k=MORPH_SHARD_K),
            H4K * W4K),
        "segment_gac_sharded_chunked 2x2 comm_k=8": (
            lambda: segment_gac_sharded_chunked(g4k, p, mesh=mesh, ls0=s4k,
                                                comm_k=MORPH_SHARD_K, **gkw),
            H4K * W4K),
    }

    def count():
        have = {n: getattr(f, a) for n, (f, a) in counters.items()
                if getattr(f, a)}
        if "K11 gac_chunk" in have:
            del have["K11 gac_chunk"]
            have.update({kinds[kd]: v for kd, v in
                         mk.gac_chunk.kind_launches.items() if v})
        return have

    lines, done = [], {}
    for tag, (fn, _) in runs.items():
        for f, a in counters.values():
            setattr(f, a, 0)
        mk.gac_chunk.kind_launches = {"gac": 0, "gac_pre": 0}
        res = fn()
        torch.cuda.synchronize()
        have = count()
        iters = ("" if tag.startswith("compat")
                 else f"{res.iters} iterations, ")
        if not have:
            raise AssertionError(f"phase 30 {tag}: no K11/K12 launch")
        done[tag] = (have, res)
        lines.append(f"{tag} {iters}launches {have}")
    print("phase 30 runs through the bit body: " + "; ".join(lines),
          flush=True)
    rates = []
    for tag, (fn, pix) in runs.items():
        have, res = done[tag]
        n = res.iters if hasattr(res, "iters") else 80
        t = [time_ms(fn, 1) for _ in range(2)]
        r = [pix * n / (ms * 1e3) for ms in t]
        new_ms = sum(t) / 2
        share = ""
        if pix == H4K * W4K:  # the queued times are 4K's (the 2x2 block's)
            kern = sum(c * queued[name] for name, c in have.items())
            share = (f", its launches' queued time {kern / new_ms:.1%} of "
                     f"it")
        rates.append(f"{tag} ({n} iterations) " + ", ".join(
            f"{x:.1f}" for x in r) + f" ({new_ms:.3f} ms{share})")
    print("phase 30 rates (Mpixel-iters/s, the whole run; two runs): "
          + "; ".join(rates) + f" [{card}]", flush=True)


def morph_bits_phase(dev, card, mo_stats, ms_stats, sass_checked):
    """Phase 30: the bit body of K11 and K12. Registers, spills and blocks
    an SM, then the checks, the times and the runs."""
    regs = [s for s in ptxas_summary().split(", ")
            if s.startswith("morph_bits")]
    occ = []
    for name, (kind, shard) in MORPH_BITS.items():
        if shard:
            D = morph_kernel._reach(kind, 1) * MORPH_SHARD_K
            h, w = H4K // 2 + 2 * D, W4K // 2 + 2 * D
            geo = _cuda.morph_geometry(kind, h, w, D, (D, h - D, D, w - D))
        else:
            run = MORPH_RUNS[kind][0]
            geo = _cuda.morph_geometry(
                kind, H4K, W4K, morph_kernel._reach(kind, run[1]) * run[0])
        occ.append(f"{kind} {_cuda.morph_occupancy(kind, geo[3])}")
    print("phase 30 bit body ptxas: " + ", ".join(regs) + "; blocks an SM "
          "(4K, the 2x2 shard block): " + ", ".join(occ) + "; phase 27's "
          "sass_diff check: "
          + ("passed" if sass_checked else "not run (no --sass-parent)"),
          flush=True)
    p = ct.CVParams()
    for line in morph_bits_checks(dev, p):
        print(f"phase 30 {line}", flush=True)
    stats = {**mo_stats, **ms_stats}
    queued = morph_bits_times(dev, card, p, stats)
    morph_bits_runs(dev, card, queued)


# the tile bodies of K7-K10 (phase 31): the main path's shapes each mode is
# timed at (h, w, channels or frames), 1000 iterations a launch as phase 8
RES_TILE_TIMED = {
    "K8 packed_resident_iterations": ((256, 256), (1024, 1024)),
    "K8 packed_resident_iterations_mc": ((512, 512),),
    "K8 packed_resident_iterations_batch": ((256, 256),),
    "K7 resident_iterations": ((1024, 896),),
    "K7 resident_iterations_mc": ((512, 384),),
    "K7 resident_iterations_batch": ((256, 384),),
}
MP2_TILE_TIMED = {"K10 packed_mp2_resident_iterations": ((512, 512),),
                  "K9 mp2_resident_iterations": ((1024, 1024), (512, 384))}
# 4-phase shapes of the checks: phase 9's and the main path's
MP2_TILE_SHAPES = {"K10 packed_mp2_resident_iterations": ((256, 256),
                                                          (512, 512)),
                   "K9 mp2_resident_iterations": ((1024, 1024), (512, 384),
                                                  (512, 512))}
TILE_FRAMES = 4


def tile_runs(call):
    """(launch, second launch, a launch on a second stream) of ``call``,
    each (level sets, partials)."""
    new, again = call(), call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return new, again, other


def tile_same(tag, runs):
    """The tile body's launch against its second launch and the launch on
    a second stream: bitwise."""
    (g, gp), (a, ap), (s, sp) = runs
    for name, (x, xp) in (("second launch", (a, ap)),
                          ("second stream", (s, sp))):
        if not (torch.equal(g, x) and torch.equal(gp, xp)):
            raise AssertionError(f"{tag}: the {name} differs")


def resident_tile_checks(dev, p, pm):
    """Phase 31's checks: every two-phase mode at phase 6's shapes (one
    iteration from the checkerboard, 16 from a circle) and the 4-phase
    bodies at phase 9's and the main path's (one iteration and 25), each
    against its second launch and a second stream (phases 6 and 9 hold the
    same launches against the plain versions)."""
    lines = []
    for h, w in RES_SHAPES:
        u0 = torch.from_numpy(two_disks(h, w)[0]).to(dev)
        ucf = (torch.from_numpy(colored_squares(h, w)[0]).to(dev)
               .permute(2, 0, 1).contiguous())
        stack = torch.stack([torch.from_numpy(two_disks(h, w, seed=s)[0])
                             for s in range(TILE_FRAMES)]).to(dev)
        starts = {s: init_phi((h, w), s, torch.float32, device=dev)
                  for s in ("checkerboard", "circle")}
        for name, r in RESIDENT.items():
            for iters, un, start in ((1, 1, "checkerboard"),
                                     (16, 4, "circle")):
                args = resident_inputs(r, starts[start], u0, ucf, stack)
                tile_same(f"phase 31 {name} {h}x{w} iters={iters}",
                          tile_runs(lambda: r["wrapper"](*args, p, iters,
                                                         unroll=un)))
        lines.append(f"{h}x{w}: the six K7/K8 modes' second launches and "
                     f"launches on a second stream bitwise")
    for name, shapes in MP2_TILE_SHAPES.items():
        kern = MP2[name]
        for h, w in shapes:
            u, phis, _, _ = mp2_inputs(h, w, dev, pm)
            tile_same(f"phase 31 {name} {h}x{w}",
                      tile_runs(lambda: kern["wrapper"](phis, u, pm, 1)))
            tile_same(f"phase 31 {name} {h}x{w} {MP2_ITERS}",
                      tile_runs(lambda: kern["wrapper"](
                          phis, u, pm, MP2_ITERS, unroll=5)))
            lines.append(f"{name} {h}x{w}: one iteration and {MP2_ITERS}, "
                         f"second launches and a second stream bitwise")
    return lines


def tile_plan_line(symbol, h, w, c, levels, frames=1):
    """'TH x TW tiles, GX x GY blocks (G frame groups of them), u0 resident
    or L2, dynamic bytes, blocks an SM' of a tile-body launch."""
    groups, (th, tw, gx, gy, u0res, smem) = (
        _cuda.frame_groups(frames, h, w, c, _cuda.SMS) if levels == 1
        else (1, _cuda.resident_tile_geometry(h, w, c, levels, _cuda.SMS)))
    per_sm = _cuda.resident_capacity(symbol, c, 0, smem) // _cuda.SMS
    return (f"{th}x{tw} tiles, {gx * gy} blocks"
            + (f" x {groups} frame groups" if groups > 1 else "")
            + f", u0 {'in shared memory' if u0res else 'through L2'}, "
            f"{smem} B, {per_sm} block(s)/SM")


def resident_tile_times(dev, card, p, pm):
    """Phase 31's times: each body twice (events over 3 calls) at the main
    path's shapes, 1000 iterations a launch, beside the bound."""
    out, times = [], {}
    its = THROUGHPUT_ITERS
    for name, shapes in RES_TILE_TIMED.items():
        r = RESIDENT[name]
        for h, w in shapes:
            u0 = torch.from_numpy(two_disks(h, w)[0]).to(dev)
            ucf = (torch.from_numpy(colored_squares(h, w)[0]).to(dev)
                   .permute(2, 0, 1).contiguous())
            stack = torch.stack([torch.from_numpy(two_disks(h, w, seed=s)[0])
                                 for s in range(TILE_FRAMES)]).to(dev)
            phi = init_phi((h, w), "checkerboard", torch.float32, device=dev)
            args = resident_inputs(r, phi, u0, ucf, stack)
            frames = TILE_FRAMES if r["mode"] == "_batch" else 1
            rows = 1 if frames > 1 else its
            b_ms, b_by = bound(h, w, its, r["channels"], frames, rows=rows)
            sym = ("cv_packed_resident_iterations" if name.startswith("K8")
                   else "cv_resident_iterations") + (
                "_mc" if r["channels"] else "")
            t = [time_ms(lambda: r["wrapper"](*args, p, its), 3)
                 for _ in range(2)]
            new = sum(t) / 2
            times[(name, (h, w))] = (new, b_ms)
            out.append(
                f"{name} {h}x{w}{f'x{frames}' if frames > 1 else ''}: "
                f"{t[0]:.3f}, {t[1]:.3f} ms ({new / its * 1e3:.2f} us an "
                f"iteration; bound {b_ms:.3f} {b_by}, ms/bound "
                f"{new / b_ms:.1f}); "
                + tile_plan_line(sym, h, w, r["channels"], 1, frames))
    for name, shapes in MP2_TILE_TIMED.items():
        kern = MP2[name]
        sym = ("cv_packed_mp2_resident_iterations" if name.startswith("K10")
               else "cv_mp2_resident_iterations")
        for h, w in shapes:
            u, phis, _, _ = mp2_inputs(h, w, dev, pm)
            b_ms, b_by = bound_mp2(h, w, its, its, True)
            t = [time_ms(lambda: kern["wrapper"](phis, u, pm, its), 3)
                 for _ in range(2)]
            new = sum(t) / 2
            times[(name, (h, w))] = (new, b_ms)
            out.append(
                f"{name} {h}x{w}: {t[0]:.3f}, {t[1]:.3f} ms "
                f"({new / its * 1e3:.2f} us an iteration; bound {b_ms:.3f} "
                f"{b_by}, ms/bound {new / b_ms:.1f}); "
                + tile_plan_line(sym, h, w, 0, 2))
    print(f"phase 31 tile bodies ({its} iterations a launch, two runs): "
          + "; ".join(out) + f" [{card}]", flush=True)
    return times


def resident_tile_rates(dev, card, p, pm):
    """Phase 31's runs: phase 8's and 11's fixed runs through the entry
    points, the tile body's launches counted (the counts set to 0 just
    before each run), then the rates (two runs)."""
    its = THROUGHPUT_ITERS
    u256 = torch.from_numpy(two_disks(256, 256)[0]).to(dev)
    v512 = torch.from_numpy(colored_squares(512, 512)[0]).to(dev)
    u1k = torch.from_numpy(two_disks(1024, 1024)[0]).to(dev)
    s256 = torch.stack([torch.from_numpy(two_disks(256, 256, seed=s)[0])
                        for s in range(8)]).to(dev)
    m512 = torch.from_numpy(four_regions(512, 512)[0]).to(dev)
    m1k = torch.from_numpy(four_regions(1024, 1024)[0]).to(dev)
    runs = {  # run, pixel-iterations, multiphase
        "segment_resident_fixed 256^2 gray": (
            lambda: ct.segment_resident_fixed(u256, p, iters=its),
            256 * 256 * its, False),
        "segment_resident_fixed 512^2 RGB lambda1=(1.0, 1.2, 0.8)": (
            lambda: ct.segment_resident_fixed(
                v512, p, iters=its, lambda1=LAMBDAS["lambda1"]),
            512 * 512 * its, False),
        "segment_resident_fixed 1024^2 gray": (
            lambda: ct.segment_resident_fixed(u1k, p, iters=its),
            1024 * 1024 * its, False),
        "segment_stack_resident_fixed 8 x 256^2": (
            lambda: ct.segment_stack_resident_fixed(s256, p, iters=its),
            8 * 256 * 256 * its, False),
        "segment_multiphase(fixed=True) 512^2": (
            lambda: ct.segment_multiphase(m512, pm, fixed=True,
                                          max_iter=its), 512 * 512 * its,
            True),
        "segment_multiphase(fixed=True) 1024^2": (
            lambda: ct.segment_multiphase(m1k, pm, fixed=True,
                                          max_iter=its), 1024 * 1024 * its,
            True),
    }
    counters = {**{n: r["wrapper"] for n, r in RESIDENT.items()},
                **{n: MP2[n]["wrapper"] for n in MP2_TILE_TIMED}}
    lines, rates = [], []
    for tag, (fn, pix, multi) in runs.items():
        for f in counters.values():
            f.launches = 0
        res = fn()
        torch.cuda.synchronize()
        have = {n: f.launches for n, f in counters.items() if f.launches}
        phi = res.phis if multi else res[0]
        if not have or not torch.isfinite(phi).all():
            raise AssertionError(f"phase 31 {tag}: launches {have}, or its "
                                 f"level sets not finite")
        lines.append(f"{tag}: launches {have}")
        t = [time_ms(fn, 1) for _ in range(2)]
        rates.append(f"{tag} " + ", ".join(f"{pix / (ms * 1e3):.1f}"
                                           for ms in t))
    print("phase 31 runs through the tile bodies: " + "; ".join(lines),
          flush=True)
    print(f"phase 31 rates (Mpixel-iters/s, {its} iterations; two runs): "
          + "; ".join(rates) + f" [{card}]", flush=True)


def resident_tile_phase(dev, card, sass_checked):
    """Phase 31: the tile bodies of K7, K8 (every mode), K9's resident mode
    and K10. Registers, spills, dynamic shared memory and blocks an SM,
    then the checks, the times and the runs."""
    regs = [s for s in ptxas_summary().split(", ")
            if s.startswith(("tile_resident", "mp2_tile"))]
    print("phase 31 tile bodies ptxas: " + ", ".join(regs) + "; phase 27's "
          "sass_diff check: "
          + ("passed" if sass_checked else "not run (no --sass-parent)"),
          flush=True)
    p = ct.CVParams()
    pm = ct.CVParams(mu=MU_MP, max_iter=500)
    for line in resident_tile_checks(dev, p, pm):
        print(f"phase 31 {line}", flush=True)
    resident_tile_times(dev, card, p, pm)
    resident_tile_rates(dev, card, p, pm)


R1_WRAPPER = reinitm.reinit


def r1_launches(shape, dtype=torch.float32, steps=REINIT_STEPS):
    """R1's launches a redistance of an (H, W) level set or a (B, H, W)
    stack: a pass of the tile body each, ceil(steps / k) at the depth k
    that _cuda.reinit_geometry picks."""
    b, h, w = shape if len(shape) == 3 else (1, *shape)
    k = _cuda.reinit_geometry(b, h, w, steps,
                              torch.finfo(dtype).bits // 8)[0]
    return len(_cuda.reinit_passes(steps, k))


def reinit_ptxas():
    """Registers and spill stores of R1's tile body from ptxas's report:
    'tile f32: R regs, S B spill', 'tile f64: ...'."""
    out, name = {}, None
    for line in _build.ptxas_report().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"reinit_(tile)I([fd])E", m.group(1))
            name = (f"{k.group(1)} f{32 if k.group(2) == 'f' else 64}"
                    if k else None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(name, {})["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["regs"] = int(m.group(1))
    return ", ".join(f"{n}: {v.get('regs')} regs {v.get('spill')} B spill"
                     for n, v in sorted(out.items()))


def bound_reinit(x, steps):
    """(ms, "bytes" or "operations"): the least time of one redistance of
    ``x``: phi read once and the result written once, against the prepass
    and ``steps`` steps of the operations this level set's cells need (its
    crossing cells the subcell update, the others the PDE's), at the
    card's f32 or f64 rate."""
    f64 = x.dtype == torch.float64
    cells = x.numel()
    crossing = int(reinitm.crossings(x).sum())
    nbytes = (16 if f64 else 8) * cells
    ops = cells * OPS_REINIT_PRE + steps * (
        crossing * OPS_REINIT_SUB + (cells - crossing) * OPS_REINIT_PDE)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / (PEAK_F64 if f64 else PEAK_F32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reinit_input(shape, dev, dtype, seed=0):
    """Level sets as the main path hands R1 (a frame, or a stack of them):
    a steep two-disks distance function (slope 40, as a converged coarse
    level set upsampled), noise, exact zeros on a row."""
    rng = np.random.default_rng(seed)
    frames = []
    b, h, w = shape if len(shape) == 3 else (1, *shape)
    i, j = np.mgrid[0:h, 0:w].astype(np.float64)
    for m in range(b):
        d1 = 0.15 * min(h, w) - np.hypot(i - (0.3 + 0.05 * m) * h, j - 0.3 * w)
        d2 = 0.2 * min(h, w) - np.hypot(i - 0.68 * h, j - 0.65 * w)
        phi = 40.0 * np.maximum(d1, d2) + rng.standard_normal((h, w))
        phi[h // 3, : w // 4] = 0.0
        frames.append(phi)
    x = torch.from_numpy(np.stack(frames)).to(dev, dtype)
    return x if len(shape) == 3 else x[0]


def check_reinit(x, steps=REINIT_STEPS):
    """R1 against its plain version on ``x``: (bitwise, max |diff|). Where
    not bitwise, the signs must agree everywhere and the difference stay
    within REINIT_RTOL of max |phi|. R1 must also leave ``x`` as it
    was."""
    kept = x.clone()
    got = R1_WRAPPER(x, steps)
    want = reinitm.reinit_reference(x, steps)
    torch.cuda.synchronize()
    if not torch.equal(x, kept):
        raise AssertionError(f"R1 {tuple(x.shape)} {x.dtype} steps {steps}: "
                             f"changed its input")
    err = float((got - want).abs().max())
    bitwise = torch.equal(got, want)
    if not bitwise and not (
            torch.equal(torch.sign(got), torch.sign(want))
            and err <= REINIT_RTOL * float(want.abs().max())):
        raise AssertionError(f"R1 {tuple(x.shape)} {x.dtype}: max |diff| "
                             f"{err} or signs differ from the plain version")
    return bitwise, err


def device_ms(prof, pattern=None):
    """Device time (ms) of the kernels a profile recorded, those whose name
    holds ``pattern`` where given."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and (pattern is None or pattern in e.name)) / 1e3


def reinit_checks(dev, card, stat):
    """R1 against its plain version at the pyramid's five level shapes and
    stacks (20 steps), and at a ragged shape and a stack at every step
    count of STEP_COUNTS, f32 and f64; then its queued times (two runs) at
    every level shape beside the plain version and the bound, with the
    tile body's geometry and the blocks an SM the card gives it."""
    print(f"phase 32 R1 ptxas: {reinit_ptxas()}", flush=True)
    results = []
    cases = [(shape, REINIT_STEPS) for shape in
             list(PYRAMID_SHAPES) + [(2, 1080, 1920), (2, H4K, W4K)]]
    cases += [(shape, n) for shape in (REINIT_RAGGED, REINIT_STACK)
              for n in STEP_COUNTS if n != REINIT_STEPS]
    for dtype in (torch.float32, torch.float64):
        for shape, steps in cases:
            x = reinit_input(shape, dev, dtype, seed=steps)
            bitwise, err = check_reinit(x, steps)
            stat["max_abs_err"] = max(stat["max_abs_err"], err)
            stat["bitwise"] = stat["bitwise"] and bitwise
            results.append(f"{'x'.join(map(str, shape))} "
                           f"{str(dtype)[6:]} steps {steps} "
                           f"{'bitwise' if bitwise else err}")
    print("phase 32 R1 (the tile body) against its plain version: "
          + ", ".join(results), flush=True)
    times = []
    for dtype in (torch.float32, torch.float64):
        for shape in PYRAMID_SHAPES:
            x = reinit_input(shape, dev, dtype)
            turns = [queued_ms(lambda: R1_WRAPPER(x, REINIT_STEPS), 10)
                     for _ in range(2)]
            ms = sum(turns) / 2
            # ~1000 eager launches a call: the host's pace at small shapes
            plain = time_ms(
                lambda: reinitm.reinit_reference(x, REINIT_STEPS), 2)
            b_ms, b_by = bound_reinit(x, REINIT_STEPS)
            k, th, tw, px, py, rs = _cuda.reinit_geometry(
                1, *shape, REINIT_STEPS, x.element_size())
            occ = _cuda.reinit_occupancy(
                px * py, _cuda.reinit_smem(*shape, k, th, tw,
                                           x.element_size()),
                dtype == torch.float64)
            times.append(f"{shape[0]}x{shape[1]} {str(dtype)[6:]} "
                         f"{ms:.4f} ({turns[0]:.4f}, {turns[1]:.4f}; "
                         f"{ms / b_ms:.1f}x the bound) (plain {plain:.3f}, "
                         f"bound "
                         f"{b_ms:.4f} {b_by}; k {k}, {th}x{tw} tiles, "
                         f"{px}x{py} threads of {rs} rows, "
                         f"{r1_launches(shape, dtype)} launches, {occ} "
                         f"blocks/SM)")
            if dtype == torch.float32 and shape == (H4K, W4K):
                stat.update(ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by)
    print("phase 32 R1 queued ms a redistance (20 steps), the tile body, "
          "two runs; the plain version's ms at the host's pace: "
          + ", ".join(times)
          + f" [{card}]", flush=True)


def pyramid_run(dev, card, stat):
    """segment_pyramid on the pyramid cell's 4K scene: the time to the
    converged mask after a warm run, level_iters, R1's share (profiler)
    and the masks against the disk and the direct segment_banded run."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:H4K, :W4K]
    disk = (yy - 1080.0) ** 2 + (xx - 1920.0) ** 2 < 800.0 ** 2
    img = torch.from_numpy((np.where(disk, 200.0, 0.0)
                            + rng.normal(0, 5, (H4K, W4K)))
                           .astype(np.float32)).to(dev)
    pp = ct.CVParams(**PYR_PARAMS)
    ct.segment_pyramid(img, pp)
    torch.cuda.synchronize()
    counted = {"K1": fused_kernel.fused_iteration,
               "K2": banded_kernel.banded_chunk,
               "K3": packed_kernel.packed_banded_chunk}
    for fn in (R1_WRAPPER, *counted.values()):
        fn.launches = 0
    t0 = time.perf_counter()
    res = ct.segment_pyramid(img, pp)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    stat["launches"] = R1_WRAPPER.launches
    kern = {k: fn.launches for k, fn in counted.items()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ct.segment_pyramid(img, pp)
        torch.cuda.synchronize()
    r1_ms, dev_ms = device_ms(prof, "reinit_"), device_ms(prof)
    ct.segment_banded(img, pp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = ct.segment_banded(img, pp)
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) * 1e3
    # the direct run's tolerance stops it while its contour still travels
    # toward the disk (the scene's basin-rescue case): the same solver run
    # on from the same start to PYR_DIRECT_ITERS is the fixed point held
    # against the pyramid
    far = ct.segment_banded_fixed(img, pp, iters=PYR_DIRECT_ITERS)[1]
    info = {"direct tolerance run IoU vs disk": iou(direct.mask.cpu(), disk),
            "pyramid IoU vs the direct tolerance run": iou(
                res.mask.cpu(), direct.mask.cpu())}
    checks = {
        "pyramid IoU vs disk": (iou(res.mask.cpu(), disk), 0.99),
        f"direct {PYR_DIRECT_ITERS}-iteration run IoU vs disk": (
            iou(far.cpu(), disk), 0.99),
        f"pyramid IoU vs the direct {PYR_DIRECT_ITERS}-iteration run": (
            iou(res.mask.cpu(), far.cpu()), 0.99),
    }
    print(f"phase 32 segment_pyramid 4K (bench_families.py:166-180 scene): "
          f"time to the converged mask {ms:.1f} ms (warm), level_iters "
          f"{res.level_iters} at "
          f"{', '.join(f'{h}x{w}' for h, w in PYRAMID_SHAPES)}; "
          f"direct segment_banded {direct.iters} iters {direct_ms:.1f} ms; "
          f"R1 {stat['launches']} launches (4 redistances, "
          f"{'+'.join(str(r1_launches(x)) for x in PYRAMID_SHAPES[1:])}), "
          f"{r1_ms:.3f} ms of device "
          f"time in a profiled run ({100 * r1_ms / ms:.2f}% of the warm "
          f"run's {ms:.1f} ms, {100 * r1_ms / dev_ms:.2f}% of its "
          f"{dev_ms:.2f} ms of kernel time); kernel launches "
          + ", ".join(f"{k}={v}" for k, v in kern.items()) + "; "
          + "; ".join(f"{k} {v:.6f}" for k, v in info.items()) + "; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in checks.items())
          + f" [{card}]", flush=True)
    if not res.iters < direct.iters:
        raise AssertionError(f"the pyramid's finest level ran {res.iters} "
                             f"iterations, the direct run {direct.iters}")
    if stat["launches"] != sum(r1_launches(x) for x in PYRAMID_SHAPES[1:]):
        raise AssertionError(f"R1 launched {stat['launches']} times on the "
                             f"pyramid, not one redistance a level "
                             f"boundary")
    check_masks(checks)


def cadence_runs(dev, card, u4k, gt4k):
    """reinit_every = 10 through segment_fused_fixed (K1, R1) and
    segment_sharded on a 2x2 grid on the card (K1's shard mode, R1 on each
    padded shard), against the plain route and the unsharded fused route,
    with the rates and the launches; then the CLI's --pyramid, --smooth
    and --reinit-every on a 1080p image."""
    pc = ct.CVParams(mu=0.001 * 255.0 ** 2, reinit_every=CADENCE_EVERY)
    p0 = pc.replace(reinit_every=0)
    n_pix = H4K * W4K
    rates = {}
    for tag, p in (("no cadence", p0), ("reinit_every=10", pc)):
        ct.segment_fused_fixed(u4k, p, iters=CADENCE_ITERS)
        torch.cuda.synchronize()
        R1_WRAPPER.launches = fused_kernel.fused_iteration.launches = 0
        t0 = time.perf_counter()
        phi, mask = ct.segment_fused_fixed(u4k, p, iters=CADENCE_ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rates[tag] = (ms, n_pix * CADENCE_ITERS / (ms * 1e3),
                      R1_WRAPPER.launches,
                      fused_kernel.fused_iteration.launches)
    with plain_route():
        plain = ct.segment_fused_fixed(u4k, pc, iters=CADENCE_ITERS)[1]
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    ref = ct.segment_fused(u4k, pc, fixed=True, max_iter=CADENCE_ITERS)
    segment_sharded(u4k, pc, mesh, fixed=True, max_iter=CADENCE_ITERS)
    torch.cuda.synchronize()
    R1_WRAPPER.launches = fused_kernel.fused_iteration.shard_launches = 0
    t0 = time.perf_counter()
    sh = segment_sharded(u4k, pc, mesh, fixed=True, max_iter=CADENCE_ITERS)
    torch.cuda.synchronize()
    sh_ms = (time.perf_counter() - t0) * 1e3
    sh_r1 = R1_WRAPPER.launches
    sh_k1 = fused_kernel.fused_iteration.shard_launches
    checks = {
        "segment_fused_fixed reinit IoU vs plain route": (
            iou(mask.cpu(), plain.cpu()), 0.999),
        "segment_sharded 2x2 reinit IoU vs segment_fused": (
            iou(sh.mask.cpu(), ref.mask.cpu()), 0.999),
    }
    print(f"phase 32 cadence, 4K gray {CADENCE_ITERS} iterations, mu 0.001 "
          f"255^2: segment_fused_fixed "
          + ", ".join(f"{t} {ms:.1f} ms = {r:.1f} Mpixel-iters/s (R1 "
                      f"launches {n1}, K1 {nk})" for t, (ms, r, n1, nk)
                      in rates.items())
          + f"; segment_sharded 2x2 comm_k 1 reinit_every=10 {sh_ms:.1f} ms "
          f"= {n_pix * CADENCE_ITERS / (sh_ms * 1e3):.1f} Mpixel-iters/s "
          f"(R1 {sh_r1} launches on the shards, K1 shard {sh_k1}); "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in checks.items())
          + f" [{card}]", flush=True)
    fired = CADENCE_ITERS // CADENCE_EVERY
    padded = (H4K // 2 + 2 * REINIT_STEPS, W4K // 2 + 2 * REINIT_STEPS)
    if rates["reinit_every=10"][2] != fired * r1_launches((H4K, W4K)) \
            or sh_r1 != 4 * fired * r1_launches(padded) \
            or sh_k1 < 1:
        raise AssertionError("the cadence runs did not launch R1 once a "
                             "cadence (a shard)")
    check_masks(checks)
    img, gt = two_disks(1080, 1920)
    with tempfile.TemporaryDirectory() as tmp:
        src, out = f"{tmp}/img.npy", f"{tmp}/mask.npy"
        np.save(src, img)
        R1_WRAPPER.launches = 0
        t0 = time.perf_counter()
        rc = tcli.main([src, "--pyramid", "-1", "--smooth", "10",
                        "--reinit-every", "10", "-o", out])
        cli_s = time.perf_counter() - t0
        mask = np.load(out) > 0
    checks = {"CLI --pyramid -1 --smooth 10 --reinit-every 10 1080p IoU vs "
              "truth": (iou(mask, gt), 0.99)}
    print(f"phase 32 CLI: exit {rc}, {cli_s:.2f} s, R1 "
          f"{R1_WRAPPER.launches} launches; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in checks.items()),
          flush=True)
    if rc != 0 or R1_WRAPPER.launches < 1:
        raise AssertionError(f"the CLI exited {rc}, R1 "
                             f"{R1_WRAPPER.launches} launches")
    check_masks(checks)


def reinit_phase(dev, card, u4k, gt4k):
    """Phase 32: R1 against its plain version and its times, the 4K
    pyramid, the cadence routes and the CLI. Returns R1's stats."""
    stat = dict(max_abs_err=0.0, bitwise=True)
    reinit_checks(dev, card, stat)
    pyramid_run(dev, card, stat)
    cadence_runs(dev, card, u4k, gt4k)
    return {"R1 reinit": stat}


# checkpoints, traces, GIF frames (phase 33) and the profiling and driver
# hooks (phase 34): existing kernels on the new modules' paths
# the 4K 2x2 comm_k 8 checkpointed run, and the shorter ones of the 1x1
# packed mesh (K3's shard mode) and of comm_k 1 with halo='rdma' (K1's
# shard mode, K14)
CKPT_ITERS, CKPT_EVERY = 800, 200
CKPT_SHORT_ITERS, CKPT_SHORT_EVERY = 96, 48
# the multiphase checkpoints: 1024^2, M = 2, every 50 of 200 iterations;
# chunked labels against the unchunked run within PERF.md section 2's bar
MP_CKPT_SHAPE, MP_CKPT_ITERS, MP_CKPT_EVERY = (1024, 1024), 200, 50
LABELS_BAR = 1e-3
# the CLI's sharded trace (comm_k 1), and the fixed branch's GIF frames
CLI_TRACE_ITERS = 100
GIF_ITERS, GIF_EVERY = 40, 10
# the time of the checkpointed run beside the plain one, and of a save
SAVE_REPS = 3
# time_fn against time_ms on the same call: two chained K2 chunks at 4K
# with k = 21 (phase 27's deepest; ~3.4 ms of device time), so the host's
# cost of a call alone (~0.13 ms for one k = 8 chunk on an H100 80GB HBM3
# at 700 W, whose events read 0.65 ms) stays inside the bar
PROFILE_K, TIME_FN_RTOL = 21, 0.1


class InjectedFault(Exception):
    """Raised from a wrapped save_sharded after its second save."""


PATH_COUNTERS = {
    "K1 fused_iteration": (fused_kernel.fused_iteration, "launches"),
    "K1 fused_iteration (shard)": (fused_kernel.fused_iteration,
                                   "shard_launches"),
    "K2 banded_chunk": (banded_kernel.banded_chunk, "launches"),
    "K2 banded_chunk_sharded": (banded_kernel.banded_chunk_sharded,
                                "launches"),
    "K3 packed_banded_chunk_sharded": (
        packed_kernel.packed_banded_chunk_sharded, "launches"),
    "K9 mp2_iteration_sharded": (multiphase_kernel.mp2_iteration_sharded,
                                 "launches"),
    "K9 mp2_resident_iterations": (
        multiphase_kernel.mp2_resident_iterations, "launches"),
    "K10 packed_mp2_resident_iterations": (
        packed_kernel.packed_mp2_resident_iterations, "launches"),
    "K14 exchange_halo2d_rdma": (exchange_halo2d_rdma, "launches"),
}


def counted(fn):
    """(fn(), {kernel: launches}) with every counter of PATH_COUNTERS set
    to 0 just before and read just after (kernels launched at least
    once)."""
    for obj, attr in PATH_COUNTERS.values():
        setattr(obj, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(obj, attr)
                 for name, (obj, attr) in PATH_COUNTERS.items()
                 if getattr(obj, attr)}


def need_launches(tag, counts, *names):
    missing = [n for n in names if not counts.get(n)]
    if missing:
        raise AssertionError(f"{tag}: {', '.join(missing)} not launched "
                             f"({counts})")


def launch_line(counts):
    return ", ".join(f"{n.split()[0]}{' shard' if 'shard' in n else ''}"
                     f"={v}" for n, v in counts.items())


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def sharded_checkpoints(dev, card, u4k, gt4k, root):
    """The 4K checkpointed sharded runs against the unchunked ones, the
    injected fault and its resume, a torn save, the launches and times.
    Returns the uninterrupted 2x2 comm_k 8 checkpointed result."""
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    mesh1 = make_grid_mesh(1, 1, [dev])

    def run_ck(d, every=CKPT_EVERY):
        return cks.segment_sharded_with_checkpoints(
            u4k, pt, mesh, CKPT_ITERS, d, every=every, comm_k=SHARD_K)

    ref, ref_n = counted(lambda: segment_sharded(
        u4k, pt, mesh, fixed=True, max_iter=CKPT_ITERS, comm_k=SHARD_K))
    full, full_n = counted(lambda: run_ck(root / "full"))
    saved = sorted(f.name for f in (root / "full").iterdir())
    want = [f"ckpt_{s:08d}" for s in range(CKPT_EVERY, CKPT_ITERS + 1,
                                            CKPT_EVERY)]
    if saved != want:
        raise AssertionError(f"checkpoint directory holds {saved}")
    need_launches("2x2 comm_k 8 checkpointed", full_n,
                  "K2 banded_chunk_sharded")

    real_save, calls = cks.save_sharded, [0]

    def save_then_fail(*a, **kw):
        out = real_save(*a, **kw)
        calls[0] += 1
        if calls[0] == 2:
            raise InjectedFault(f"after save {calls[0]}")
        return out

    cks.save_sharded = save_then_fail
    try:
        run_ck(root / "fault")
        raise AssertionError("the injected fault did not fire")
    except InjectedFault:
        pass
    finally:
        cks.save_sharded = real_save
    # a torn save of the next checkpoint left in the directory
    torn = root / "fault" / f".tmp_ckpt_{3 * CKPT_EVERY:08d}"
    torn.mkdir()
    (torn / ".metadata").write_bytes(b"partial write")
    picked = cks.latest_sharded(root / "fault").name
    if picked != f"ckpt_{2 * CKPT_EVERY:08d}":
        raise AssertionError(f"latest_sharded picked {picked}")
    resumed, res_n = counted(lambda: run_ck(root / "fault"))
    resumed_bitwise = torch.equal(resumed.phi, full.phi)

    packed1, packed_n = counted(lambda: cks.segment_sharded_with_checkpoints(
        u4k, pt, mesh1, CKPT_SHORT_ITERS, root / "packed",
        every=CKPT_SHORT_EVERY, comm_k=SHARD_K, packed=True))
    packed_ref = segment_sharded(u4k, pt, mesh1, fixed=True,
                                 max_iter=CKPT_SHORT_ITERS, comm_k=SHARD_K,
                                 packed=True)
    need_launches("1x1 packed checkpointed", packed_n,
                  "K3 packed_banded_chunk_sharded")
    rdma, rdma_n = counted(lambda: cks.segment_sharded_with_checkpoints(
        u4k, pt, mesh, CKPT_SHORT_ITERS, root / "rdma",
        every=CKPT_SHORT_EVERY, halo="rdma"))
    rdma_ref = segment_sharded(u4k, pt, mesh, fixed=True,
                               max_iter=CKPT_SHORT_ITERS, halo="rdma")
    need_launches("2x2 comm_k 1 rdma checkpointed", rdma_n,
                  "K1 fused_iteration (shard)", "K14 exchange_halo2d_rdma")
    torch.cuda.synchronize()
    checks = {
        "2x2 comm_k 8 checkpointed IoU vs unchunked": (
            iou(full.mask.cpu(), ref.mask.cpu()), 0.999),
        "2x2 comm_k 8 checkpointed IoU vs truth": (
            iou_phases(full.mask.cpu(), gt4k), 0.99),
        "1x1 packed checkpointed IoU vs unchunked": (
            iou(packed1.mask.cpu(), packed_ref.mask.cpu()), 0.999),
        "2x2 rdma checkpointed IoU vs unchunked": (
            iou(rdma.mask.cpu(), rdma_ref.mask.cpu()), 0.999),
    }
    errs = {t: float((a.phi - b.phi).abs().max()) for t, a, b in (
        ("2x2 comm_k 8", full, ref), ("1x1 packed", packed1, packed_ref),
        ("2x2 rdma", rdma, rdma_ref))}
    print(f"phase 33 sharded checkpoints, 4K gray, mu 0.001 255^2: "
          f"segment_sharded_with_checkpoints 2x2 comm_k {SHARD_K} "
          f"{CKPT_ITERS} iterations every {CKPT_EVERY} (saved {saved}), "
          f"1x1 packed and 2x2 comm_k 1 halo='rdma' {CKPT_SHORT_ITERS} "
          f"every {CKPT_SHORT_EVERY}, each against the unchunked "
          f"segment_sharded: phi max|d| "
          + ", ".join(f"{t} {e:.3e}" for t, e in errs.items()) + "; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in checks.items())
          + f"; a run failed after its second save and resumed from "
          f"{picked} (a torn {torn.name} beside it) bitwise the "
          f"uninterrupted run: {resumed_bitwise}; launches: unchunked "
          f"{launch_line(ref_n)}; checkpointed {launch_line(full_n)}; "
          f"resumed {launch_line(res_n)}; 1x1 packed "
          f"{launch_line(packed_n)}; rdma {launch_line(rdma_n)}", flush=True)
    check_masks(checks)
    if not resumed_bitwise:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    n_pix = H4K * W4K
    plain_ms = wall_ms(lambda: segment_sharded(
        u4k, pt, mesh, fixed=True, max_iter=CKPT_ITERS, comm_k=SHARD_K))[0]
    ck_ms = wall_ms(lambda: run_ck(root / "timed"))[0]
    saves = [wall_ms(lambda: cks.save_sharded(root / "saves", CKPT_ITERS,
                                              full.phi, full.c1, full.c2))[0]
             for _ in range(SAVE_REPS)]
    mb = full.phi.numel() * full.phi.element_size() / 1e6
    print(f"phase 33 times, 4K 2x2 comm_k {SHARD_K} {CKPT_ITERS} "
          f"iterations (wall clock, synchronized): segment_sharded "
          f"{plain_ms:.1f} ms = {n_pix * CKPT_ITERS / (plain_ms * 1e3):.1f} "
          f"Mpixel-iters/s; segment_sharded_with_checkpoints every "
          f"{CKPT_EVERY} {ck_ms:.1f} ms = "
          f"{n_pix * CKPT_ITERS / (ck_ms * 1e3):.1f} Mpixel-iters/s; one "
          f"save_sharded of the {mb:.1f} MB level set "
          + ", ".join(f"{s:.1f}" for s in saves) + f" ms [{card}]",
          flush=True)
    return pt, mesh, full


def multiphase_checkpoints(dev, card, root):
    """The multiphase checkpoints at 1024^2, unsharded (K9 resident) and
    on the 2x2 grid (K9's shard mode), against the unchunked runs."""
    pm = ct.CVParams(mu=MU_MP, max_iter=500)
    img, gt = four_regions(*MP_CKPT_SHAPE)
    u = torch.from_numpy(img).to(dev)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    runs = {
        "unsharded": (
            lambda: ct.segment_multiphase(u, pm, fixed=True,
                                          max_iter=MP_CKPT_ITERS),
            lambda: ckptm.segment_multiphase_with_checkpoints(
                u, pm, MP_CKPT_ITERS, root / "mp", every=MP_CKPT_EVERY),
            ("K9 mp2_resident_iterations",)),
        "2x2": (
            lambda: segment_multiphase_sharded(
                u, pm, mesh, fixed=True, max_iter=MP_CKPT_ITERS),
            lambda: cks.segment_multiphase_sharded_with_checkpoints(
                u, pm, mesh, MP_CKPT_ITERS, root / "mps",
                every=MP_CKPT_EVERY),
            ("K9 mp2_iteration_sharded",)),
    }
    out = {}
    for tag, (plain_fn, ck_fn, kernels) in runs.items():
        ref, ref_n = counted(plain_fn)
        got, got_n = counted(ck_fn)
        need_launches(f"multiphase {tag} checkpointed", got_n, *kernels)
        out[tag] = (label_frac(got.phis, ref.phis),
                    torch.equal(got.phis, ref.phis),
                    best_accuracy(got.labels.cpu(), gt), ref_n, got_n)
    print(f"phase 33 multiphase checkpoints {MP_CKPT_SHAPE[0]}x"
          f"{MP_CKPT_SHAPE[1]} M=2, every {MP_CKPT_EVERY} of "
          f"{MP_CKPT_ITERS} iterations: "
          + "; ".join(f"{t} labels differing from the unchunked run "
                      f"{fr:.3e} (<= {LABELS_BAR}), level sets bitwise "
                      f"{eq}, accuracy vs truth {acc:.6f}, launches "
                      f"unchunked {launch_line(rn)}, checkpointed "
                      f"{launch_line(gn)}"
                      for t, (fr, eq, acc, rn, gn) in out.items()), flush=True)
    for tag, (frac, _, _, _, _) in out.items():
        if not frac <= LABELS_BAR:
            raise AssertionError(f"multiphase {tag} checkpointed labels "
                                 f"differ at {frac}")


def cli_trace_and_frames(dev, card, u4k, pt, mesh, full, root):
    """The CLI's --mesh --trace-energy against the unsharded trace, its
    --checkpoint-dir, and the GIF helpers' last frames against the main
    runs (the sharded branch and the fixed branch at 1080p)."""
    src = str(root / "img4k.npy")
    np.save(src, u4k.cpu().numpy())
    csv = root / "trace.csv"
    rc, trace_n = counted(lambda: tcli.main(
        [src, "--mesh", "2", "2", "--iters", str(CLI_TRACE_ITERS),
         "--trace-energy", str(csv), "--quiet",
         "-o", str(root / "mask_trace.npy")]))
    energy = torch.from_numpy(tracem.read_energy_csv(csv)["energy"])
    plain = ct.segment_fixed(u4k, ct.CVParams(),
                             iters=CLI_TRACE_ITERS).energy.double().cpu()
    e_rel = float(((energy - plain).abs() / plain.abs()).max())
    need_launches("CLI sharded trace", trace_n, "K1 fused_iteration (shard)")

    # the sharded branch: the CLI's checkpointed run, its GIF frames at
    # the checkpoints' chunks
    mu = str(pt.mu)
    ck = root / "cli_ck"
    argv = [src, "--mesh", "2", "2", "--iters", str(CKPT_ITERS), "--mu", mu,
            "--comm-k", str(SHARD_K), "--gif-every", str(CKPT_EVERY)]
    rc2, cli_n = counted(lambda: tcli.main(
        argv + ["--checkpoint-dir", str(ck), "--checkpoint-every",
                str(CKPT_EVERY), "--quiet", "-o",
                str(root / "mask_ck.npy")]))
    final = cks.restore_sharded(cks.latest_sharded(ck), mesh, (H4K, W4K),
                                torch.float32)
    args = tcli.build_parser().parse_args(argv)
    frames, gif_n = counted(lambda: tcli._sharded_frames(
        args, u4k, pt, mesh, None, None, SHARD_K))
    sharded_equal = (torch.equal(frames[-1], final["phi"].cpu())
                     and torch.equal(final["phi"], full.phi))
    need_launches("CLI sharded checkpointed", cli_n,
                  "K2 banded_chunk_sharded")
    need_launches("sharded GIF frames", gif_n, "K2 banded_chunk_sharded")

    # the fixed branch at 1080p: segment_fixed, the plain per-iteration
    # driver (means from the level set every iteration, so chunks agree)
    p = ct.CVParams()
    u1k = torch.from_numpy(two_disks(1080, 1920)[0]).to(dev)
    args = tcli.build_parser().parse_args(
        [src, "--iters", str(GIF_ITERS), "--gif-every", str(GIF_EVERY)])
    fixed_frames = tcli._fixed_frames(args, u1k, p, None, None)
    main_phi = ct.segment_fixed(u1k, p, iters=GIF_ITERS).phi
    fixed_equal = torch.equal(fixed_frames[-1], main_phi.cpu())
    # --f64: the plain fixed driver runs in float64 on the card; the
    # kernel routes take float32 only and raise, as their drivers do
    src1k = str(root / "img1k.npy")
    np.save(src1k, u1k.cpu().numpy())
    rc64 = tcli.main([src1k, "--iters", "10", "--f64", "--quiet",
                      "--trace-energy", str(root / "trace64.csv")])
    e64 = tracem.read_energy_csv(root / "trace64.csv")["energy"]
    try:
        tcli.main([src1k, "--f64", "--max-iter", "10", "--quiet"])
        f64_kernel = "ran"
    except TypeError as e:
        f64_kernel = f"TypeError: {e}"
    print(f"phase 33 CLI: --mesh 2 2 --iters {CLI_TRACE_ITERS} "
          f"--trace-energy exit {rc}, energy max rel diff vs the unsharded "
          f"segment_fixed {e_rel:.3e} (<= {TRACE_RTOL}), launches "
          f"{launch_line(trace_n)}; --mesh 2 2 --comm-k {SHARD_K} --iters "
          f"{CKPT_ITERS} --checkpoint-dir exit {rc2}, launches "
          f"{launch_line(cli_n)}; GIF frames: sharded branch "
          f"{len(frames)} frames (launches {launch_line(gif_n)}), the last "
          f"bitwise the checkpointed run's final level set {sharded_equal} "
          f"(max|d| to the unchunked run "
          f"{float((frames[-1] - full.phi.cpu()).abs().max()):.3e}); fixed "
          f"branch 1080p {len(fixed_frames)} frames of {GIF_EVERY} "
          f"iterations, the last bitwise segment_fixed's {GIF_ITERS}-"
          f"iteration level set {fixed_equal}; --f64 --iters 10 at 1080p "
          f"exit {rc64} (energy {e64[-1]:.17g}), --f64 on the banded route: "
          f"{f64_kernel}", flush=True)
    if rc64 != 0 or not f64_kernel.startswith("TypeError"):
        raise AssertionError("--f64 on the card: the plain driver must run "
                             "and the float32 kernels must refuse")
    if rc != 0 or rc2 != 0:
        raise AssertionError(f"the CLI exited {rc}, {rc2}")
    if not e_rel <= TRACE_RTOL:
        raise AssertionError(f"the CLI's sharded trace is {e_rel} from the "
                             f"unsharded one")
    if not (sharded_equal and fixed_equal):
        raise AssertionError("a GIF helper's last frame differs from its "
                             "main run's level set")


def ckpt_phase(dev, card, u4k, gt4k):
    """Phase 33: checkpoints, traces and GIF frames on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        pt, mesh, full = sharded_checkpoints(dev, card, u4k, gt4k, root)
        multiphase_checkpoints(dev, card, root)
        cli_trace_and_frames(dev, card, u4k, pt, mesh, full, root)


def hooks_phase(dev, card, u4k):
    """Phase 34: utils.profiling around K2's chunk, the driver hooks
    (graft_entry) and the demo."""
    p = ct.CVParams()
    phi = init_phi((H4K, W4K), p.init, torch.float32, device=dev)
    c1, c2 = region_means(u4k, phi, p.eps)

    def chunks():
        out, _ = banded_kernel.banded_chunk(phi, u4k, c1, c2, p, k=PROFILE_K)
        return banded_kernel.banded_chunk(out, u4k, c1, c2, p, k=PROFILE_K)

    chunks()
    with tempfile.TemporaryDirectory() as tmp:
        banded_kernel.banded_chunk.launches = 0
        with profiling.trace(tmp) as log_dir:
            chunks()
        n_chunk = banded_kernel.banded_chunk.launches
        with open(Path(log_dir) / "trace.json") as fh:
            events = json.load(fh)["traceEvents"]
    names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    band = [n for n in names if "band_kernel" in n]
    fn_s, _ = profiling.time_fn(chunks, warmup=2, reps=20)
    ev_ms = time_ms(chunks, 20)
    rel = abs(fn_s * 1e3 - ev_ms) / ev_ms
    print(f"phase 34 profiling: trace of two chained K2 chunks at 4K k="
          f"{PROFILE_K} "
          f"({n_chunk} launches) names {band[:1]} among {len(names)} "
          f"kernels; time_fn {fn_s * 1e3:.4f} ms (best of 20, wall) vs "
          f"time_ms {ev_ms:.4f} ms (CUDA events, mean of 20), rel "
          f"{rel:.3f} (<= {TIME_FN_RTOL}); roofline() default "
          f"{profiling.roofline(H4K, W4K):.1f} Mpixel-iters/s [{card}]",
          flush=True)
    if not band or n_chunk != 2:
        raise AssertionError(f"the trace names no band kernel ({names})")
    if not rel <= TIME_FN_RTOL:
        raise AssertionError(f"time_fn {fn_s * 1e3} ms vs time_ms {ev_ms}")

    fn, args = graft_entry.entry()
    (got_phi, got_parts), entry_n = counted(lambda: fn(*args))
    ref_phi, ref_parts = banded_kernel.banded_chunk_reference(
        *args, ct.CVParams(), graft_entry.ENTRY_K)
    err = float((got_phi - ref_phi).abs().max())
    sure = ref_phi.abs() > PHI_ATOL
    entry_ok = (torch.allclose(got_phi, ref_phi, rtol=PHI_RTOL,
                               atol=PHI_ATOL)
                and bool(((got_phi >= 0) == (ref_phi >= 0))[sure].all())
                and torch.allclose(got_parts, ref_parts, rtol=PARTS_RTOL,
                                   atol=PARTS_ATOL))
    dry, dry_n = counted(lambda: graft_entry.dryrun_multichip(4))
    need_launches("graft_entry.entry", entry_n, "K2 banded_chunk")
    need_launches("dryrun_multichip(4)", dry_n, "K2 banded_chunk_sharded")
    with tempfile.TemporaryDirectory() as tmp:
        demo_n = counted(lambda: demo.main(tmp))[1]
        files = sorted(f.name for f in Path(tmp).iterdir())
    need = {"scalar_mask.npy", "scalar_trace.csv", "rgb_mask.npy",
            "multiphase_labels.npy"}
    print(f"phase 34 hooks: graft_entry.entry() K2 chunk 512^2 k="
          f"{graft_entry.ENTRY_K} phi max|d| vs plain {err:.3e} (phi rtol "
          f"{PHI_RTOL} atol {PHI_ATOL}, parts rtol {PARTS_RTOL} atol "
          f"{PARTS_ATOL}) ok {entry_ok}, launches {launch_line(entry_n)}; "
          f"dryrun_multichip(4) layout {dry['layout']} on {dev}, launches "
          f"{launch_line(dry_n)}; demo.main wrote {files}, launches "
          f"{launch_line(demo_n)}", flush=True)
    if not entry_ok or dry["layout"] != (1, 2, 2):
        raise AssertionError("graft_entry disagrees with its plain version "
                             "or the dry run's layout")
    if not need <= set(files):
        raise AssertionError(f"demo.main wrote {files}")


def main(argv=()) -> int:
    sass_parent = None
    if argv:
        if len(argv) != 2 or argv[0] != "--sass-parent":
            sys.exit("usage: python3 chip_smoke.py [--sass-parent DIR]")
        sass_parent = argv[1]
    dev = torch.device("cuda", 0)
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([_build.find_nvcc(), "--version"]).splitlines()[-1]
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
          f"({len(_build.sources())} sources); ptxas: {ptxas_summary()}",
          flush=True)

    # phase 3: each kernel against its plain version, at the main paths'
    # shapes and a ragged one, on the main paths' inputs (the gray image
    # for K1-K3, the RGB one channels-first for K4-K6)
    p = ct.CVParams()
    stats = {name: dict(max_abs_err=0.0) for name in KERNELS}
    for h, w in SHAPES:
        img, _ = two_disks(h, w)
        rgb, _ = colored_squares(h, w)
        u0 = torch.from_numpy(img).to(dev)
        u0_rgb = torch.from_numpy(rgb).to(dev)
        ucf = u0_rgb.permute(2, 0, 1).contiguous()
        phi = init_phi((h, w), p.init, torch.float32, device=dev)
        means = {0: region_means(u0, phi, p.eps),
                 RGB: region_means(u0_rgb, phi, p.eps)}
        inputs = {(0, False): (phi, u0),
                  (0, True): (packed_kernel.pack_planes(phi),
                              packed_kernel.pack_planes(u0)),
                  (RGB, False): (phi, ucf),
                  (RGB, True): (packed_kernel.pack_planes(phi),
                                packed_kernel.pack_planes(ucf))}
        for name, kern in KERNELS.items():
            args = inputs[kern["channels"], kern["packed"]]
            c1, c2 = means[kern["channels"]]
            runs = [(k, {}) for k in kern["ks"]]
            if kern["channels"]:
                runs.append((1, LAMBDAS))
            for k, lam in runs:
                err = check_kernel(name, kern, args, c1, c2, p, k, h, w, lam)
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 err)
            if (h, w) == (H4K, W4K):
                k = kern["ks"][-1]
                kw = {} if kern["ks"] == (1,) else {"k": k}
                stats[name]["ms"] = time_ms(
                    lambda: kern["wrapper"](*args, c1, c2, p, **kw), 20)
                stats[name]["plain_ms"] = time_ms(
                    lambda: kern["plain"](*args, c1, c2, p, k), 3)
                stats[name]["bound_ms"], stats[name]["bound_by"] = bound(
                    h, w, k, kern["channels"])

    # phase 4, gray main path, through user entry points. auto_config
    # sends 4K to K3 and 1080p to K2; segment_fused is the per-iteration
    # driver (K1). Counts are taken over exactly these calls. mu is
    # 0.001 * 255^2: at the default 0.01 * 255^2 the k=8 frozen-means
    # route (the reference's as well) leaves this image's symmetric
    # checkerboard start too slowly and stops or plateaus below the fused
    # route (PERF.md).
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    img4k, gt4k = two_disks(H4K, W4K)
    img1k, gt1k = two_disks(1080, 1920)
    u4k = torch.from_numpy(img4k).to(dev)
    u1k = torch.from_numpy(img1k).to(dev)
    for name in GRAY:
        KERNELS[name]["wrapper"].launches = 0
    reset_pack_counts()
    res4k = ct.segment_banded(u4k, pt)
    res1k = ct.segment_banded(u1k, pt)
    resf = ct.segment_fused(u1k, pt)
    torch.cuda.synchronize()
    for name in GRAY:
        stats[name]["launches"] = KERNELS[name]["wrapper"].launches
    packs = pack_counts()
    with plain_route():
        plain4k = ct.segment_banded(u4k, pt)
        plain1k = ct.segment_banded(u1k, pt)
    torch.cuda.synchronize()
    checks = {
        "4K IoU vs truth": (iou(res4k.mask.cpu(), gt4k), 0.99),
        "4K IoU vs plain route": (iou(res4k.mask.cpu(), plain4k.mask.cpu()),
                                  0.999),
        "1080p IoU vs truth": (iou(res1k.mask.cpu(), gt1k), 0.99),
        "1080p IoU vs plain route": (iou(res1k.mask.cpu(),
                                         plain1k.mask.cpu()), 0.999),
        "1080p fused IoU vs truth": (iou(resf.mask.cpu(), gt1k), 0.99),
    }
    print(f"phase 4 slice: 4K {res4k.iters} iters (plain route "
          f"{plain4k.iters}), 1080p {res1k.iters} (plain {plain1k.iters}), "
          f"fused 1080p {resf.iters}; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in
                      checks.items())
          + "; launches " + ", ".join(f"{n.split()[0]}={stats[n]['launches']}"
                                     for n in GRAY)
          + f", K15={packs[0]}, K16={packs[1]}", flush=True)
    if not (res4k.iters < pt.max_iter and res1k.iters < pt.max_iter
            and resf.iters < pt.max_iter):
        raise AssertionError("a run did not converge within max_iter")
    if min(packs) < 1:
        raise AssertionError(f"the 4K packed route packed through K15/K16 "
                             f"{packs} times")
    if not torch.isfinite(res4k.phi).all():
        raise AssertionError("non-finite 4K level set")
    check_masks(checks)

    # phase 4, RGB main path: auto_config_mc sends 4K RGB to K6 and 1080p
    # RGB to K5; segment_fused on RGB is the per-iteration driver (K4).
    # mu is 0.0001 * 255^2: at the default mu and at 0.001 * 255^2 the k=8
    # frozen-means route leaves this image's checkerboard start with no
    # contour (8 iterations, IoU 0.15), where the per-iteration route
    # converges (PERF.md); the reference's own RGB tests start from a
    # circle, which at 4K does not converge within 3000 iterations.
    pv = ct.CVParams(mu=0.0001 * 255.0 ** 2, max_iter=500)
    rgb4k, gtc4k = colored_squares(H4K, W4K)
    rgb1k, gtc1k = colored_squares(1080, 1920)
    v4k = torch.from_numpy(rgb4k).to(dev)
    v1k = torch.from_numpy(rgb1k).to(dev)
    for name in COLOR:
        KERNELS[name]["wrapper"].launches = 0
    reset_pack_counts()
    rv4k = ct.segment_banded(v4k, pv)
    rv1k = ct.segment_banded(v1k, pv)
    rvf = ct.segment_fused(v1k, pv)
    torch.cuda.synchronize()
    for name in COLOR:
        stats[name]["launches"] = KERNELS[name]["wrapper"].launches
    packs = pack_counts()
    with plain_route():
        pv4k = ct.segment_banded(v4k, pv)
        pv1k = ct.segment_banded(v1k, pv)
        pvf = ct.segment_fused(v1k, pv)
    torch.cuda.synchronize()
    checks = {}
    for tag, res, ref, gt in (("4K RGB", rv4k, pv4k, gtc4k),
                              ("1080p RGB", rv1k, pv1k, gtc1k),
                              ("1080p RGB fused", rvf, pvf, gtc1k)):
        checks[f"{tag} IoU vs truth"] = (iou(res.mask.cpu(), gt), 0.99)
        checks[f"{tag} IoU vs plain route"] = (
            iou(res.mask.cpu(), ref.mask.cpu()), 0.999)
    print(f"phase 4 RGB slice: 4K {rv4k.iters} iters (plain route "
          f"{pv4k.iters}), 1080p {rv1k.iters} (plain {pv1k.iters}), fused "
          f"1080p {rvf.iters} (plain {pvf.iters}); "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in
                      checks.items())
          + "; launches " + ", ".join(f"{n.split()[0]}={stats[n]['launches']}"
                                     for n in COLOR)
          + f", K15={packs[0]}, K16={packs[1]}", flush=True)
    if not all(r.iters < pv.max_iter for r in (rv4k, rv1k, rvf)):
        raise AssertionError("an RGB run did not converge within max_iter")
    if min(packs) < 1:
        raise AssertionError(f"the 4K RGB packed route packed through "
                             f"K15/K16 {packs} times")
    if not (torch.isfinite(rv4k.phi).all() and rv4k.c1.shape == (RGB,)):
        raise AssertionError("non-finite 4K RGB level set or bad means")
    check_masks(checks)
    for name, s in stats.items():
        if s["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    # phase 5: steady-state throughput of the 4K fixed-iteration runs
    p = ct.CVParams()
    iters, plain_iters = 800, 40
    for tag, u, route in (("4K", u4k, "K3"), ("4K RGB", v4k, "K6")):
        kern_ms = time_ms(lambda: ct.segment_banded_fixed(u, p, iters=iters),
                          1)
        with plain_route():
            plain_ms = time_ms(
                lambda: ct.segment_banded_fixed(u, p, iters=plain_iters), 1)
        rate = H4K * W4K * iters / (kern_ms * 1e3)
        plain_rate = H4K * W4K * plain_iters / (plain_ms * 1e3)
        print(f"phase 5 throughput: segment_banded_fixed {tag} k=8 packed "
              f"({route}), {iters} iters {kern_ms:.1f} ms = {rate:.1f} "
              f"Mpixel-iters/s; plain route {plain_iters} iters "
              f"{plain_ms:.1f} ms = {plain_rate:.1f} Mpixel-iters/s "
              f"[{card}]", flush=True)

    # phase 6: each resident mode against its plain version, on the main
    # paths' images (gray two disks, RGB colored squares channels-first, a
    # stack of two-disks frames), at the reference's envelope shapes, a
    # ragged even one and the shapes phase 7 gives each mode: one iteration
    # from the checkerboard start, 16 from a circle (PHI16_FACTOR)
    res_stats = {name: dict(max_abs_err=0.0) for name in RESIDENT}
    for h, w in RES_SHAPES:
        u0 = torch.from_numpy(two_disks(h, w)[0]).to(dev)
        ucf = (torch.from_numpy(colored_squares(h, w)[0]).to(dev)
               .permute(2, 0, 1).contiguous())
        frames = RES_FRAMES_AT.get((h, w), RES_FRAMES)
        stack = torch.stack([torch.from_numpy(two_disks(h, w, seed=s)[0])
                             for s in range(frames)]).to(dev)
        starts = {s: init_phi((h, w), s, torch.float32, device=dev)
                  for s in ("checkerboard", "circle")}
        tag = f"{h}x{w}"
        for name, r in RESIDENT.items():
            args = {s: resident_inputs(r, phi, u0, ucf, stack)
                    for s, phi in starts.items()}
            runs = [(1, 1, {}, "checkerboard"), (16, 1, {}, "circle"),
                    (16, 4, {}, "circle")]
            if r["channels"]:
                runs.append((1, 1, LAMBDAS, "checkerboard"))
            for iters, un, lam, start in runs:
                err = check_resident(name, r, args[start], p, iters, un, lam,
                                     f"{tag} {start}")
                res_stats[name]["max_abs_err"] = max(
                    res_stats[name]["max_abs_err"], err)
            if (h, w) == RES_TIMED:
                frames = len(stack) if r["mode"] == "_batch" else 1
                a = args["checkerboard"]
                res_stats[name]["ms"] = time_ms(
                    lambda: r["wrapper"](*a, p, 16), 20)
                res_stats[name]["plain_ms"] = time_ms(
                    lambda: r["plain"](*a, p, 16), 2)
                res_stats[name]["bound_ms"], res_stats[name]["bound_by"] = (
                    bound(h, w, 16, r["channels"], frames,
                          rows=1 if frames > 1 else 16))
    print(f"phase 6 timed: each mode at {RES_TIMED[0]}x{RES_TIMED[1]}, 16 "
          f"iterations, batch {RES_FRAMES} frames, mc {RGB} channels: "
          + ", ".join(f"{n} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f}, "
                      f"bound {v['bound_ms']:.4f} {v['bound_by']})"
                      for n, v in res_stats.items()), flush=True)

    # phase 7: the resident route through the user entry points. 512^2
    # goes to K8 (W % 256 == 0), 1024x896 to K7; stacks of 8 x 256^2 to
    # K8 batch and 4 x 256x384 to K7 batch; (512, 512, 3) to K8 mc and
    # (512, 384, 3) to K7 mc. mu as phase 4 (pt gray, pv RGB).
    g512, gt512 = two_disks(512, 512)
    g1k, gt1k = two_disks(1024, 896)
    ug512 = torch.from_numpy(g512).to(dev)
    ug1k = torch.from_numpy(g1k).to(dev)
    stacks = []
    for n, (h, w) in ((8, (256, 256)), (4, (256, 384))):
        frames = [two_disks(h, w, seed=s) for s in range(n)]
        stacks.append((torch.from_numpy(np.stack([f for f, _ in frames]))
                       .to(dev), [g for _, g in frames]))
    c512, gtc512 = colored_squares(512, 512)
    c384, gtc384 = colored_squares(512, 384)
    vc512 = torch.from_numpy(c512).to(dev)
    vc384 = torch.from_numpy(c384).to(dev)

    def resident_path():
        return dict(
            r512=ct.segment_resident(ug512, pt),
            r1k=ct.segment_resident(ug1k, pt),
            s8=ct.segment_stack_resident_fixed(stacks[0][0], pt,
                                               iters=MAIN_FIXED_ITERS)[1],
            s4=ct.segment_stack_resident_fixed(stacks[1][0], pt,
                                               iters=MAIN_FIXED_ITERS)[1],
            c512=ct.segment_resident_fixed(vc512, pv,
                                           iters=MAIN_FIXED_ITERS)[1],
            c384=ct.segment_resident_fixed(vc384, pv,
                                           iters=MAIN_FIXED_ITERS)[1])

    for r in RESIDENT.values():
        r["wrapper"].launches = 0
    got = resident_path()
    torch.cuda.synchronize()
    for name, r in RESIDENT.items():
        res_stats[name]["launches"] = r["wrapper"].launches
    f512 = ct.segment_fused(ug512, pt)
    f1k = ct.segment_fused(ug1k, pt)
    with plain_route():
        ref = resident_path()
    torch.cuda.synchronize()
    checks = {}
    for key, gt in (("r512", gt512), ("r1k", gt1k)):
        checks[f"{key} IoU vs truth"] = (iou_phases(got[key].mask.cpu(), gt),
                                         0.99)
        checks[f"{key} IoU vs plain route"] = (
            iou(got[key].mask.cpu(), ref[key].mask.cpu()), 0.999)
    for key, (_, gts) in (("s8", stacks[0]), ("s4", stacks[1])):
        checks[f"{key} min frame IoU vs truth"] = (
            min(iou_phases(m, g) for m, g in zip(got[key].cpu(), gts)), 0.99)
        checks[f"{key} IoU vs plain route"] = (
            iou(got[key].cpu(), ref[key].cpu()), 0.999)
    for key, gt in (("c512", gtc512), ("c384", gtc384)):
        checks[f"{key} IoU vs truth"] = (iou_phases(got[key].cpu(), gt), 0.99)
        checks[f"{key} IoU vs plain route"] = (
            iou(got[key].cpu(), ref[key].cpu()), 0.999)
    print(f"phase 7 resident slice: segment_resident 512^2 {got['r512'].iters}"
          f" iters (plain route {ref['r512'].iters}, segment_fused "
          f"{f512.iters}), 1024x896 {got['r1k'].iters} (plain "
          f"{ref['r1k'].iters}, fused {f1k.iters}); stacks and RGB "
          f"{MAIN_FIXED_ITERS} fixed iterations; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in checks.items())
          + "; IoU vs truth up to the swap of the two phases; launches "
          + ", ".join(f"{n}={res_stats[n]['launches']}" for n in RESIDENT),
          flush=True)
    for key, fused in (("r512", f512), ("r1k", f1k)):
        res = got[key]
        if not res.iters < pt.max_iter:
            raise AssertionError(f"{key} did not converge within max_iter")
        if abs(res.iters - fused.iters) > 16:
            raise AssertionError(f"{key}: {res.iters} iterations against "
                                 f"segment_fused's {fused.iters}")
        if not torch.isfinite(res.phi).all():
            raise AssertionError(f"non-finite level set ({key})")
    check_masks(checks)
    for name, st in res_stats.items():
        if st["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    # phase 8: the resident drivers' throughput beside the per-iteration
    # fused driver (K1/K4) on the same input and iterations
    per_iter = {}
    for tag, u, lam in (
            ("256^2 gray", torch.from_numpy(two_disks(256, 256)[0]).to(dev),
             {}),
            ("512^2 RGB lambda1=(1.0, 1.2, 0.8)",
             torch.from_numpy(colored_squares(512, 512)[0]).to(dev),
             dict(lambda1=LAMBDAS["lambda1"])),
            ("1024^2 gray",
             torch.from_numpy(two_disks(1024, 1024)[0]).to(dev), {})):
        n_pix = u.shape[0] * u.shape[1]
        res_ms = time_ms(lambda: ct.segment_resident_fixed(
            u, p, iters=THROUGHPUT_ITERS, **lam), 2)
        fused_ms = time_ms(lambda: ct.segment_fused_fixed(
            u, p, iters=THROUGHPUT_ITERS, **lam), 1)
        per_iter[tag] = res_ms / THROUGHPUT_ITERS
        print(f"phase 8 throughput {tag}, {THROUGHPUT_ITERS} iters: "
              f"segment_resident_fixed {res_ms:.3f} ms = "
              f"{n_pix * THROUGHPUT_ITERS / (res_ms * 1e3):.1f} "
              f"Mpixel-iters/s; segment_fused_fixed {fused_ms:.3f} ms = "
              f"{n_pix * THROUGHPUT_ITERS / (fused_ms * 1e3):.1f} "
              f"Mpixel-iters/s [{card}]", flush=True)
    # time per iteration = fixed + per-pixel x pixels: the fixed part (two
    # grid syncs and the all-block reduction) from the 256^2 and 1024^2 runs
    t256, t1k = per_iter["256^2 gray"], per_iter["1024^2 gray"]
    print(f"phase 8 resident per-iteration cost: 256^2 {t256 * 1e3:.3f} us, "
          f"1024^2 {t1k * 1e3:.3f} us; fixed part (16 t256 - t1024) / 15 = "
          f"{(16 * t256 - t1k) / 15 * 1e3:.3f} us [{card}]", flush=True)

    # phase 9: each multiphase kernel against its plain version, on the
    # main path's inputs (the four-regions image, the init_multiphase
    # start) at the shapes the main path gives it
    pm = ct.CVParams(mu=MU_MP, max_iter=500)
    mp_stats = {name: dict(max_abs_err=0.0) for name in MP2}
    for name, kern in MP2.items():
        for h, w in kern["shapes"]:
            inputs = mp2_inputs(h, w, dev, pm)
            err = check_mp2(name, kern, *inputs, pm, f"{h}x{w}")
            st = mp_stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if (h, w) == kern["timed"]:
                (st["ms"], st["plain_ms"], st["bound_ms"],
                 st["bound_by"]) = time_mp2(name, kern, *inputs, pm)
                st["timed"] = f"{h}x{w}"
    print("phase 9 timed: " + ", ".join(
        f"{n} at {v['timed']} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f}, "
        f"bound {v['bound_ms']:.4f} {v['bound_by']})"
        for n, v in mp_stats.items())
        + f" (resident: {MP2_CHUNK} iterations a launch) [{card}]",
        flush=True)
    sweep_t = check_sweep_no_sync(dev, pm)
    sweep_b = {"4K": bound_sweep(H4K, W4K)[0],
               "512^2": bound_sweep(512, 512)[0]}
    print("phase 9 K1 fused_sweep ran under set_sync_debug_mode('error') "
          "without a synchronization; queued ms a launch: " + ", ".join(
              f"{tag} {'parity 1' if par else 'no parity'} {ms:.4f} (bound "
              f"{sweep_b[tag]:.4f})" for (tag, par), ms in sweep_t.items())
          + f" [{card}]", flush=True)

    # phase 10: multiphase through the user entry points. The auto route
    # sends 512^2 to K10, 1024^2 to K9 resident and 4K to K9 banded;
    # segment_multiphase_fixed excludes the resident route (K9 banded at
    # 512^2); M = 3 gray and M = 2 RGB take fused_sweep per level set
    mp_imgs = {}
    for tag, (h, w) in (("512^2", (512, 512)), ("1024^2", (1024, 1024)),
                        ("4K", (H4K, W4K))):
        img, gt = four_regions(h, w)
        mp_imgs[tag] = (torch.from_numpy(img).to(dev), gt)
    rgb512, gt_rgb = rgb_four_regions(512, 512)
    v512 = torch.from_numpy(rgb512).to(dev)
    u512 = mp_imgs["512^2"][0]
    routes = {tag: mpm._mp2_route(u, pm, 2, None)
              for tag, (u, _) in mp_imgs.items()}

    def multiphase_path(use_pallas):
        sweeps = True if use_pallas is None else use_pallas
        out = {tag: ct.segment_multiphase(u, pm, use_pallas=use_pallas)
               for tag, (u, _) in mp_imgs.items()}
        out["fixed"] = ct.segment_multiphase_fixed(u512, pm, iters=20,
                                                   use_pallas=use_pallas)
        out["m3"] = ct.segment_multiphase(u512, pm, m_sets=3,
                                          use_pallas=sweeps)
        out["rgb"] = ct.segment_multiphase(v512, pm, m_sets=2,
                                           use_pallas=sweeps)
        return out

    for kern in MP2.values():
        kern["wrapper"].launches = 0
    got = multiphase_path(None)
    torch.cuda.synchronize()
    for name, kern in MP2.items():
        mp_stats[name]["launches"] = kern["wrapper"].launches
    ref = multiphase_path(False)
    torch.cuda.synchronize()
    checks = {}
    for tag, (_, gt) in mp_imgs.items():
        checks[f"{tag} accuracy vs truth"] = (
            best_accuracy(got[tag].labels.cpu(), gt), 0.99)
        checks[f"{tag} label agreement vs use_pallas=False"] = (
            1.0 - label_frac(got[tag].phis, ref[tag].phis), 0.999)
    checks["RGB M=2 accuracy vs truth"] = (
        best_accuracy(got["rgb"].labels.cpu(), gt_rgb), 0.99)
    checks["RGB M=2 label agreement vs use_pallas=False"] = (
        1.0 - label_frac(got["rgb"].phis, ref["rgb"].phis), 0.999)
    checks["gray M=3 label agreement vs use_pallas=False"] = (
        1.0 - label_frac(got["m3"].phis, ref["m3"].phis), 0.99)
    e_got, e_ref = got["fixed"].energy.double(), ref["fixed"].energy.double()
    energy_rel = float(((e_got - e_ref).abs() / e_ref.abs()).max())
    print(f"phase 10 multiphase slice: routes {routes}; segment_multiphase "
          + ", ".join(f"{t} {got[t].iters} iters (plain {ref[t].iters})"
                      for t in list(mp_imgs) + ["rgb", "m3"])
          + f"; segment_multiphase_fixed 512^2 20 iterations energy rel "
          f"{energy_rel:.3e} (bar 1e-3), labels agree at "
          f"{1.0 - label_frac(got['fixed'].phis, ref['fixed'].phis):.6f}; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in
                      checks.items())
          + "; launches " + ", ".join(f"{n}={mp_stats[n]['launches']}"
                                     for n in MP2), flush=True)
    if routes != {"512^2": "resident", "1024^2": "resident",
                  "4K": "banded"}:
        raise AssertionError(f"unexpected multiphase routes {routes}")
    for key in list(mp_imgs) + ["rgb"]:
        if not got[key].iters < pm.max_iter:
            raise AssertionError(f"multiphase {key} did not converge within "
                                 f"max_iter")
    for key, res in got.items():
        if not torch.isfinite(res.phis).all():
            raise AssertionError(f"non-finite multiphase level sets ({key})")
    if not energy_rel <= 1e-3:
        raise AssertionError(f"segment_multiphase_fixed energy differs from "
                             f"the plain route by {energy_rel}")
    check_masks(checks)
    for name, st in mp_stats.items():
        if st["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    # phase 11: multiphase throughput, segment_multiphase(fixed=True) at
    # the eval config 3 / multiphase-mp2 shape (512^2, K10), 1024^2 (K9
    # resident) and 4K (K9 banded, 100 iterations); at 512^2 also K9
    # resident called directly and the per-iteration banded loop
    mp_rate = {}
    for tag, iters in (("512^2", THROUGHPUT_ITERS),
                       ("1024^2", THROUGHPUT_ITERS), ("4K", 100)):
        u = mp_imgs[tag][0]
        ms = time_ms(lambda: ct.segment_multiphase(u, pm, fixed=True,
                                                   max_iter=iters), 1)
        mp_rate[tag] = (routes[tag], iters, ms,
                        u.numel() * iters / (ms * 1e3))
    start512 = mpm.init_multiphase((512, 512), 2, device=dev)
    flat_ms = time_ms(lambda: multiphase_kernel.mp2_resident_iterations(
        start512, u512, pm, THROUGHPUT_ITERS), 1)
    band_ms = time_ms(lambda: mpm._mp2_banded_loop(
        u512, pm, start512, True, THROUGHPUT_ITERS), 1)
    print("phase 11 multiphase throughput, segment_multiphase(fixed=True): "
          + ", ".join(f"{t} {r} {it} iters {ms:.3f} ms = {rate:.1f} "
                      f"Mpixel-iters/s" for t, (r, it, ms, rate)
                      in mp_rate.items())
          + f"; 512^2 K9 resident direct {flat_ms:.3f} ms = "
          f"{512 * 512 * THROUGHPUT_ITERS / (flat_ms * 1e3):.1f}, "
          f"per-iteration banded loop {band_ms:.3f} ms = "
          f"{512 * 512 * THROUGHPUT_ITERS / (band_ms * 1e3):.1f} "
          f"Mpixel-iters/s [{card}]", flush=True)
    # fixed cost per coupled iteration of K9 resident (three grid syncs and
    # the all-block means reduction), as phase 8
    per_iter = {}
    for h in (256, 1024):
        u = torch.from_numpy(four_regions(h, h)[0]).to(dev)
        start = mpm.init_multiphase((h, h), 2, device=dev)
        per_iter[h] = time_ms(
            lambda: multiphase_kernel.mp2_resident_iterations(
                start, u, pm, THROUGHPUT_ITERS), 1) / THROUGHPUT_ITERS
    print(f"phase 11 K9 resident per-iteration cost (3 grid syncs an "
          f"iteration): 256^2 {per_iter[256] * 1e3:.3f} us, 1024^2 "
          f"{per_iter[1024] * 1e3:.3f} us; fixed part (16 t256 - t1024) / "
          f"15 = {(16 * per_iter[256] - per_iter[1024]) / 15 * 1e3:.3f} us "
          f"[{card}]", flush=True)

    mo_stats = morph_phases(dev, card)
    sk_stats = stack_phases(dev, card, u4k, v4k.permute(2, 0, 1).contiguous())
    sh_stats = shard_phases(dev, card, u4k, gt4k, v4k, gtc4k)
    ms_stats = mp_morph_shard_phases(dev, card)
    ha_stats = halo_phases(dev, card, u4k, gt4k)
    sass_checked = band_phase(dev, card, u4k, gt4k, v4k, gtc4k, stats,
                              sh_stats, sass_parent)
    mp2_band_phase(dev, card, mp_stats["K9 mp2_iteration"],
                   ms_stats["K9 mp2_iteration_sharded"])
    sweep_phase(dev, card, u4k, gt4k, v4k, gtc4k, {
        "K1 fused_iteration": stats["K1 fused_iteration"],
        "K4 fused_iteration_mc": stats["K4 fused_iteration_mc"],
        "K1 fused_sweep": mp_stats["K1 fused_sweep"],
        "K1 fused_iteration_batch": sk_stats["K1 fused_iteration_batch"],
        "K1 fused_iteration (shard)": sh_stats["K1 fused_iteration (shard)"],
        "K1 fused_sweep (parity)": ms_stats["K1 fused_sweep (parity)"]})
    morph_bits_phase(dev, card, mo_stats, ms_stats, sass_checked)
    resident_tile_phase(dev, card, sass_checked)
    re_stats = reinit_phase(dev, card, u4k, gt4k)
    ckpt_phase(dev, card, u4k, gt4k)
    hooks_phase(dev, card, u4k)

    entries = [
        dict(name=name, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=st["launches"],
             max_abs_err=st["max_abs_err"], ms=st["ms"],
             plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
             bound_by=st["bound_by"], library_ms=st.get("library_ms"))
        for table, stat in ((KERNELS, stats), (RESIDENT, res_stats),
                            (MP2, mp_stats), (MORPH, mo_stats),
                            (STACK, sk_stats), (SHARD, sh_stats),
                            (MP_SHARD, ms_stats), (HALO, ha_stats),
                            (REINIT, re_stats))
        for name, k in table.items() for st in (stat[name],)]
    print(json.dumps({"kernels": entries}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
