"""End-to-end demo: synthesize images, run every model family, write
artifacts into OUT (masks, label maps, the energy trace as ``.npy`` and
``.csv``; the mask, overlay and label images as PNG where Pillow is
installed).

    python -m chan_vese_tpu_torch.demo [OUT] [--device cpu]

Runs on the first CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch


def _have_pillow() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def main(outdir="demo_out", device=None):
    from . import (CVParams, segment_fixed, segment_fused,
                   segment_multiphase, segment_vector)
    from .utils import image_io, trace

    device = torch.device("cuda", 0) if device is None else torch.device(
        device)
    out = Path(outdir)
    out.mkdir(exist_ok=True)
    pngs = _have_pillow()
    if not pngs:
        print("Pillow is missing: skipping the PNG images (the .npy and "
              ".csv artifacts are written)")

    def images(name, write):
        if pngs:
            write(out / f"{name}.png")

    rng = np.random.default_rng(0)
    p = CVParams(init="circle")

    # --- scalar grayscale ------------------------------------------------
    i, j = np.mgrid[0:256, 0:256].astype(float)
    gray = np.where((np.hypot(i - 80, j - 90) < 40)
                    | (np.hypot(i - 170, j - 170) < 50), 217.0, 38.0)
    gray += 8 * rng.standard_normal(gray.shape)
    u = torch.from_numpy(gray).to(device, torch.float32)
    res = segment_fused(u, p)
    print(f"scalar: {int(res.iters)} iters, c1={float(res.c1):.1f}, "
          f"c2={float(res.c2):.1f}")
    image_io.save_mask(out / "scalar_mask.npy", res.mask)
    images("scalar_mask", lambda f: image_io.save_mask(f, res.mask))
    images("scalar_overlay",
           lambda f: image_io.save_overlay(f, gray, res.mask))

    # energy trace
    tr = segment_fixed(u, p, iters=60)
    trace.write_energy_csv(out / "scalar_trace.csv", tr.energy, tr.delta,
                           tr.c1, tr.c2)

    # --- vector-valued RGB ----------------------------------------------
    rgb = np.full((256, 256, 3), (30.0, 40.0, 50.0))
    rgb[40:120, 40:150] = (230.0, 200.0, 60.0)
    rgb[150:220, 120:230] = (210.0, 60.0, 230.0)
    rgb += 5 * rng.standard_normal(rgb.shape)
    res = segment_vector(torch.from_numpy(rgb).to(device, torch.float32), p,
                         lambda1=(1.0, 1.2, 0.8))
    print(f"rgb: {int(res.iters)} iters, "
          f"c1={res.c1.cpu().numpy().round(0)}")
    image_io.save_mask(out / "rgb_mask.npy", res.mask)
    images("rgb_overlay", lambda f: image_io.save_overlay(f, rgb, res.mask))

    # --- multiphase (4 phases) -------------------------------------------
    vals = np.array([13.0, 89.0, 166.0, 242.0])
    lab = (i > 128).astype(int) * 2 + (j > 128).astype(int)
    mp_img = vals[lab] + 4 * rng.standard_normal(lab.shape)
    res = segment_multiphase(torch.from_numpy(mp_img).to(device,
                                                         torch.float32),
                             CVParams(mu=0.003 * 255 ** 2), m_sets=2)
    print(f"multiphase: {int(res.iters)} iters, "
          f"{len(torch.unique(res.labels))} phases used")
    image_io.save_labels(out / "multiphase_labels.npy", res.labels)
    images("multiphase_labels",
           lambda f: image_io.save_labels(f, res.labels))

    print(f"artifacts in {out}/")


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = None
    if "--device" in args:
        k = args.index("--device")
        dev = args[k + 1]
        del args[k:k + 2]
    main(*args, device=dev)
