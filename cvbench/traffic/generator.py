"""The benchmark's one traffic generator: seeded scenes of disks and
ellipses on a flat or four-quadrant background, plus Gaussian noise.

A traffic mix is a JSON file beside this module (``<mix>.json``) that
holds nothing but parameters:

- ``size`` [H, W]; ``channels`` (0 for a gray image, C for an (H, W, C)
  one); ``frames`` (0 for one image a call, N for an (N, H, W) stack);
  ``pool``: the number of distinct inputs the calls cycle through.
- ``background``: ``{"value": [lo, hi]}`` (a level drawn per frame; for
  C channels a list of C ranges) or ``{"quadrants": [[colour] x 4],
  "split": [lo, hi]}`` (the four quadrants, split at a row and a column
  drawn as a share of the side).
- ``shapes``: groups of ``{"kind": "disk" | "ellipse", "count": [lo, hi],
  "radius": [lo, hi]}`` (an ellipse's two semi-axes each drawn from
  ``radius``, its angle uniform), with ``"value": [lo, hi]`` (gray) or
  ``"palette": [[colour], ...]`` (C channels), and optionally ``"offset":
  r``: the centre within r pixels of the middle in each axis (else
  anywhere in the image). A disk group may instead list its disks,
  ``"dealt": [[radius, dy, dx], ...]`` (the centre's offset from the
  middle), one for each input of the pool: the seed deals them to the
  inputs in its own order, so every seed gives the same set of shapes (and
  of work, where the shape sets how long a call runs) with its own noise.
- ``noise``: the standard deviation of the Gaussian noise; ``clip``:
  optionally [lo, hi].

The scene parameters come from ``numpy.random.default_rng(seed)`` and the
noise from a ``torch.Generator`` on the device, in one call per input:
the same seed and device give the same pool.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _seed64(seed: int) -> int:
    return int(seed) % (1 << 63)


def _draw(rng, rangespec):
    """A uniform draw from [lo, hi]."""
    lo, hi = (float(v) for v in rangespec)
    return rng.uniform(lo, hi)


def _scene_params(rng, mix, frames, dealt):
    """The shapes and background of every frame of one pool input, whose
    listed groups take their ``dealt``-th disk: a list (one per frame) of
    (background, [(cy, cx, a, b, angle, value), ...])."""
    h, w = mix["size"]
    nchan = mix.get("channels", 0)
    bg_spec = mix["background"]
    scenes = []
    for _ in range(frames):
        if "quadrants" in bg_spec:
            bg = ("quadrants", [_draw(rng, bg_spec["split"]) * h,
                                _draw(rng, bg_spec["split"]) * w],
                  bg_spec["quadrants"])
        elif nchan:
            bg = ("flat", [_draw(rng, r) for r in bg_spec["value"]])
        else:
            bg = ("flat", _draw(rng, bg_spec["value"]))
        shapes = []
        for group in mix.get("shapes", []):
            if "dealt" in group:
                if group["kind"] != "disk":
                    raise ValueError("only disks are dealt from a list")
                r, dy, dx = (float(v) for v in group["dealt"][dealt])
                shapes.append(((h - 1) / 2.0 + dy, (w - 1) / 2.0 + dx, r, r,
                               0.0, _draw(rng, group["value"])))
                continue
            lo, hi = group["count"]
            for _ in range(int(rng.integers(lo, hi + 1))):
                a = _draw(rng, group["radius"])
                if group["kind"] == "disk":
                    b, angle = a, 0.0
                elif group["kind"] == "ellipse":
                    b, angle = _draw(rng, group["radius"]), rng.uniform(
                        0.0, math.pi)
                else:
                    raise ValueError(f"unknown shape {group['kind']!r}")
                if "offset" in group:
                    r = float(group["offset"])
                    cy = (h - 1) / 2.0 + _draw(rng, (-r, r))
                    cx = (w - 1) / 2.0 + _draw(rng, (-r, r))
                else:
                    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
                if nchan:
                    pal = group["palette"]
                    value = pal[int(rng.integers(len(pal)))]
                else:
                    value = _draw(rng, group["value"])
                shapes.append((cy, cx, a, b, angle, value))
        scenes.append((bg, shapes))
    return scenes


def _render(scenes, mix, device):
    """Every frame of one input without its noise, in a few calls over all
    frames at once: (F, H, W) or (F, H, W, C) float32 on ``device``."""
    h, w = mix["size"]
    nchan = mix.get("channels", 0)
    f32 = dict(dtype=torch.float32, device=device)
    yy = torch.arange(h, **f32)[None, :, None]
    xx = torch.arange(w, **f32)[None, None, :]

    def col(values):  # one value (or colour) a frame, broadcast to pixels
        t = torch.tensor(values, **f32)
        return t[:, None, None] if t.dim() == 1 else t[:, None, None, :]

    kinds = {bg[0] for bg, _ in scenes}
    if kinds == {"quadrants"}:
        sy = col([bg[1][0] for bg, _ in scenes])
        sx = col([bg[1][1] for bg, _ in scenes])
        colours = torch.tensor(scenes[0][0][2], **f32)
        # the recipe's order: top-left 0, top-right 1, bottom-left 2, ...
        img = colours[(yy >= sy).long() * 2 + (xx >= sx).long()]
        if not nchan:
            img = img[..., 0]
    elif kinds == {"flat"}:
        level = col([bg[1] for bg, _ in scenes])
        img = level.expand((len(scenes), h, w, nchan) if nchan
                           else (len(scenes), h, w))
    else:
        raise ValueError(f"one background kind a mix, got {kinds}")
    for slot in range(max(len(shapes) for _, shapes in scenes)):
        # frames with fewer shapes get one far outside the image here
        none = (-1e9, -1e9, 1.0, 1.0, 0.0, [0.0] * nchan if nchan else 0.0)
        rows = [shapes[slot] if slot < len(shapes) else none
                for _, shapes in scenes]
        cy, cx, a, b, angle, value = (list(v) for v in zip(*rows))
        ca = col([math.cos(t) for t in angle])
        sa = col([math.sin(t) for t in angle])
        dy, dx = yy - col(cy), xx - col(cx)
        u = (dx * ca + dy * sa) / col(a)
        v = (-dx * sa + dy * ca) / col(b)
        inside = (u * u + v * v) < 1.0
        img = torch.where(inside[..., None] if nchan else inside,
                          col(value), img)
    return img


def pool(mix, seed: int, device):
    """The mix's ``pool`` inputs for ``seed``: a list of (H, W[, C])
    tensors, or (N, H, W) stacks, float32 on ``device``."""
    rng = np.random.default_rng(_seed64(seed))
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed64(seed))
    n_pool, frames = int(mix["pool"]), int(mix.get("frames", 0))
    if frames and mix.get("channels", 0):
        raise ValueError("a stack of C-channel frames is not a mix yet")
    # the order in which the seed deals a group's listed disks
    deal = rng.permutation(n_pool)
    inputs = []
    for index in range(n_pool):
        img = _render(_scene_params(rng, mix, max(frames, 1), deal[index]),
                      mix, device)
        img = img + float(mix["noise"]) * torch.randn(
            img.shape, generator=gen, device=device)
        if "clip" in mix:
            img = img.clamp(*mix["clip"])
        inputs.append(img.contiguous() if frames else img[0].contiguous())
    return inputs
