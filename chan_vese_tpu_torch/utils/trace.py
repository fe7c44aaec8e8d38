"""Energy-trace artifacts and parity diffing (numpy only).

Counterpart of ``chan_vese_tpu/utils/trace.py``. The fixed-iteration
drivers keep their per-iteration energy, delta and means on the device
(stacked tensors); :func:`write_energy_csv` moves each column to the host
once, when the run has ended, and writes the same CSV bytes as the
reference for the same values: the parity artifact of BASELINE.json:5
("energy-trace agreement <= 1e-5 at fixed iteration count").
"""

from __future__ import annotations

import csv

import numpy as np

from .image_io import host_array


def write_energy_csv(path, energy, delta=None, c1=None, c2=None) -> None:
    energy = host_array(energy)
    cols = {"iter": np.arange(1, len(energy) + 1), "energy": energy}
    if delta is not None:
        cols["delta"] = host_array(delta)
    for name, c in (("c1", c1), ("c2", c2)):
        if c is None:
            continue
        c = host_array(c)
        if c.ndim == 1:
            cols[name] = c
        else:
            for ch in range(c.shape[1]):
                cols[f"{name}_{ch}"] = c[:, ch]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(cols.keys())
        for row in zip(*cols.values()):
            w.writerow([f"{v:.17g}" if isinstance(v, float)
                        or hasattr(v, "dtype") else v for v in row])


def read_energy_csv(path):
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    return {k: np.asarray([float(row[k]) for row in rows])
            for k in rows[0].keys()}


def trace_parity(path_a, path_b, column: str = "energy",
                 allow_prefix: bool = False):
    """Max relative deviation between two trace CSVs (the parity number).

    The parity criterion is "at fixed iteration count", so traces of
    different lengths are an error unless allow_prefix=True (compare the
    common prefix explicitly).
    """
    a = read_energy_csv(path_a)[column]
    b = read_energy_csv(path_b)[column]
    if len(a) == 0 or len(b) == 0:
        raise ValueError("empty traces")
    if len(a) != len(b) and not allow_prefix:
        raise ValueError(f"trace lengths differ ({len(a)} vs {len(b)}); "
                         f"pass allow_prefix=True to compare the prefix")
    n = min(len(a), len(b))
    rel = np.abs(a[:n] - b[:n]) / np.maximum(np.abs(b[:n]), 1e-30)
    return float(rel.max())
