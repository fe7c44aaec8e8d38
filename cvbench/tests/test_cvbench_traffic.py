"""The traffic generator: the same seed gives the same pool, another seed
another one, and every mix file is one it can read."""

import json
import sys

import pytest
import torch

from cvbench_tiny import ROOT, SMALL

from cvbench.traffic import generator

MIXES = sorted(p.stem for p in (ROOT / "cvbench" / "traffic").glob("*.json"))


def _small(name):
    mix = json.loads((ROOT / "cvbench" / "traffic" / f"{name}.json")
                     .read_text())
    mix["size"] = [48, 64]
    mix["pool"] = 3
    if mix.get("frames"):
        mix["frames"] = 3
    for group in mix["shapes"]:
        if "dealt" in group:
            group["dealt"] = [[6, -2, 3], [9, 1, -4], [12, 3, 0]]
        else:
            group["radius"] = [3, 10]
        if "offset" in group:
            group["offset"] = 4
    return mix


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_pool(name):
    mix = _small(name)
    seed = 2**33 + 11  # wider than 32 bits, as a run's seed may be
    a = generator.pool(mix, seed, torch.device("cpu"))
    b = generator.pool(mix, seed, torch.device("cpu"))
    c = generator.pool(mix, seed + 1, torch.device("cpu"))
    assert len(a) == mix["pool"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    # a fresh draw for each input of the pool
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("name", MIXES)
def test_pool_shapes(name):
    mix = _small(name)
    x = generator.pool(mix, 5, torch.device("cpu"))[0]
    h, w = mix["size"]
    want = (h, w)
    if mix.get("channels"):
        want = (h, w, mix["channels"])
    if mix.get("frames"):
        want = (mix["frames"], h, w)
    assert tuple(x.shape) == want
    assert x.dtype == torch.float32 and x.is_contiguous()
    if "clip" in mix:
        assert float(x.min()) >= mix["clip"][0]
        assert float(x.max()) <= mix["clip"][1]


def test_dealt_shapes_are_one_set_for_every_seed():
    mix = json.loads((ROOT / "cvbench" / "traffic" / "disk4k.json")
                     .read_text())
    mix["size"], mix["pool"], mix["noise"] = [120, 160], 4, 0.0
    radii = [22.5, 27.5, 32.5, 37.5]
    mix["shapes"][0]["dealt"] = [[r, 8 - 4 * k, 4 * k - 6]
                                 for k, r in enumerate(radii)]
    scenes = {}
    for seed in (1, 2**40):
        pool = generator.pool(mix, seed, torch.device("cpu"))
        scenes[seed] = pool
        # every listed disk comes out once, at its radius
        found = sorted(float((x > 100).sum() / 3.14159) ** 0.5 for x in pool)
        for r, want in zip(found, radii):
            assert abs(r - want) < 1.0, found
    # the same scenes, in another order
    a, b = scenes[1], scenes[2**40]
    assert sorted(x.sum().item() for x in a) == sorted(
        x.sum().item() for x in b)
    assert [x.sum().item() for x in a] != [x.sum().item() for x in b]


def test_mix_names_its_generator(monkeypatch):
    import types

    from cvbench import traffic
    rings = types.ModuleType("cvbench.traffic.rings")
    rings.pool = lambda mix, seed, device: [seed]
    monkeypatch.setitem(sys.modules, "cvbench.traffic.rings", rings)
    assert traffic.pool({"generator": "rings"}, 5, None) == [5]
    mix = _small("gray4k-scenes")
    assert all(torch.equal(x, y) for x, y in zip(
        traffic.pool(mix, 9, torch.device("cpu")),
        generator.pool(mix, 9, torch.device("cpu"))))
    with pytest.raises(ValueError):
        traffic.pool({"generator": "../generator"}, 5, None)


def test_small_cells_use_every_mix():
    used = {json.loads((ROOT / "cvbench" / "workloads" / f"{c}.json")
                       .read_text())["traffic"] for c in SMALL}
    assert used == set(MIXES)
