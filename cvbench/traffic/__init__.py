"""Traffic: each mix is a JSON file of parameters (``<mix>.json``), read
by the generator module it names under ``"generator"``, by default
:mod:`.generator`. A generator module has ``pool(mix, seed, device)``,
which returns the mix's inputs for the seed."""

from .. import spec


def pool(mix, seed: int, device):
    """The inputs of ``mix`` for ``seed``, from its generator."""
    return spec.module("traffic", mix.get("generator", "generator")).pool(
        mix, seed, device)
