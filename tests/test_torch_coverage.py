"""The port covers the JAX package, read from the source with ``ast``:

- every public top-level function of each ``chan_vese_tpu/**/*.py`` is
  defined at the top level of the port's file of the same path, but for
  the listed exceptions;
- every option of ``chan_vese_tpu/cli.py``'s parser is an option of the
  port's parser;
- no module of the port (nor ``chip_smoke.py``, the ``chip_*`` scripts and
  ``sass_diff.py``) imports ``jax`` or ``chan_vese_tpu``.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF, PORT = REPO / "chan_vese_tpu", REPO / "chan_vese_tpu_torch"

# reference modules with no counterpart of the same path, and why
NO_COUNTERPART = {
    # the Pallas kernels: each is a row of PERF.md's kernel table, ported
    # to csrc/ and wrapped in ops/*_kernel.py
    "ops/pallas_banded.py": "K2, K5 (ops/banded_kernel.py)",
    "ops/pallas_morph.py": "K11, K12 (ops/morph_kernel.py)",
    "ops/pallas_multiphase.py": "K9 (ops/multiphase_kernel.py)",
    "ops/pallas_packed.py": "K3, K6, K8, K10, K13 (ops/packed_kernel.py)",
    "ops/pallas_resident.py": "K7 (ops/resident_kernel.py)",
    "ops/pallas_sweep.py": "K1 (ops/fused_kernel.py)",
    "ops/pallas_sweep_mc.py": "K4 (ops/fused_kernel_mc.py)",
    # a numpy golden of the reference's tests, not part of the system
    "ops/sweep_np.py": "test golden",
}
# public functions defined elsewhere in the port: (reference file, name)
# -> the port's file that defines them
MOVED = {
    ("models/multiphase.py", "phase_means"): "ops/reductions.py",
    ("models/multiphase.py", "phase_weights"): "ops/reductions.py",
}


def top_level_defs(path, public=True):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not (public and n.name.startswith("_"))}


def reference_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", reference_modules())
def test_public_functions_have_counterparts(rel):
    if rel in NO_COUNTERPART:
        assert (REF / rel).is_file()
        return
    want = top_level_defs(REF / rel)
    if not want:
        return
    port = PORT / rel
    assert port.is_file(), f"{rel} has no counterpart"
    have = top_level_defs(port, public=False)
    missing = set()
    for name in want - have:
        moved = MOVED.get((rel, name))
        if moved is None or name not in top_level_defs(PORT / moved):
            missing.add(name)
    assert not missing, f"{rel}: {sorted(missing)}"


def test_exceptions_are_current():
    """Every listed exception names a file or function that exists."""
    for rel in NO_COUNTERPART:
        assert (REF / rel).is_file(), rel
    for (rel, name), moved in MOVED.items():
        assert name in top_level_defs(REF / rel)
        assert name not in top_level_defs(PORT / rel, public=False)
        assert name in top_level_defs(PORT / moved)


def parser_options(module):
    return {s for a in module.build_parser()._actions
            for s in a.option_strings}


def reference_options():
    from chan_vese_tpu import cli

    return sorted(parser_options(cli))


@pytest.mark.parametrize("option", reference_options())
def test_reference_cli_option_parses_in_port(option):
    from chan_vese_tpu_torch import cli

    assert option in parser_options(cli)


def port_sources():
    files = sorted(PORT.rglob("*.py"))
    files += sorted(REPO.glob("chip_*.py")) + [REPO / "sass_diff.py"]
    return [str(p.relative_to(REPO)) for p in files]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", port_sources())
def test_port_imports_no_jax(rel):
    roots = imported_roots(REPO / rel)
    assert not roots & {"jax", "jaxlib", "chan_vese_tpu"}, (rel, roots)
