"""The port imports neither JAX nor anything of ``cg_mrslam_tpu``: checked on
the sources (every import statement of the package and of
``chip_smoke.py``) and at run time (importing every module in a fresh
interpreter where ``jax`` cannot be imported).

The solver's two CG bands (``solver/chain.py``, ``solver/pcg.py``) import
nothing of each other, and no module of the port takes a private name of
either: what they share lives below both (``solver/cyclic_reduction.py``,
``solver/gather.py``, ``solver/spd.py``, ``solver/fixed_sum.py``)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "cg_mrslam_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cg_mrslam_tpu")
BANDS = {"chain.py": "cg_mrslam_tpu_torch.solver.chain",
         "pcg.py": "cg_mrslam_tpu_torch.solver.pcg"}


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _imported_names(path):
    """Every module an import statement names, and for ``from m import a``
    also ``m.a`` (the name may be a module)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _band_names(path):
    """``(band, name)`` for every name the source takes from a band: each
    ``from <band> import name``, and each attribute read of a band module
    (through an alias such as ``from ...solver import chain as CH``, or
    by its full dotted name)."""
    tree = ast.parse(path.read_text(), str(path))
    bands = set(BANDS.values())
    alias = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                if node.module in bands:
                    yield node.module, a.name
                elif f"{node.module}.{a.name}" in bands:
                    alias[a.asname or a.name] = f"{node.module}.{a.name}"
        elif isinstance(node, ast.Import):
            alias.update((a.asname, a.name) for a in node.names
                         if a.asname and a.name in bands)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            owner = ast.unparse(node.value)
            if owner in alias or owner in bands:
                yield alias.get(owner, owner), node.attr


@pytest.mark.parametrize("band", sorted(BANDS))
def test_bands_import_nothing_of_each_other(band):
    other = next(m for f, m in BANDS.items() if f != band)
    path = PKG / "solver" / band
    bad = [m for m in _imported_names(path)
           if m == other or m.startswith(other + ".")]
    bad += [f"{m}.{a}" for m, a in _band_names(path) if m == other]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_private_band_name_taken(path):
    bad = [f"{m}.{a}" for m, a in _band_names(path) if a.startswith("_")]
    assert not bad, f"{path.relative_to(ROOT)} takes {bad}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'cg_mrslam_tpu'):\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cg_mrslam_tpu') and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok', len(" f"{modules!r}" "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
