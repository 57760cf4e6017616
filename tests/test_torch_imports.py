"""The port imports neither JAX nor anything of ``cg_mrslam_tpu``: checked on
the sources (every import statement of the package and of
``chip_smoke.py``) and at run time (importing every module in a fresh
interpreter where ``jax`` cannot be imported)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "cg_mrslam_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cg_mrslam_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


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
