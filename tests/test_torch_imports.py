"""repro_torch stands alone: importing it and every submodule loads neither
jax nor the JAX package, and no module of it (nor chip_smoke.py) imports
them, nor ``torch.testing`` (the dry-run registers its own fake process
group backend)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
new = {"repro_torch.core.faults", "repro_torch.core.stability",
       "repro_torch.analysis.stability_check", "repro_torch.launch.dryrun",
       "repro_torch.launch.hillclimb", "repro_torch.analysis.sanitizers",
       "repro_torch.analysis.astutil", "repro_torch.analysis.lint",
       "repro_torch.analysis.rules", "repro_torch.analysis.__main__"}
assert new <= set(names), sorted(new - set(names))
print(len(names), bad)
assert not bad, bad
"""


def test_import_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 51


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"
        assert not name.startswith("torch.testing"), f"{path}: {name}"
