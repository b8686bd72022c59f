"""The port stands alone: importing every module of it loads no JAX and
nothing of the JAX package, and no source of it (nor chip_smoke.py, nor
the port's scripts ``scripts/torch_*.py``) names such an import."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "recommendsystem_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "recommendsystem_tpu")

_PROBE = """
import importlib, pkgutil, sys
import recommendsystem_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in {forbidden!r})
print("LOADED", len([n for n in sys.modules
                     if n.startswith("recommendsystem_tpu_torch")]))
print("BAD", bad)
"""


def _sources():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("torch_*.py")))


def test_import_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    loaded = int(out.stdout.split("LOADED ")[1].split()[0])
    assert loaded >= 20          # every subpackage and module was imported


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"
