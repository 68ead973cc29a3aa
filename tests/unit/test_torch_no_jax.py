"""``pmarlo_tpu_torch`` and ``chip_smoke.py`` import with JAX, optax and
the JAX package blocked: the card's host has no JAX."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_BLOCKED_IMPORT = r'''
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "optax", "pmarlo_tpu")


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
import pmarlo_tpu_torch

names = sorted(m.name for m in pkgutil.walk_packages(
    pmarlo_tpu_torch.__path__, "pmarlo_tpu_torch."))
for name in names + EXTRA:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
'''


def _chip_smoke_imports():
    """Every module ``chip_smoke.py`` imports, at top level or inside its
    functions, and the script itself."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = {"chip_smoke"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    mods.discard("__future__")
    return sorted(mods)


def test_port_imports_without_jax():
    code = f"EXTRA = {_chip_smoke_imports()!r}\n" + _BLOCKED_IMPORT
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 25


def test_chip_smoke_imports_name_no_jax():
    for name in _chip_smoke_imports():
        assert name.split(".")[0] not in ("jax", "jaxlib", "optax", "pmarlo_tpu"), name
