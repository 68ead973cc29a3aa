"""What the harness loads: no module of JAX or of the JAX package, compared
by whole top-level names (``pmarlo_tpu_torch`` is the port and is allowed
outside ``reference/``), and nothing of the port in the reference."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO, TINY

FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "pmarlo_tpu"}
SOURCES = sorted(p for p in (REPO / "portbench").rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = set(_top_level_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.parts:
        assert "pmarlo_tpu_torch" not in names
        assert not any(n.startswith("pmarlo") for n in names)


def test_a_run_loads_neither_jax_nor_the_jax_package(checkout):
    code = f"""
import io, sys, time
sys.path.insert(0, {str(checkout)!r})
from portbench.harness import run_cell, forbidden_modules
from portbench import check, control, generator, roofline, trace
rc = run_cell({TINY + '.fused'!r}, 7, 0.1, False, time.perf_counter(), device="cpu",
              out=io.StringIO(), err=io.StringIO())
mods = {{m.split(".")[0] for m in sys.modules}}
print(rc, sorted(mods & set({sorted(FORBIDDEN)!r})), forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=checkout)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "0 [] []"


def test_the_reference_loads_nothing_of_the_port():
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import portbench.reference.md, portbench.reference.params
print(sorted(m for m in sys.modules if m.split(".")[0].startswith("pmarlo")))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "[]"
