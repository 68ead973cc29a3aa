"""The port's copies of JAX-free numpy modules stay equal to their sources.

The card's host has no JAX, and the JAX package's ``__init__`` files import
it, so ``pmarlo_tpu_torch`` carries its own copies of the host modules it
needs. Each copy is its source plus one docstring line naming it; relative
imports resolve inside the port. Lines naming a reference checkout by
absolute path are compared with the path prefix dropped.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

COPIES = [
    "constants.py", "utils/errors.py", "utils/input_parsing.py",
    "utils/thermodynamics.py", "utils/msm_utils.py", "utils/scc.py",
    "io/pdb.py", "data/__init__.py", "md/topology.py", "md/residues.py",
    "md/nucleic.py", "md/ff_params.py", "md/gbn2.py", "msm/estimation.py",
    "msm/free_energy.py", "msm/fes_smoothing.py", "features/pairs.py",
    "analysis/validation.py", "analysis/discretize.py",
]


def _note(rel):
    return (f"Host copy of ``pmarlo_tpu/{rel}``; "
            "tests/unit/test_torch_host_copies.py holds the two equal.")


def _normalise(text):
    text = re.sub(r"/[A-Za-z_]+/reference/", "", text)
    # relative imports name the same modules in both packages
    text = re.sub(r"\bpmarlo_tpu_torch\b", "pmarlo_tpu", text)
    return text


def _split_docstring(text):
    """(module docstring, source lines after it)."""
    node = ast.parse(text).body[0]
    assert isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
    return node.value.value, text.splitlines()[node.end_lineno:]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_source(rel):
    src = _normalise((ROOT / "pmarlo_tpu" / rel).read_text())
    copy = _normalise((ROOT / "pmarlo_tpu_torch" / rel).read_text())
    src_doc, src_body = _split_docstring(src)
    copy_doc, copy_body = _split_docstring(copy)
    note = _note(rel)
    assert note in copy_doc, f"{rel}: the copy's docstring must name its source"
    assert copy_doc.replace("\n" + note + "\n", "").rstrip() == src_doc.rstrip()
    assert copy_body == src_body, f"pmarlo_tpu_torch/{rel} drifted from its source"


def test_shipped_neck_tables_are_copied():
    a = (ROOT / "pmarlo_tpu" / "data" / "gbn2_neck_tables.npz").read_bytes()
    b = (ROOT / "pmarlo_tpu_torch" / "data" / "gbn2_neck_tables.npz").read_bytes()
    assert a == b
