"""``pmarlo_tpu_torch`` and ``chip_smoke.py`` import with JAX, optax and
the JAX package blocked: the card's host has no JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

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


#: modules the protein-scale slice added; the walk must reach each of them
NEW_MODULES = [
    "pmarlo_tpu_torch._kernels", "pmarlo_tpu_torch.md.cells",
    "pmarlo_tpu_torch.md.pair_force", "pmarlo_tpu_torch.md.constraints",
    "pmarlo_tpu_torch.md.setup", "pmarlo_tpu_torch.remd.ladder",
    "pmarlo_tpu_torch.data.chignolin", "pmarlo_tpu_torch.analysis.diagnostics",
]
#: modules the learned-CV slice added
NEW_MODULES += [
    "pmarlo_tpu_torch.features.base", "pmarlo_tpu_torch.features.builtins",
    "pmarlo_tpu_torch.features.featurize", "pmarlo_tpu_torch.utils.seed",
    "pmarlo_tpu_torch.utils.json_io", "pmarlo_tpu_torch.ml.losses",
    "pmarlo_tpu_torch.ml.whitening", "pmarlo_tpu_torch.ml.deeptica",
    "pmarlo_tpu_torch.bias.harmonic", "pmarlo_tpu_torch.bias.metadynamics",
    "pmarlo_tpu_torch.md.cv_bias", "pmarlo_tpu_torch.md.enhanced_sampling",
]
#: modules the explicit-solvent slice added
NEW_MODULES += [
    "pmarlo_tpu_torch.md.box", "pmarlo_tpu_torch.md.dispersion",
    "pmarlo_tpu_torch.md.periodic_force", "pmarlo_tpu_torch.md.cell_force",
    "pmarlo_tpu_torch.data.water",
]
#: modules the large-assembly slice added
NEW_MODULES += ["pmarlo_tpu_torch.md.bonded_window"]
#: modules the solvated production slice added
NEW_MODULES += [
    "pmarlo_tpu_torch.md.eft", "pmarlo_tpu_torch.md.pme", "pmarlo_tpu_torch.md.barostat",
    "pmarlo_tpu_torch.md.simulation", "pmarlo_tpu_torch.io.cif",
    "pmarlo_tpu_torch.io._native_build", "pmarlo_tpu_torch.io.xtc", "pmarlo_tpu_torch.io.dcd",
    "pmarlo_tpu_torch.io.trr", "pmarlo_tpu_torch.io.netcdf", "pmarlo_tpu_torch.io.trajectory",
    "pmarlo_tpu_torch.io.shards", "pmarlo_tpu_torch.io.export", "pmarlo_tpu_torch.remd.demux",
    "pmarlo_tpu_torch.remd.checkpoint",
]
#: modules the virtual-site water slice added
NEW_MODULES += [
    "pmarlo_tpu_torch.md.vsites", "pmarlo_tpu_torch.md.amber_params",
    "pmarlo_tpu_torch.protein.__init__", "pmarlo_tpu_torch.protein.solvate",
    "pmarlo_tpu_torch.features.rdf", "pmarlo_tpu_torch.features.msd",
    "pmarlo_tpu_torch.ml.plumed",
]
#: modules the analysis slice added: the reductions, the Bayesian ITS and
#: its reversible sampler, CK and the lag selector, PCCA+, TPT, the KDE FES,
#: the Ramachandran analysis, the CV facade and the host copies beside them
NEW_MODULES += [
    "pmarlo_tpu_torch.msm.reduction", "pmarlo_tpu_torch.msm.its",
    "pmarlo_tpu_torch.msm.reversible_sampler", "pmarlo_tpu_torch.msm.ck",
    "pmarlo_tpu_torch.msm.ck_its_selector", "pmarlo_tpu_torch.msm.pcca",
    "pmarlo_tpu_torch.msm.tpt", "pmarlo_tpu_torch.msm.results",
    "pmarlo_tpu_torch.msm.msm_builder", "pmarlo_tpu_torch.msm.__init__",
    "pmarlo_tpu_torch.analysis.fes", "pmarlo_tpu_torch.analysis.msm",
    "pmarlo_tpu_torch.analysis.project_cv", "pmarlo_tpu_torch.analysis.counting",
    "pmarlo_tpu_torch.analysis.debug_export", "pmarlo_tpu_torch.analysis.__init__",
    "pmarlo_tpu_torch.features.ramachandran", "pmarlo_tpu_torch.features.__init__",
    "pmarlo_tpu_torch.cv.__init__", "pmarlo_tpu_torch.ml.metrics",
]
#: modules the conformations slice added: the structure features, EnhancedMSM
#: and the conformations package
NEW_MODULES += [
    "pmarlo_tpu_torch.features.structure", "pmarlo_tpu_torch.msm.enhanced",
    "pmarlo_tpu_torch.conformations.__init__", "pmarlo_tpu_torch.conformations.results",
    "pmarlo_tpu_torch.conformations.representative_picker",
    "pmarlo_tpu_torch.conformations.kinetic_importance",
    "pmarlo_tpu_torch.conformations.uncertainty",
    "pmarlo_tpu_torch.conformations.state_detection",
    "pmarlo_tpu_torch.conformations.tpt_analysis", "pmarlo_tpu_torch.conformations.finder",
]
#: modules the structure-preparation and console slice added: the DNA/RNA
#: strands, ``protein/``, the CLI, settings, utilities, the pipeline,
#: profiling and the deploy worker
NEW_MODULES += [
    "pmarlo_tpu_torch.data.dna", "pmarlo_tpu_torch.protein.protein",
    "pmarlo_tpu_torch.protein.repair", "pmarlo_tpu_torch.protein.loops",
    "pmarlo_tpu_torch.protein.hydrogens", "pmarlo_tpu_torch.protein.nonstandard",
    "pmarlo_tpu_torch.protein.descriptors", "pmarlo_tpu_torch.main",
    "pmarlo_tpu_torch.deploy_worker", "pmarlo_tpu_torch.settings.__init__",
    "pmarlo_tpu_torch.settings.loader", "pmarlo_tpu_torch.utils.config_utils",
    "pmarlo_tpu_torch.utils.misc", "pmarlo_tpu_torch.utils.path_utils",
    "pmarlo_tpu_torch.utils.profiling", "pmarlo_tpu_torch.workflow.__init__",
    "pmarlo_tpu_torch.workflow.pipeline", "pmarlo_tpu_torch.__init__",
]


def test_port_imports_without_jax():
    code = f"EXTRA = {_chip_smoke_imports() + NEW_MODULES!r}\n" + _BLOCKED_IMPORT
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 33 + 14 + 5 + 1


def test_chip_smoke_imports_name_no_jax():
    for name in _chip_smoke_imports():
        assert name.split(".")[0] not in ("jax", "jaxlib", "optax", "pmarlo_tpu"), name


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_source_names_no_jax(module):
    """No import statement of a port module names JAX, optax or the JAX
    package (the subprocess above imports them with those blocked; this
    reads the source, function-level imports included)."""
    path = ROOT / (module.replace(".", "/") + ".py")
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "optax", "pmarlo_tpu"), (
                f"{module} imports {name}")
