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
    "analysis/validation.py", "analysis/discretize.py", "analysis/diagnostics.py",
    "ml/whitening.py", "utils/json_io.py",
    # the trajectory and structure I/O and the demux of the production slice
    "io/__init__.py", "io/cif.py", "io/xtc.py", "io/dcd.py", "io/trr.py", "io/netcdf.py",
    "io/trajectory.py", "io/shards.py", "io/export.py", "remd/demux.py",
    # the solvation box and the Amber file loaders of the virtual-site water slice
    "protein/solvate.py", "md/amber_params.py",
    # the analysis half of the alanine pipeline: metrics, PCCA+, TPT, CK, the lag
    # selector, results, the builder and the analysis glue
    "ml/metrics.py", "msm/pcca.py", "msm/tpt.py", "msm/ck.py", "msm/ck_its_selector.py",
    "msm/results.py", "msm/msm_builder.py", "analysis/msm.py", "analysis/project_cv.py",
    "analysis/counting.py", "analysis/debug_export.py",
    # the conformations end of the chignolin pipeline: TPT conformations, their
    # endpoints, kinetic importance, uncertainty and representatives
    "conformations/results.py", "conformations/representative_picker.py",
    "conformations/kinetic_importance.py", "conformations/uncertainty.py",
    "conformations/state_detection.py", "conformations/tpt_analysis.py",
    "conformations/finder.py", "conformations/__init__.py",
    # structure preparation: DNA/RNA strands, nonstandard residues, heavy-atom
    # repair, loop closure, hydrogens and descriptors
    "data/dna.py", "protein/nonstandard.py", "protein/repair.py", "protein/loops.py",
    "protein/hydrogens.py", "protein/descriptors.py",
    # the console half of the facade: utilities, settings and the pipeline
    "utils/config_utils.py", "utils/misc.py", "utils/path_utils.py",
    "settings/__init__.py", "settings/loader.py", "workflow/__init__.py",
    "workflow/pipeline.py",
    # the API facade and the reports: the sampling benchmark, the ``api``
    # package but ``features.py`` (a port, held in test_torch_api.py), the
    # plots and the dashboard
    "benchmark/__init__.py", "api/feature_profiles.py", "api/trajectory_utils.py",
    "api/conformations.py", "api/fes.py", "api/msm.py", "api/clustering.py",
    "api/__init__.py", "visualization/plots.py", "visualization/interactive.py",
    "visualization/__init__.py", "webapp/app.py", "webapp/__init__.py",
    "webapp/__main__.py",
]

#: the settings' YAML files, carried byte for byte as the neck tables are
DATA_COPIES = ["settings/defaults.yaml", "settings/feature_spec.yaml"]

#: host-side index functions of ``features/builtins.py``: numpy, carried
#: over as they are; the geometry below them is rewritten for tensors
INDEX_FUNCTIONS = [
    "_atoms_by_residue", "_residue_groups", "phi_psi_indices", "omega_indices",
    "chi1_indices", "ca_pair_indices",
]


#: host-side lattice functions of ``md/box.py``: numpy, carried over as
#: they are; the tensor functions beside them are rewritten for torch
BOX_FUNCTIONS = [
    "box_matrix", "reduce_box_matrix", "split_matrix", "from_lengths_angles",
    "to_lengths_angles", "validate_reduced", "perp_widths", "volume",
    "tilt_ratios", "dodecahedron_vectors",
]


#: numpy functions of the modules the analysis slice ports, carried over
#: as they are beside the tensor code: (module path, function)
PORTED_MODULE_FUNCTIONS = [
    ("msm/reduction.py", "_sym_inv_sqrt"), ("msm/reduction.py", "pca"),
    ("msm/reduction.py", "_as_list"), ("msm/reduction.py", "_global_mean"),
    ("msm/its.py", "_timescales_from_eigvals"), ("msm/its.py", "detect_plateau"),
    ("msm/reversible_sampler.py", "_round_robin_schedule"),
    ("msm/reversible_sampler.py", "_init_flow_matrix"),
    ("features/ramachandran.py", "periodic_hist2d"),
    ("features/ramachandran.py", "compute_ramachandran_fes"),
    ("features/ramachandran.py", "_periodic_gaussian_smooth"),
    ("analysis/fes.py", "select_fes_columns"), ("analysis/fes.py", "normalize_weights"),
    ("analysis/fes.py", "compute_bandwidth"),
    # the host-side index functions of the structure features
    ("features/structure.py", "_element_of"),
    ("features/structure.py", "_golden_spiral_points"),
    ("features/structure.py", "find_donors_acceptors"),
    ("features/structure.py", "_backbone_indices"),
    # ``protein/protein.py``: everything but ``create_system``, which passes
    # ``device=`` on to the port's ``build_system``
    ("protein/protein.py", "_canonical"), ("protein/protein.py", "charge_at_pH"),
    ("protein/protein.py", "isoelectric_point"), ("protein/protein.py", "Protein.prepare"),
    ("protein/protein.py", "Protein._require_prepared"),
    ("protein/protein.py", "Protein.sequence"),
    ("protein/protein.py", "Protein.sequence_one_letter"),
    ("protein/protein.py", "Protein.get_properties"),
    ("protein/protein.py", "Protein.find_missing_residues"),
    ("protein/protein.py", "Protein.add_missing_residues"),
    ("protein/protein.py", "Protein.save_prepared"),
    ("protein/protein.py", "Protein.save_structure"),
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
    """(module docstring, source lines after it); a module without one has
    the empty docstring."""
    node = ast.parse(text).body[0]
    if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)):
        return "", text.splitlines()
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


@pytest.mark.parametrize("rel", DATA_COPIES)
def test_data_files_are_copied_byte_for_byte(rel):
    a = (ROOT / "pmarlo_tpu" / rel).read_bytes()
    b = (ROOT / "pmarlo_tpu_torch" / rel).read_bytes()
    assert a == b, f"pmarlo_tpu_torch/{rel} differs from its source"


def _function_source(path, name):
    """Source of the module-level function ``name``, or of the method
    ``Class.method``."""
    text = path.read_text()
    body = ast.parse(text).body
    if "." in name:
        cls, name = name.split(".")
        body = next(node.body for node in body
                    if isinstance(node, ast.ClassDef) and node.name == cls)
    for node in body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return _normalise(ast.get_source_segment(text, node))
    raise AssertionError(f"{name} not found in {path}")


@pytest.mark.parametrize("name", INDEX_FUNCTIONS)
def test_feature_index_functions_are_copied(name):
    """Each index function of ``features/builtins.py`` has its source's
    text, docstring and comments included."""
    src = _function_source(ROOT / "pmarlo_tpu" / "features" / "builtins.py", name)
    copy = _function_source(ROOT / "pmarlo_tpu_torch" / "features" / "builtins.py", name)
    assert copy == src, f"features/builtins.py {name} drifted from its source"


@pytest.mark.parametrize("name", BOX_FUNCTIONS)
def test_box_lattice_functions_are_copied(name):
    """Each numpy lattice function of ``md/box.py`` has its source's text."""
    src = _function_source(ROOT / "pmarlo_tpu" / "md" / "box.py", name)
    copy = _function_source(ROOT / "pmarlo_tpu_torch" / "md" / "box.py", name)
    assert copy == src, f"md/box.py {name} drifted from its source"


def test_morton_order_is_copied():
    """``md/pair_force.py _morton_order`` has the text of its source in
    ``md/pallas_pair.py`` (a file that imports JAX, so only the function is
    carried)."""
    src = _function_source(ROOT / "pmarlo_tpu" / "md" / "pallas_pair.py", "_morton_order")
    copy = _function_source(ROOT / "pmarlo_tpu_torch" / "md" / "pair_force.py",
                            "_morton_order")
    assert copy == src, "md/pair_force.py _morton_order drifted from its source"


def test_dispersion_coefficient_is_copied():
    """``md/dispersion.py dispersion_coefficient`` differs from its source
    only where the per-atom parameters come off the device."""
    src = _function_source(ROOT / "pmarlo_tpu" / "md" / "dispersion.py",
                           "dispersion_coefficient")
    copy = _function_source(ROOT / "pmarlo_tpu_torch" / "md" / "dispersion.py",
                            "dispersion_coefficient")
    for field in ("lj_sigma", "lj_eps"):
        src = src.replace(f"np.asarray(system.{field}, np.float64)",
                          f"_np(system.{field}).astype(np.float64)")
    assert copy == src


def test_native_build_differs_from_its_source_only_in_cache_dir():
    """``io/_native_build.py`` builds the codecs under the checkout
    (``cache_dir``); ``build_native`` and ``NATIVE_DIR`` are its source's."""
    src_path = ROOT / "pmarlo_tpu" / "io" / "_native_build.py"
    copy_path = ROOT / "pmarlo_tpu_torch" / "io" / "_native_build.py"
    name = "build_native"
    assert _function_source(copy_path, name) == _function_source(src_path, name)
    line = 'NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"'
    assert line in src_path.read_text() and line in copy_path.read_text()


@pytest.mark.parametrize("rel, name", PORTED_MODULE_FUNCTIONS)
def test_numpy_functions_of_ported_modules_are_copied(rel, name):
    """Each numpy function of a ported analysis module has its source's
    text, docstring and comments included."""
    src = _function_source(ROOT / "pmarlo_tpu" / rel, name)
    copy = _function_source(ROOT / "pmarlo_tpu_torch" / rel, name)
    assert copy == src, f"{rel} {name} drifted from its source"
