"""The port's public surface covers the JAX package's, module by module.

For every module of ``pmarlo_tpu`` with a counterpart in the port (the same
path, or its name in ``RENAMED``):

- each public name (the module's ``__all__``, or its top-level public
  functions and classes where it has none) exists in the port's module;
- each argument of a function, and of a public method of a class, exists on
  the port's function or method of the same name: the functions and classes
  of the first list, and every other top-level one without a leading
  underscore that the port has too.

The JAX side is read from its source by ``ast``, so no JAX module is
imported. Anything else must be an entry of ``DEPARTURES``, with its reason:
``"path:name"`` for a name, ``"path:function(argument)"`` for an argument.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
JAX_ROOT = ROOT / "pmarlo_tpu"
PORT_ROOT = ROOT / "pmarlo_tpu_torch"

#: modules the port names otherwise (their TPU kernels became CUDA files)
RENAMED = {"pallas_pair": "pair_force", "pallas_periodic": "periodic_force",
           "pallas_cells": "cell_force", "pallas_md": "fused_md"}

_GENERATOR = ("random draws come from an explicit torch.Generator (or a seed) in place "
              "of a JAX PRNG key")
_INTERPRET = ("Pallas interpret mode: a CPU tensor runs the kernel's plain PyTorch version, "
              "a CUDA tensor the kernel")

#: settled departures of the port's surface from JAX's, with their reasons
DEPARTURES = {
    "md/pallas_md.py:build_pallas_chunk": (
        "the fused chunk (rows 1, 1-bias) is md.fused_md.build_fused_chunk / FusedChunk"),
    "md/pallas_md.py:build_pallas_remd": (
        "the whole-run REMD kernel (row 2) is launched by ReplicaExchange.run_fused"),
    "md/barostat.py:init_barostat(key)": (
        "the barostat's moves are a Philox stream keyed by seed="),
    "md/integrate.py:initialize_velocities(key)": _GENERATOR,
    "md/integrate.py:thermalize(key)": _GENERATOR,
    "ml/deeptica.py:init_mlp_params(key)": _GENERATOR,
    "msm/clustering.py:kmeans(key)": _GENERATOR,
    "msm/its.py:sample_posterior_timescales(key)": _GENERATOR,
    "msm/reversible_sampler.py:sample_reversible_posterior(key)": _GENERATOR,
    "msm/reversible_sampler.py:sample_reversible_timescales(key)": _GENERATOR,
    "md/bonded_window.py:build_bonded_window(interpret)": _INTERPRET,
    "md/bonded_window.py:build_bonded_window(stride)": (
        "the TPU kernel's atom window; the CUDA kernel reads terms by index, no window"),
    "md/pallas_cells.py:build_cell_force_fn(interpret)": _INTERPRET,
    "md/pallas_cells.py:build_cell_force_fn(skin)": (
        "the port bins on every call; a host-read skin rule measured 9-11% slower"),
    "md/pallas_cells.py:build_cell_force_fn(min_skin)": (
        "the port bins on every call; a host-read skin rule measured 9-11% slower"),
    "md/pallas_pair.py:build_pair_force_fn(interpret)": _INTERPRET,
    "md/pallas_periodic.py:build_periodic_force_fn(interpret)": _INTERPRET,
    "md/setup.py:build_explicit_setup(interpret)": _INTERPRET,
    "parallel/mesh.py:shard_replicas(array)": (
        "named tensor: it returns this rank's block as a plain tensor, not a sharded array"),
    "remd/checkpoint.py:load_checkpoint(use_pallas)": "named use_kernel: a CUDA kernel",
    "remd/checkpoint.py:load_checkpoint(pallas_bias)": "named kernel_bias: a CUDA kernel",
    "remd/remd.py:ReplicaExchange.__init__(use_pallas)": "named use_kernel: a CUDA kernel",
    "remd/remd.py:ReplicaExchange.__init__(pallas_bias)": "named kernel_bias: a CUDA kernel",
}

#: modules whose public JAX names this slice ports: no departure may name them
PORTED_WHOLE = ["md/nblist.py", "md/bonded_roll.py", "md/constraints.py", "md/cells.py",
                "md/__init__.py", "remd/__init__.py", "utils/__init__.py"]


def _port_module(rel: Path) -> str:
    parts = [RENAMED.get(p, p) for p in rel.with_suffix("").parts]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["pmarlo_tpu_torch", *parts])


def _port_path(rel: Path) -> Path:
    return PORT_ROOT.joinpath(*[RENAMED.get(p, p) for p in rel.with_suffix("").parts]
                              ).with_suffix(".py")


JAX_MODULES = sorted(p.relative_to(JAX_ROOT) for p in JAX_ROOT.rglob("*.py"))
#: ``__main__`` modules run when imported; they define nothing public
MODULES = [str(r) for r in JAX_MODULES if r.name != "__main__.py"]


def _tree(rel: str) -> ast.Module:
    return ast.parse((JAX_ROOT / rel).read_text())


def _public(tree: ast.Module) -> list:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


def _arguments(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _callables(tree: ast.Module, public: list) -> dict:
    """``{qualified name: arguments}`` of the public functions and of the
    public methods (and ``__init__`` / ``__call__``) of the public classes:
    the names of ``public`` and every other top-level name without a
    leading underscore."""
    out = {}
    for node in tree.body:
        shown = getattr(node, "name", "_")
        shown = shown in public or not shown.startswith("_")
        if isinstance(node, ast.FunctionDef) and shown:
            out[node.name] = _arguments(node)
        elif isinstance(node, ast.ClassDef) and shown:
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and (
                        not item.name.startswith("_") or item.name in ("__init__", "__call__")):
                    out[f"{node.name}.{item.name}"] = _arguments(item)
    return out


def _resolve(module, qualname: str):
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def test_every_jax_module_has_a_port_counterpart():
    missing = [str(r) for r in JAX_MODULES if not _port_path(r).exists()]
    assert missing == []


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_are_in_the_port(rel):
    port = importlib.import_module(_port_module(Path(rel)))
    missing = [name for name in _public(_tree(rel))
               if not hasattr(port, name) and f"{rel}:{name}" not in DEPARTURES]
    assert missing == []


@pytest.mark.parametrize("rel", MODULES)
def test_arguments_are_in_the_port(rel):
    tree = _tree(rel)
    port = importlib.import_module(_port_module(Path(rel)))
    missing = []
    public = _public(tree)
    for qualname, args in _callables(tree, public).items():
        obj = _resolve(port, qualname)
        top = qualname.split(".")[0]
        if obj is None:
            # a function outside ``public`` is held only where the port has
            # it; a method, wherever the port has its class
            if ((top in public or hasattr(port, top)) and f"{rel}:{top}" not in DEPARTURES
                    and f"{rel}:{qualname}" not in DEPARTURES):
                missing.append(qualname)
            continue
        if isinstance(obj, property):
            continue
        params = inspect.signature(obj).parameters
        missing += [f"{qualname}({a})" for a in args
                    if a not in params and f"{rel}:{qualname}({a})" not in DEPARTURES]
    assert missing == []


@pytest.mark.parametrize("entry", sorted(DEPARTURES))
def test_each_departure_is_a_real_difference(entry):
    """A departure names a JAX name or argument that exists, that the port
    lacks, and that this slice did not port."""
    rel, what = entry.split(":")
    assert rel not in PORTED_WHOLE
    tree = _tree(rel)
    public = _public(tree)
    port = importlib.import_module(_port_module(Path(rel)))
    if "(" not in what:
        assert what in public and not hasattr(port, what)
        return
    qualname, arg = what[:-1].split("(")
    assert arg in _callables(tree, public)[qualname]
    assert arg not in inspect.signature(_resolve(port, qualname)).parameters
    assert DEPARTURES[entry].strip()


@pytest.mark.parametrize("package,names", [
    ("md", ["run_md", "MDState", "build_system"]),
    ("remd", ["ReplicaExchange", "suggest_temperature_ladder"]),
    ("utils", ["set_global_seed", "PmarloError"]),
])
def test_package_exports_are_the_modules_objects(package, names):
    """The three package ``__init__``s export JAX's ``__all__``, each name
    the object of the module that defines it, resolved lazily."""
    pkg = importlib.import_module(f"pmarlo_tpu_torch.{package}")
    assert pkg.__all__ == _public(_tree(f"{package}/__init__.py"))
    for name in names:
        module = importlib.import_module(f"pmarlo_tpu_torch.{package}.{pkg._EXPORTS[name]}")
        assert getattr(pkg, name) is getattr(module, name)
        assert name in dir(pkg)
    with pytest.raises(AttributeError):
        getattr(pkg, "no_such_name")


def test_importing_md_builds_nothing_and_imports_no_module():
    """``import pmarlo_tpu_torch.md`` loads none of its modules (so no kernel
    library and no cycle); the first lazy name loads its own module."""
    import subprocess
    import sys

    code = ("import sys, pmarlo_tpu_torch.md as md\n"
            "assert not [m for m in sys.modules if m.startswith('pmarlo_tpu_torch.md.')]\n"
            "from pmarlo_tpu_torch.md import run_md\n"
            "assert 'pmarlo_tpu_torch.md.integrate' in sys.modules\n"
            "assert 'pmarlo_tpu_torch._kernels' not in sys.modules\n"
            "from pmarlo_tpu_torch.md.nblist import run_md_nb\n"
            "from pmarlo_tpu_torch.md.bonded_roll import build_rolled_bonded\n"
            "from pmarlo_tpu_torch.md.constraints import shake_rolled\n"
            "from pmarlo_tpu_torch.md.cells import ghost_pad\n"
            "from pmarlo_tpu_torch.remd import ReplicaExchange, suggest_temperature_ladder\n"
            "from pmarlo_tpu_torch.utils import set_global_seed, PmarloError\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("module,name", [
    ("md.forces", "GB_DIELECTRIC_OFFSET"), ("md.analytic", "GB_DIELECTRIC_OFFSET"),
    ("features.structure", "as_frames"),
])
def test_names_imported_beside_the_module_exports(module, name):
    """Names a JAX module imports for its own use and users reach through
    it: the same value, from the same place in the port."""
    from pmarlo_tpu_torch.features import builtins
    from pmarlo_tpu_torch.md import ff_params

    got = getattr(importlib.import_module(f"pmarlo_tpu_torch.{module}"), name)
    assert got is getattr(ff_params if name.startswith("GB_") else builtins, name)
    if name == "GB_DIELECTRIC_OFFSET":
        assert got == 0.009
