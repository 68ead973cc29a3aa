"""Entry points of the port that build tensors take ``device=None`` and
resolve it through ``_device.default_device()`` (the card when there is
one), as ``build_system`` and ``run_replica_exchange`` do; an explicit
``device=`` is obeyed and never asks.

Each module imports ``default_device`` by name, so the tests replace it
there: with the ``meta`` device where the function only places tensors (the
result must land on it), and with a counting stand-in that answers the CPU
where the function also computes or draws numbers.
"""

import types

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch import _device
from pmarlo_tpu_torch.bias import metadynamics
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.md import barostat, constraints, cv_bias, forcefield, integrate
from pmarlo_tpu_torch.md import system as system_mod
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.ml import deeptica, losses
from pmarlo_tpu_torch.utils import seed as seed_mod

META = torch.device("meta")


def _model_arrays(n_features: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    cfg = deeptica.DeepTICAConfig()
    sizes = [n_features, *cfg.hidden, cfg.n_out]
    params = [{"w": rng.normal(0.0, 0.3, (a, b)).astype(np.float32),
               "b": rng.normal(0.0, 0.1, b).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    return cfg, params, rng.normal(0.0, 0.3, n_features), rng.uniform(0.5, 1.0, n_features)


def _cpu_model():
    cfg, params, mean, scale = _model_arrays(4)
    return deeptica.deeptica_from_numpy(cfg, params, mean, scale, device="cpu")


def _deeptica_from_numpy(device=None):
    cfg, params, mean, scale = _model_arrays(4)
    return deeptica.deeptica_from_numpy(cfg, params, mean, scale, device=device).params[0]["w"]


def _deeptica_load(tmp_path, device=None):
    prefix = _cpu_model().save(tmp_path / "model")
    return deeptica.DeepTICAModel.load(prefix, device=device).params[0]["w"]


def _cv_bias(device=None):
    quads = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    return cv_bias.CVBias(_cpu_model(), quads, n_atoms=6, device=device).quads


def _system_from_numpy(device=None):
    system, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")
    return system_mod.system_from_numpy(system.to_dict(), device=device).masses


def _init_state(device=None):
    mtd = metadynamics.MetadynamicsBias(sigma=(0.2, 0.2), max_hills=8)
    return mtd.init_state(device=device).centers


def _metad_state_from_numpy(device=None):
    return metadynamics.metad_state_from_numpy(
        np.zeros((8, 2)), np.zeros(8), 0, device=device).heights


def _constraint_spec(device=None):
    eye = np.eye(4, dtype=np.float32)
    spec = types.SimpleNamespace(s1=eye[[0, 1]], s2=eye[[2, 3]], d0=[0.1, 0.1],
                                 inv_m1=[1.0, 1.0], inv_m2=[0.1, 0.1],
                                 inv_mass_sum=[1.1, 1.1], n_iter=5)
    return constraints.ConstraintSpec.from_numpy(spec, device=device).idx1


def _rigid_water_spec(device=None):
    spec = types.SimpleNamespace(start=0, n_waters=2, inv_m=np.ones(3),
                                 d0=np.full(3, 0.1), n_newton=3, stride=3)
    return constraints.RigidWaterSpec.from_numpy(spec, device=device).d0


def _md_state_from_numpy(device=None):
    x = np.zeros((5, 3), np.float32)
    return integrate.md_state_from_numpy(x, x, 7, seed=3, device=device).positions


def _init_barostat(device=None):
    return barostat.init_barostat((2.0, 2.1, 2.2), seed=1, device=device).box


def _protein_create_system(device=None):
    from pmarlo_tpu_torch.protein import Protein

    system, positions = Protein(alanine_dipeptide_structure()).prepare().create_system(
        device=device)
    assert positions.device == system.masses.device
    return system.masses


# (module whose default_device is replaced, entry point) for the functions
# that only place tensors: their result lies on the meta device
PLACING = {
    "Protein.create_system": (forcefield, _protein_create_system),
    "deeptica_from_numpy": (deeptica, _deeptica_from_numpy),
    "DeepTICAModel.load": (deeptica, _deeptica_load),
    "CVBias": (cv_bias, _cv_bias),
    "system_from_numpy": (system_mod, _system_from_numpy),
    "MetadynamicsBias.init_state": (metadynamics, _init_state),
    "metad_state_from_numpy": (metadynamics, _metad_state_from_numpy),
    "ConstraintSpec.from_numpy": (constraints, _constraint_spec),
    "RigidWaterSpec.from_numpy": (constraints, _rigid_water_spec),
    "md_state_from_numpy": (integrate, _md_state_from_numpy),
    "init_barostat": (barostat, _init_barostat),
}


def _call(name, fn, tmp_path, **kw):
    return fn(tmp_path, **kw) if name == "DeepTICAModel.load" else fn(**kw)


@pytest.mark.parametrize("name", sorted(PLACING))
def test_device_none_places_tensors_on_the_default_device(name, monkeypatch, tmp_path):
    module, fn = PLACING[name]
    monkeypatch.setattr(module, "default_device", lambda: META)
    assert _call(name, fn, tmp_path).device == META


@pytest.mark.parametrize("name", sorted(PLACING))
def test_an_explicit_device_is_obeyed(name, monkeypatch, tmp_path):
    module, fn = PLACING[name]

    def never():
        raise AssertionError("default_device() asked despite an explicit device")

    monkeypatch.setattr(module, "default_device", never)
    assert _call(name, fn, tmp_path, device="cpu").device == torch.device("cpu")
    assert _call(name, fn, tmp_path, device=META).device == META


@pytest.mark.parametrize("name", ["vamp2_score_features", "set_global_seed"])
def test_computing_entry_points_ask_the_default_device(name, monkeypatch):
    """The two that compute on the device they resolve: the stand-in is
    asked once with ``device=None`` and never with an explicit one."""
    calls = []

    def fake_default():
        calls.append(name)
        return torch.device("cpu")

    rng = np.random.default_rng(0)
    x0, xt = rng.normal(size=(64, 3)), rng.normal(size=(64, 3))
    if name == "vamp2_score_features":
        monkeypatch.setattr(losses, "default_device", fake_default)

        def run(**kw):
            return losses.vamp2_score_features(x0, xt, **kw)
    else:
        monkeypatch.setattr(seed_mod, "default_device", fake_default)

        def run(**kw):
            return seed_mod.set_global_seed(7, **kw)
    first = run()
    assert calls == [name]
    calls.clear()
    second = run(device="cpu")
    assert not calls
    if name == "vamp2_score_features":
        assert first == second and np.isfinite(first)
    else:
        assert first.device == second.device == torch.device("cpu")
        assert torch.equal(torch.rand(3, generator=first), torch.rand(3, generator=second))


def test_default_device_is_the_card_when_there_is_one():
    assert _device.default_device().type == ("cuda" if torch.cuda.is_available() else "cpu")
