"""Port parity: ``pmarlo_tpu_torch.md.forcefield.build_system`` against the
JAX package's, field by field, and the ``system_from_numpy`` carry."""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu.data import alanine_dipeptide_structure as jax_alanine
from pmarlo_tpu.md.forcefield import build_system as jax_build_system
from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.system import System, system_from_numpy

#: float fields agree to 1e-6 relative: both packages build them in float64
#: numpy from the same tables and cast once to float32
FLOAT_RTOL = 1e-6

MODELS = {
    "gbn2": dict(gb_model="gbn2"),
    "obc2": dict(gb_model="obc2"),
    "vacuum": dict(implicit_solvent=False),
}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_dicts_match(jd, td):
    assert set(jd) == set(td)
    for key, a in jd.items():
        b = td[key]
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), key
            assert a.shape == b.shape and a.dtype == b.dtype, key
            if np.issubdtype(a.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                np.testing.assert_allclose(b, a, rtol=FLOAT_RTOL, atol=0.0, err_msg=key)
        else:
            assert a == b, (key, a, b)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_build_system_matches_jax(model):
    js, jx = jax_build_system(jax_alanine(), **MODELS[model])
    ts, tx = build_system(alanine_dipeptide_structure(), **MODELS[model])
    _assert_dicts_match(js.to_dict(), ts.to_dict())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=FLOAT_RTOL, atol=0.0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_system_from_numpy_round_trip(model):
    js, _ = jax_build_system(jax_alanine(), **MODELS[model])
    jd = js.to_dict()
    ts = system_from_numpy(jd, device="cpu")
    assert isinstance(ts, System) and ts.bond_idx.dtype == torch.int32
    _assert_dicts_match(jd, ts.to_dict())
    # and back again through the port's own dict
    _assert_dicts_match(jd, system_from_numpy(ts.to_dict()).to_dict())


def test_system_to_moves_every_tensor():
    ts, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2")
    moved = ts.to("cpu")
    for f in dataclasses.fields(moved):
        v = getattr(moved, f.name)
        if isinstance(v, torch.Tensor):
            assert v.device.type == "cpu"
    assert moved.n_atoms == 22 and moved.device.type == "cpu"


def test_build_system_rejects_periodic_box():
    with pytest.raises(NotImplementedError, match="A12"):
        build_system(alanine_dipeptide_structure(), box=(3.0, 3.0, 3.0))
    with pytest.raises(ValueError, match="gb_model"):
        build_system(alanine_dipeptide_structure(), gb_model="hct")
