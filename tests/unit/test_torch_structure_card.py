"""The structure features and ``EnhancedMSM.compute_features`` on the card
against the CPU (this file imports no JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m gpu
tests/unit/test_torch_structure_card.py``).

- SASA on ``cuda`` against the CPU: per-atom values equal except atoms with
  a sphere point whose burial test sits within 1e-6 nm^2 of its threshold;
  the total within 1e-4 relative. The chunked call equals an unchunked one bit for bit on the
  card (60 chignolin frames hold ~1 GB of intermediates unchunked).
- Hard H-bond counts equal; DSSP codes equal, except frames with a pair
  whose K&S energy lies within 1e-4 kcal/mol of -0.5.
- ``EnhancedMSM.compute_features`` on the card returns host float32.
"""

import numpy as np
import pytest
import torch

import pmarlo_tpu_torch  # noqa: F401  (pins float32 matmuls)
from pmarlo_tpu_torch.data.chignolin import chignolin_structure
from pmarlo_tpu_torch.features import structure as S
from pmarlo_tpu_torch.features.base import TopologyInfo
from pmarlo_tpu_torch.md.topology import build_topology
from pmarlo_tpu_torch.msm.enhanced import EnhancedMSM


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the features run on it")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chignolin():
    structure = chignolin_structure()
    info = TopologyInfo.from_topology(build_topology(structure))
    x0 = structure.coordinates().astype(np.float32)
    rng = np.random.default_rng(23)
    frames = (x0[None] + rng.normal(0.0, 0.03, (60,) + x0.shape)).astype(np.float32)
    return info, frames, S.sasa_radii(info.atom_names)


def sasa_point_margin(x, radii, i):
    """min over atom i's 96 points and j != i of |d2 - r_j^2| (float64): how
    close the closest of its burial tests sits to its threshold in frame
    ``x`` (N, 3). ``test_torch_structure.py`` uses it too."""
    r = radii.astype(np.float32).astype(np.float64) + np.float32(0.14)
    pts = x[i].astype(np.float64) + r[i] * S._golden_spiral_points(96)
    m = np.abs(((pts[:, None] - x.astype(np.float64)[None]) ** 2).sum(-1) - r[None] ** 2)
    m[:, i] = np.inf
    return m.min()


@pytest.mark.gpu
def test_sasa_on_the_card_matches_the_cpu(card, chignolin):
    info, frames, radii = chignolin
    sasa = S.shrake_rupley_sasa(frames, radii, device=card)
    ref = S.shrake_rupley_sasa(frames, radii, device="cpu")
    assert sasa.is_cuda
    for t, i in torch.nonzero(sasa.cpu() != ref).tolist():
        assert sasa_point_margin(frames[t], radii, i) <= 1e-6, (t, i)
    assert abs(float(sasa.sum()) - float(ref.sum())) <= 1e-4 * float(ref.sum())


@pytest.mark.gpu
def test_chunked_sasa_equals_unchunked_on_the_card(card, chignolin, monkeypatch):
    _, frames, radii = chignolin
    x = torch.as_tensor(frames, device=card)
    monkeypatch.setattr(S, "SASA_CHUNK_BYTES", 1 << 34)
    whole = S.shrake_rupley_sasa(x, radii)
    for chunk_bytes in (1 << 20, 64 << 20, 1 << 30):
        monkeypatch.setattr(S, "SASA_CHUNK_BYTES", chunk_bytes)
        assert torch.equal(S.shrake_rupley_sasa(x, radii), whole)


@pytest.mark.gpu
def test_hbonds_and_dssp_on_the_card_match_the_cpu(card, chignolin):
    info, frames, _ = chignolin
    elements = [S._element_of(n) for n in info.atom_names]
    donors, acceptors = S.find_donors_acceptors(info.atom_names, elements, info.bonds)
    hard = S.hydrogen_bonds(frames, donors, acceptors, device=card)
    assert hard.is_cuda
    torch.testing.assert_close(hard.cpu(), S.hydrogen_bonds(frames, donors, acceptors,
                                                            device="cpu"), rtol=0, atol=0)
    e, allowed, _ = S.kabsch_sander_energies(frames, info, device=card)
    e_cpu, _, _ = S.kabsch_sander_energies(frames, info, device="cpu")
    hb = ((e < -0.5) & allowed[None]).cpu()
    hb_cpu = (e_cpu < -0.5) & allowed.cpu()[None]
    near = (e_cpu + 0.5).abs() <= 1e-4
    assert not (hb != hb_cpu)[~near].any()
    same = ~(hb != hb_cpu).any(dim=(1, 2))
    codes = S.dssp(frames, info, device=card)
    assert codes.is_cuda and codes.dtype == torch.int8
    assert torch.equal(codes.cpu()[same], S.dssp(frames, info, device="cpu")[same])
    np.testing.assert_array_equal(S.baker_hubbard(frames, info, device=card),
                                  S.baker_hubbard(frames, info, device="cpu"))


@pytest.mark.gpu
def test_enhanced_compute_features_on_the_card(card, chignolin):
    info, frames, _ = chignolin
    m = EnhancedMSM([frames[:30], frames[30:]], topology=info)
    assert m.device.type == "cuda"
    m.compute_features("phi_psi")
    ref = EnhancedMSM([frames[:30], frames[30:]], topology=info, device="cpu")
    ref.compute_features("phi_psi")
    for a, b in zip(m.features, ref.features):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32 and a.shape == (30, 32)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
