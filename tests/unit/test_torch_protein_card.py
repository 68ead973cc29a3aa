"""Structure preparation on the card (this file imports no JAX, so it also
runs where JAX is not installed: ``python -m pytest --noconftest -m gpu
tests/unit/test_torch_protein_card.py``).

- ``Protein.create_system()`` with no device lands on ``cuda``.
- The prepared 3-copy raw assembly (``raw_chignolin_assembly((3, 1, 1))``,
  414 atoms): rows 3-5 (the dense Born, energy and force sweeps) against
  their plain versions at R=4 under ``chip_smoke.py`` phase 6's gates (I,
  e_rows, dE/dB and the total energy within 1e-5 of max, the forces within
  1e-4).
- The DNA complex (chain A beside GATC): the fused chunk (row 1) against
  its plain version over 100 steps at R=8 (phase 2's gate: forces within
  1e-4 of max, positions within 1e-3 nm).
- ``StageTimer`` waits for the card before it stops the clock.
"""

import numpy as np
import pytest
import torch

import pmarlo_tpu_torch  # noqa: F401  (pins float32 matmuls)
from pmarlo_tpu_torch.data.chignolin import raw_chignolin_assembly
from pmarlo_tpu_torch.protein import Protein


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run on it")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def prepared():
    raw, gap = raw_chignolin_assembly((3, 1, 1))
    p = Protein(raw, ph=7.0).prepare()
    p.add_missing_residues(sequences=gap)
    return p.prepare()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.gpu
def test_create_system_lands_on_the_card(card, prepared):
    system, x = prepared.create_system()
    assert system.device.type == "cuda" and x.device.type == "cuda"
    assert system.masses.is_cuda and system.charges.is_cuda


@pytest.mark.gpu
def test_prepared_assembly_pair_kernels_match_plain(card, prepared):
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    system, x0 = prepared.create_system()
    fn = build_pair_force_fn(system)
    rng = np.random.default_rng(18)
    x = x0[None] + torch.as_tensor(rng.normal(0.0, 0.005, (4, system.n_atoms, 3)),
                                   dtype=torch.float32, device=card)
    Ip, Ik = fn.born_reference(x), fn.born(x)
    B, dB = fn.born_radii(Ip)
    ep, dp = fn.energy_rows_reference(x, B)
    ek, dk = fn.energy_rows(x, B)
    _, c = fn.gb_terms(B, dB, dp)
    Fp, Fk = fn.pair_forces_reference(x, B, c), fn.pair_forces(x, B, c)
    Ek, Gk = fn(x)
    Ep, Gp = fn.reference(x)
    for a, b in ((Ik, Ip), (ek, ep), (dk, dp), (Ek, Ep)):
        assert _rel(a, b) <= 1e-5
    assert _rel(Fk, Fp) <= 1e-4 and _rel(Gk, Gp) <= 1e-4
    assert torch.isfinite(Gk).all()


@pytest.mark.gpu
def test_dna_complex_fused_chunk_matches_plain(card, prepared):
    from pmarlo_tpu_torch.data.chignolin import shifted_residues
    from pmarlo_tpu_torch.data.dna import dna_single_strand
    from pmarlo_tpu_torch.io.pdb import PDBStructure
    from pmarlo_tpu_torch.md import analytic
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.protein.hydrogens import add_hydrogens
    from pmarlo_tpu_torch.remd.remd import RemdConfig

    strand = shifted_residues(dna_single_strand("GATC", chain="X").residues)
    chain = [r for r in prepared.structure.residues if r.chain == "A"]
    system, x0 = build_system(add_hydrogens(PDBStructure(residues=chain + strand)),
                              gb_model="gbn2")
    assert system.device.type == "cuda"
    x_min, _ = minimize_energy(system, x0)
    R = 8
    temps = torch.as_tensor(RemdConfig(n_replicas=R, t_min=300.0, t_max=330.0).ladder(),
                            dtype=torch.float32, device=card)
    rng = np.random.default_rng(25)
    x = x_min[None] + torch.as_tensor(rng.normal(0.0, 0.005, (R, system.n_atoms, 3)),
                                      dtype=torch.float32, device=card)
    v = torch.zeros_like(x)
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, R), dtype=torch.int32, device=card)
    chunk = build_fused_chunk(system, dt=0.001, friction=1.0, n_replicas=R)
    ek, fk = chunk.energy_and_forces(x)
    ep, fp = analytic.energy_and_forces(chunk.dense, x)
    assert _rel(fk, fp) <= 1e-4 and _rel(ek, ep) <= 1e-4
    xk, _, ek = chunk(x, v, seeds, temps, 100, 0)
    xp, _, _ = chunk.reference(x, v, seeds, temps, 100, 0)
    assert torch.isfinite(xk).all()
    assert float((xk - xp).abs().max()) <= 1e-3
    e_at_xk, _ = analytic.energy_and_forces(chunk.dense, xk)
    assert _rel(ek, e_at_xk) <= 1e-4


@pytest.mark.gpu
def test_stage_timer_waits_for_the_card(card):
    from pmarlo_tpu_torch.utils.profiling import StageTimer, device_memory_stats

    a = torch.randn(4096, 4096, device=card)
    a @ a                                   # the first call's set-up, untimed
    torch.cuda.synchronize()
    timer = StageTimer()
    with timer.stage("matmul") as box:
        for _ in range(20):
            b = a @ a
        box["b"] = b
        box["note"] = "not a tensor"
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        a @ a
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1e3
    # the stage's clock stopped after the card finished, not at dispatch
    assert timer.records[0]["wall_s"] >= 0.9 * device_s
    stats = device_memory_stats()
    assert stats["cuda:0"]["bytes_in_use"] > 0 and stats["cuda:0"]["bytes_limit"] > 0
