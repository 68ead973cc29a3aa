"""The dense GB Born and energy kernels of ``pmarlo_tpu_torch``
(``csrc/pair_force.cu`` ``pair_born_kernel``, ``pair_energy_kernel``), which
take each unordered pair once in (row tile, column tile >= row tile) blocks,
as the dense force kernel does, and add per-slot partials in a fixed order:
each pair adds H_ij / 2 + neck to I_i and H_ji / 2 + neck to I_j, and
0.5 e_nb + e_gb to both atoms' energy rows with each atom's own dE/dB term.

On the CPU: plain PyTorch versions of the block decomposition (used by these
tests only, never on the main path) against the plain versions of
``md/pair_force.py``, a rerun bitwise equal, a negative-screening (sulfur)
atom, a system of one diagonal block, the whole evaluation against the JAX
package's Pallas pair sweeps in interpret mode, and the slot scratch's size
and refusal. On the card (``gpu``-marked; they skip here): each kernel
against its plain version and two launches bitwise equal, at R = 1 and 8:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_pair_energy_born_redesign.py``.

Tolerances: I, energy rows and dE/dB to 1e-5 of their max, the whole
evaluation's energy to 1e-5 relative and its forces to 1e-4 of max |F| (the
rounding of sums taken in another order, and on the card single
special-function results).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly, chignolin_structure
from pmarlo_tpu_torch.md import pair_force
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.pair_force import FORCE_TILE, _r2, build_pair_force_fn, dense_scratch
from pmarlo_tpu_torch.md.system import system_from_numpy

STRUCTURES = {
    "alanine_22": lambda: alanine_dipeptide_structure(),
    "chignolin_138": lambda: chignolin_structure(),
    "chignolin_276": lambda: chignolin_assembly((2, 1, 1)),
}
# the GBn2 screening of sulfur, the one negative screening (md/gbn2.py)
SULFUR_SCREEN = -0.703469


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _noisy(x, R, seed=0, sigma=0.01):
    rng = np.random.default_rng(seed)
    return (np.asarray(x)[None] + rng.normal(0.0, sigma, (R,) + tuple(np.shape(x)))
            ).astype(np.float32)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# --- plain versions of the block decomposition ---------------------------------------


def _blocks(x):
    """The kernels' blocks (row tile r, column tile c >= r) of ``FORCE_TILE``
    atoms: ``(rt, ct, s, e, cols, r, one)`` with the distances ``r`` of the
    block's pairs and the mask ``one`` of those a kernel takes (genuine, and
    on a diagonal block column > row)."""
    n = x.shape[1]
    T = FORCE_TILE
    idx = torch.arange(n, device=x.device)
    for ct in range(-(-n // T)):
        cols = idx[ct * T:(ct + 1) * T]
        for rt in range(ct + 1):
            s, e = rt * T, min((rt + 1) * T, n)
            d = x[:, s:e, None, :] - x[:, None, cols, :]
            r2 = _r2(d)
            pair = r2 > 1e-8
            if rt == ct:
                pair = pair & (cols[None, :] > idx[s:e, None])
            r = torch.where(pair, torch.sqrt(r2 + 1e-12), torch.ones_like(r2))
            yield rt, ct, s, e, cols, r, pair.to(x.dtype)


def _slot_sum(x, parts, components, dtype):
    """Each block's (rows part, columns part) to the slots of the partner
    tiles (row atoms to slot c, column atoms to slot r; a diagonal block:
    both to slot r), every slot written once, then an atom's G slots added
    in slot order."""
    R, n = x.shape[:2]
    G = -(-n // FORCE_TILE)
    slots = torch.full((R, G, n) + components, float("nan"), dtype=dtype, device=x.device)
    for rt, ct, s, e, cols, rows_part, cols_part in parts:
        if rt == ct:
            slots[:, rt, s:e] = rows_part + cols_part
        else:
            slots[:, ct, s:e] = rows_part
            slots[:, rt, cols] = cols_part
    assert not bool(slots.isnan().any()), "a slot was left unwritten"
    out = torch.zeros((R, n) + components, dtype=dtype, device=x.device)
    for slot in range(G):
        out = out + slots[:, slot]
    return out


def block_born(fn, x):
    """Plain version of ``pair_born_kernel``: each unordered pair once,
    H_ij / 2 + neck to I_i and H_ji / 2 + neck to I_j; a block's sums in
    float32, the slots and their sum in float64."""
    def parts():
        for rt, ct, s, e, cols, r, one in _blocks(x):
            to_row, to_col = fn.born_pair_terms(s, e, cols, r, one, columns=True)
            yield rt, ct, s, e, cols, to_row.sum(2).double(), to_col.sum(1).double()

    return _slot_sum(x, parts(), (), torch.float64).to(x.dtype)


def block_energy(fn, x, B):
    """Plain version of ``pair_energy_kernel``: each unordered pair once,
    0.5 e_nb + e_gb to both atoms' rows and each atom's dE/dB term to it;
    pair terms in float64 as the energy twin takes them, float64 slots.
    Returns ``(e_rows float64, dEdB)``."""
    xd = x.double()

    def parts():
        for rt, ct, s, e, cols, r, one in _blocks(xd):
            e_pair, db_row, db_col = fn.energy_pair_terms(B, s, e, cols, r, one, columns=True)
            rows_part = torch.stack([e_pair.sum(2), db_row.sum(2)], -1)
            cols_part = torch.stack([e_pair.sum(1), db_col.sum(1)], -1)
            yield rt, ct, s, e, cols, rows_part, cols_part

    out = _slot_sum(xd, parts(), (2,), torch.float64)
    return out[..., 0], out[..., 1].to(x.dtype)


def _setup(structure, R=2, seed=11, screen=None):
    """The port's dense pair force of ``structure`` (optionally with the
    screening of some atoms replaced), positions (R, N, 3) and the Born
    radii of the plain Born sweep."""
    system, pos = build_system(structure, gb_model="gbn2", device="cpu", dense_scales=False)
    if screen is not None:
        system = dataclasses.replace(system, gb_screen=screen(system.gb_screen.clone()))
    fn = build_pair_force_fn(system)
    x = torch.from_numpy(_noisy(pos.numpy(), R, seed=seed))
    B, _ = fn.born_radii(fn.born_reference(x))
    return fn, x, B


@pytest.fixture(scope="module")
def dense():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _setup(STRUCTURES[name]())
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_born_block_decomposition_matches_plain_born(dense, name):
    """Blocks, slots and the slot sum give the row-owned plain version's
    Born integrals to 1e-5 of their max (22 atoms: one diagonal block; 276
    atoms: three tiles, the last ragged)."""
    fn, x, _ = dense(name)
    assert _rel(block_born(fn, x), fn.born_reference(x)) <= 1e-5


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_energy_block_decomposition_matches_plain_energy_rows(dense, name):
    """The same for the energy rows (each pair's 0.5 e_nb + e_gb to both
    atoms) and dE/dB, and the rows' total to 1e-5 relative."""
    fn, x, B = dense(name)
    e, d = block_energy(fn, x, B)
    ep, dp = fn.energy_rows_reference(x, B)
    assert e.dtype == torch.float64
    assert _rel(e, ep) <= 1e-5
    assert _rel(d, dp) <= 1e-5
    assert _rel(e.sum(-1), ep.sum(-1)) <= 1e-5


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_born_and_energy_block_decompositions_are_bitwise_reproducible(dense, name):
    """Every sum of the decomposition has a fixed order: two runs give the
    same bits, as two launches of the kernels must."""
    fn, x, B = dense(name)
    assert torch.equal(block_born(fn, x), block_born(fn, x))
    e1, d1 = block_energy(fn, x, B)
    e2, d2 = block_energy(fn, x, B)
    assert torch.equal(e1, e2) and torch.equal(d1, d2)


def _with_sulfur(screen):
    """Every seventh atom's screening set to sulfur's negative value."""
    screen[::7] = SULFUR_SCREEN
    return screen


def test_negative_screening_pairs_are_inactive_in_both_directions():
    """Sulfur's negative screening gives U = r + sr_j <= rho_i for close
    pairs, where H is zero in that direction only; the block decomposition
    holds the plain version there (I, energy rows, dE/dB to 1e-5)."""
    fn, x, B = _setup(chignolin_assembly((2, 1, 1)), screen=_with_sulfur)
    assert bool((fn.sr < 0).any())
    d = x[0][:, None, :] - x[0][None, :, :]
    r = torch.sqrt(_r2(d) + 1e-12)
    inactive = (r + fn.sr[None, :] <= fn.rho[:, None]) & (r > 1e-4)
    assert bool(inactive.any()), "no inactive pair: the case is not exercised"
    assert bool((inactive & ~inactive.T).any()), "no pair inactive in one direction only"
    assert _rel(block_born(fn, x), fn.born_reference(x)) <= 1e-5
    e, db = block_energy(fn, x, B)
    ep, dp = fn.energy_rows_reference(x, B)
    assert _rel(e, ep) <= 1e-5 and _rel(db, dp) <= 1e-5


def test_a_system_of_one_block_takes_the_diagonal_rule():
    """N <= FORCE_TILE is one diagonal block: each unordered pair once (the
    pairs with column > row), both atoms' shares to slot 0; each I_i holds
    all N - 1 partners."""
    fn, x, B = _setup(alanine_dipeptide_structure(), R=3, seed=5)
    n = x.shape[1]
    assert n <= FORCE_TILE
    blocks = list(_blocks(x))
    assert len(blocks) == 1
    one = blocks[0][-1]
    assert int(one[0].sum()) == n * (n - 1) // 2
    assert _rel(block_born(fn, x), fn.born_reference(x)) <= 1e-5
    e, d = block_energy(fn, x, B)
    ep, dp = fn.energy_rows_reference(x, B)
    assert _rel(e, ep) <= 1e-5 and _rel(d, dp) <= 1e-5


def _jax_system(name):
    """The JAX package's system and positions for a structure of
    ``STRUCTURES``."""
    from pmarlo_tpu.io.pdb import PDBAtom, PDBResidue, PDBStructure
    from pmarlo_tpu.md.forcefield import build_system as jax_build_system

    s = STRUCTURES[name]()
    residues = [PDBResidue(name=r.name, resid=r.resid, chain=r.chain, atoms=[
        PDBAtom(name=a.name, resname=a.resname, resid=a.resid, chain=a.chain,
                xyz=a.xyz, element=a.element) for a in r.atoms]) for r in s.residues]
    return jax_build_system(PDBStructure(residues=residues), gb_model="gbn2")


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_block_decompositions_match_jax_pair_sweeps(name):
    """The whole evaluation with the Born and energy block decompositions as
    its Born and energy sweeps against
    ``pallas_pair.build_pair_force_fn(tile=128, interpret=True)``, whose Born
    integrals and energies come from the Pallas ``sweep1`` and ``sweep2``:
    energy to 1e-5 relative, forces to 1e-4 of max |F|."""
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system(name)
    fn = build_pair_force_fn(system_from_numpy(js.to_dict()))
    x = _noisy(jx, 1, seed=12)[0]
    je, jf = jax_pair(js, tile=128, interpret=True)(jnp.asarray(x))
    te, tf = fn._evaluate(torch.from_numpy(x),
                          lambda xs, close: block_born(fn, xs),
                          lambda xs, B, close: block_energy(fn, xs, B),
                          fn.pair_forces_reference, fn.bonded_reference)
    je, jf = float(je), np.asarray(jf)
    assert abs(float(te) - je) <= 1e-5 * abs(je)
    assert np.abs(tf.numpy() - jf).max() <= 1e-4 * np.abs(jf).max()


def test_float32_path_takes_the_electrostatic_constants_as_jax_kernels_do():
    """JAX's Pallas pair sweeps hold ke and gb_pref as float32 literals (a
    Python float in float32 arithmetic), the values the port's kernels
    receive (their C interface passes float): the port's float32 path, plain
    versions included, takes exactly those, and a float64 twin the exact
    float64 values, so that it measures their rounding too."""
    import re

    import jax
    import jax.numpy as jnp
    from pmarlo_tpu.md.pallas_pair import build_pair_force_fn as jax_pair

    js, jx = _jax_system("alanine_22")
    ts = system_from_numpy(js.to_dict())
    ke = pair_force.COULOMB_CONSTANT_KJ_NM_PER_MOL_E2 / js.solute_dielectric
    gb_pref = (-0.5 * pair_force.COULOMB_CONSTANT_KJ_NM_PER_MOL_E2
               * (1.0 / js.solute_dielectric - 1.0 / js.solvent_dielectric))
    jaxpr = str(jax.make_jaxpr(jax_pair(js, tile=128, interpret=True))(jnp.asarray(jx)))
    literals = {float(v) for v in re.findall(r"(-?\d+\.\d+(?:e[-+]?\d+)?):f32", jaxpr)}
    fn32 = build_pair_force_fn(ts)
    fn64 = build_pair_force_fn(ts, dtype=torch.float64)
    for exact, ours in ((ke, fn32.ke), (gb_pref, fn32.gb_pref), (2 * gb_pref, 2 * fn32.gb_pref)):
        near = {v for v in literals if abs(v - exact) <= 1e-6 * abs(exact)}
        assert near == {float(np.float32(exact))} == {ours}
        assert ours != exact
    assert (fn64.ke, fn64.gb_pref) == (ke, gb_pref)


def test_dense_scratch_sizes_and_the_refusal(monkeypatch):
    """The slot scratch of each dense sweep (R, G, N, K) and its bytes at the
    protein shape; a launch whose scratch exceeds a quarter of the card's
    memory raises before anything is allocated or launched."""
    assert dense_scratch("born", 8, 3726) == ((8, 30, 3726), torch.float64, 7_153_920)
    assert dense_scratch("energy", 8, 3726) == ((8, 30, 3726, 2), torch.float64, 14_307_840)
    assert dense_scratch("force", 8, 3726) == ((8, 30, 3726, 3), torch.float32, 10_730_880)
    # an 80 GB card: the energy sweep's ~R N^2 / 8 bytes stop fitting a
    # quarter of it near N = 147,000 at R = 8
    quarter = 80 * 10**9 // 4
    assert dense_scratch("energy", 8, 140_000)[2] <= quarter < dense_scratch("energy", 8, 150_000)[2]

    system, pos = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")
    fn = build_pair_force_fn(system)

    class Card:
        total_memory = 4 * dense_scratch("energy", 2, 22)[2] - 4

    class Library:
        def __getattr__(self, name):
            raise AssertionError(f"{name} was called")

    monkeypatch.setattr(fn, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Card)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("Stream", (), {"cuda_stream": 0}))
    monkeypatch.setattr(pair_force, "_library", Library)
    x = pos[None].expand(2, -1, -1).contiguous()
    B = torch.ones(x.shape[:2])
    with pytest.raises(ValueError, match="quarter of the card's memory"):
        fn._launch("energy", x, B)
    # 8 of the energy sweep's 16 bytes an atom and slot: it fits, and launches
    with pytest.raises(AssertionError, match="pmarlo_pair_sweep was called"):
        fn._launch("born", x)


# --- on the card ---------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case,R", [("3726_atoms", 1), ("3726_atoms", 8),
                                    ("276_atoms_sulfur", 8)])
def test_born_and_energy_kernels_match_plain_and_rerun_bitwise_on_the_card(case, R):
    """Each kernel against its plain version on the same card tensors: I,
    energy rows and dE/dB to 1e-5 of their max, the rows' totals to 1e-5
    relative; two launches of each give the same bits; the 276-atom case
    carries negative (sulfur) screening, where the block decomposition is
    held too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    copies = (3, 3, 3) if case == "3726_atoms" else (2, 1, 1)
    system, pos = build_system(chignolin_assembly(copies), gb_model="gbn2",
                               device="cuda", dense_scales=False)
    if case.endswith("sulfur"):
        system = dataclasses.replace(system, gb_screen=_with_sulfur(system.gb_screen.clone()))
    x = torch.as_tensor(_noisy(pos.cpu().numpy(), R, seed=16, sigma=0.005), device="cuda")
    fn = build_pair_force_fn(system)
    before = dict(pair_force.launches)
    Ip = fn.born_reference(x)
    I1, I2 = fn.born(x), fn.born(x)
    B, _ = fn.born_radii(Ip)
    (e1, d1), (e2, d2) = fn.energy_rows(x, B), fn.energy_rows(x, B)
    ep, dp = fn.energy_rows_reference(x, B)
    torch.cuda.synchronize()
    assert _rel(I1, Ip) <= 1e-5
    assert _rel(e1, ep) <= 1e-5 and _rel(d1, dp) <= 1e-5
    assert _rel(e1.sum(-1), ep.sum(-1)) <= 1e-5
    assert torch.equal(I1, I2)
    assert torch.equal(e1, e2) and torch.equal(d1, d2)
    assert {k: v - before[k] for k, v in pair_force.launches.items() if v != before[k]} == {
        "pair_born": 2, "pair_energy": 2}
    if case.endswith("sulfur"):
        assert _rel(I1, block_born(fn, x)) <= 1e-5
        eb, db = block_energy(fn, x, B)
        assert _rel(e1, eb) <= 1e-5 and _rel(d1, db) <= 1e-5
