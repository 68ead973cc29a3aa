"""Rank programs of the ``test_torch_parallel*.py`` files.

``spawn(task, world, tmp_path, **kw)`` starts ``world`` ranks (spawned
processes, gloo over a ``FileStore`` under ``tmp_path``: nothing touches
the network), runs ``TASKS[task](**kw)`` on each, and returns the ranks'
results in rank order. Each task runs several checks and hands back what
the parent compares. This module imports only torch and the port, so the
ranks start without JAX; the parent runs the JAX references.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ALANINE_REMD = dict(n_replicas=8, t_min=300.0, t_max=450.0, exchange_frequency=20,
                    report_interval=10, seed=3)
ALANINE_STEPS = 200
#: the explicit REMD through the cell path: solvated alanine, 325 atoms
EXPLICIT_REMD = dict(n_replicas=4, t_min=300.0, t_max=330.0, exchange_frequency=10,
                     report_interval=5, dt_ps=0.002, seed=0)
EXPLICIT_CUTOFF = 0.5
EXPLICIT_STEPS = 20
#: a sheared copy of the slab geometry that keeps nx = 8 ...
SLAB_TILT = (0.2, 0.1, 0.4)
#: ... and the one of JAX's multi-chip dry run, which has nx = 7
DRYRUN_TILT = (0.45, 0.3, 0.4)
#: FIRE iterations and rigid-water steps through the slab sweep, after
#: which the ranks' copies of the state must be the same bits
SLAB_FIRE, SLAB_STEPS = 20, 20
CARD_FIRE, CARD_STEPS = 200, 200


def _entry(rank, world, store, task, out, kw):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = TASKS[task](**kw)
    except Exception:        # handed to the parent, which fails the test with it
        result = {"error": traceback.format_exc()}
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(result, fh)
    dist.destroy_process_group()


def spawn(task: str, world: int, tmp_path, **kw) -> list:
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    out = str(tmp / f"{task}_{world}")
    mp.spawn(_entry, args=(world, str(tmp / f"store_{task}_{world}"), task, out, kw),
             nprocs=world, join=True)
    results = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as fh:
            res = pickle.load(fh)
        if "error" in res:
            raise AssertionError(f"rank {r} of {world} failed:\n{res['error']}")
        results.append(res)
    return results


@contextlib.contextmanager
def one_rank_world(tmp_path):
    """A process group of this process alone (gloo, ``FileStore``) and its
    1-D CPU mesh, torn down on exit."""
    from pmarlo_tpu_torch.parallel import replica_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp_path) / "store1"), 1),
                            rank=0, world_size=1)
    try:
        yield replica_mesh(1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _raises(fn, exc=ValueError) -> str:
    """The message of the ``exc`` that ``fn()`` raises ("" if none)."""
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


# --- geometry ---------------------------------------------------------------------


def alanine_system():
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.forcefield import build_system

    return build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cpu")


def lattice(n_side=(8, 4, 4), spacing=0.45, pdb=None):
    """The water lattice of JAX's multi-chip dry run (``__graft_entry__.py``):
    8 x 4 x 4 waters 0.45 nm apart, box edge + 0.05 nm, as a structure of
    ``pdb`` (the port's ``io.pdb`` module, or the JAX package's), and its box."""
    if pdb is None:
        from pmarlo_tpu_torch.io import pdb
    residues = []
    for rid, (i, j, k) in enumerate(np.ndindex(*n_side), start=1):
        o = (0.15 + i * spacing, 0.15 + j * spacing, 0.15 + k * spacing)
        atoms = [pdb.PDBAtom(name=nn, resname="HOH", resid=rid, chain="W", xyz=xyz,
                             element=el)
                 for nn, xyz, el in (
                     ("O", o, "O"),
                     ("H1", (o[0] + 0.09572, o[1], o[2]), "H"),
                     ("H2", (o[0] - 0.02399, o[1] + 0.09266, o[2]), "H"))]
        residues.append(pdb.PDBResidue(name="HOH", resid=rid, chain="W", atoms=atoms))
    return pdb.PDBStructure(residues=residues), tuple(n * spacing + 0.05 for n in n_side)


def slab_waters(n_side=(8, 4, 4), cutoff=0.45, device="cpu", tilt=None):
    """The System of ``lattice`` at cutoff 0.45 (nx = 8 cell layers
    orthorhombic); ``tilt`` shears the box."""
    from pmarlo_tpu_torch.md.forcefield import build_system

    structure, box = lattice(n_side)
    system, x = build_system(structure, box=box, tilt=tilt, cutoff=cutoff,
                             hydrogen_mass=None, device=device)
    return system, torch.as_tensor(x, dtype=torch.float32, device=device)


def jiggle(x: torch.Tensor, seed: int, sigma: float = 0.01) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return x + torch.as_tensor(rng.normal(0.0, sigma, tuple(x.shape)), dtype=x.dtype,
                               device=x.device)


# --- tasks ------------------------------------------------------------------------


def task_estimation(dtrajs, X, values, weights, edges, z0, zt, params, pairs_train):
    """The reductions, the data-parallel step (SGD lr 1) and a short
    training run, and what the mesh helpers refuse."""
    from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig
    from pmarlo_tpu_torch.parallel import (
        data_mesh,
        make_data_parallel_step,
        replica_mesh,
        shard_replicas,
        sharded_covariance_moments,
        sharded_histogram,
        sharded_transition_counts,
        train_deeptica_data_parallel,
    )

    world = dist.get_world_size()
    mesh = data_mesh(device_type="cpu")
    out = {
        "rank": dist.get_rank(),
        "axis": mesh.mesh_dim_names,
        "replica_axis": replica_mesh(world, device_type="cpu").mesh_dim_names,
        "wrong_size": _raises(lambda: replica_mesh(world + 1, device_type="cpu")),
        "block": shard_replicas(np.arange(4 * world * 3).reshape(4 * world, 3), mesh,
                                axis="shard").numpy(),
        "indivisible": _raises(lambda: shard_replicas(np.zeros((world + 1, 2)), mesh,
                                                      axis="shard")),
        "wrong_axis": _raises(lambda: shard_replicas(np.zeros((world, 2)), mesh)),
        "counts": sharded_transition_counts(dtrajs, 3, 5, mesh),
        "moments": sharded_covariance_moments(X, 5, mesh),
        "hist": sharded_histogram(values, edges, mesh),
        "hist_w": sharded_histogram(values, edges, mesh, weights=weights),
    }
    cfg = DeepTICAConfig(lag=5, n_out=2, hidden=(16,), seed=0)
    p = [{k: torch.as_tensor(v) for k, v in layer.items()} for layer in params]
    step = make_data_parallel_step(cfg, lambda leaves: torch.optim.SGD(leaves, lr=1.0), mesh)
    p, _, loss = step(p, None, torch.as_tensor(z0), torch.as_tensor(zt))
    out["dp_loss"] = float(loss)
    out["dp_params"] = [{k: v.detach().numpy() for k, v in layer.items()} for layer in p]
    tcfg = DeepTICAConfig(lag=5, n_out=1, hidden=(16,), seed=1, learning_rate=3e-3)
    _, losses = train_deeptica_data_parallel(*pairs_train, tcfg, mesh, n_epochs=25)
    out["train_losses"] = losses
    return out


def task_remd(tmp, explicit_x):
    """Alanine REMD sharded over the ranks, the checkpoint written sharded and
    read back with and without a mesh, an explicit REMD through the cell
    path, and what a mesh refuses."""
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.parallel import replica_mesh
    from pmarlo_tpu_torch.remd.checkpoint import load_checkpoint, save_checkpoint
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange, run_replica_exchange

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = replica_mesh(device_type="cpu")
    system, x = alanine_system()
    cfg = RemdConfig(**ALANINE_REMD)
    remd = ReplicaExchange(system, x, cfg, mesh=mesh)
    res = remd.run(ALANINE_STEPS)
    out = {"alanine": res, "local_rungs": remd.state.positions.shape[0],
           "device": str(remd.device)}
    path = save_checkpoint(remd, Path(tmp) / f"ck{world}.npz", extra={"world": world})
    after = remd.run(2 * cfg.exchange_frequency)
    resumed, _, extra = load_checkpoint(path, system, mesh=mesh)
    out.update(checkpoint_extra=extra, resumed_local_rungs=resumed.state.positions.shape[0],
               resumed_next=resumed.run(2 * cfg.exchange_frequency), next=after)
    if rank == 0:
        out["unsharded_resume"] = load_checkpoint(path, system, device="cpu")[0].run(
            2 * cfg.exchange_frequency)
    dist.barrier()
    out["explicit"] = {nb: explicit_remd(explicit_x, mesh, nb).run(EXPLICIT_STEPS)
                       for nb in ("cells", "dense")}
    odd = dataclasses.replace(cfg, n_replicas=4 * world + 1)
    waters, wx = slab_waters()
    out["refusals"] = {
        "indivisible": _raises(lambda: ReplicaExchange(system, x, odd, mesh=mesh,
                                                       minimize=False)),
        "use_kernel": _raises(lambda: ReplicaExchange(system, x, cfg, mesh=mesh,
                                                      use_kernel=True, minimize=False)),
        "run_fused": _raises(lambda: ReplicaExchange(system, x, cfg, mesh=mesh,
                                                     minimize=False).run_fused(20)),
        "not_a_mesh": _raises(lambda: ReplicaExchange(system, x, cfg, mesh=object(),
                                                      minimize=False), TypeError),
        "entry_indivisible": _raises(lambda: run_replica_exchange(
            alanine_dipeptide_structure(), n_steps=20, config=odd, mesh=mesh)),
        "slab_force_fn": _raises(lambda: ReplicaExchange(
            waters, wx, cfg, mesh=mesh, force_fn=build_cell_force_fn(waters, mesh=mesh),
            minimize=False)),
    }
    return out


def solvated_alanine():
    """Alanine dipeptide in a 5^3 water lattice, box 1.65 nm (the input of
    ``test_torch_explicit_remd.py``)."""
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.io.pdb import PDBStructure

    waters, box = water_box_structure(5)
    solute = alanine_dipeptide_structure()
    xyz = np.array([a.xyz for r in solute.residues for a in r.atoms])
    shift = 0.5 * box[0] - xyz.mean(0)
    for r in solute.residues:
        for a in r.atoms:
            a.xyz = tuple(float(v) for v in np.asarray(a.xyz) + shift)
    xyz = xyz + shift
    kept = [w for w in waters.residues
            if min(np.linalg.norm(xyz - np.asarray(a.xyz), axis=1).min()
                   for a in w.atoms) > 0.28]
    return PDBStructure(residues=solute.residues + kept, box=box)


def explicit_setup(nonbonded="cells"):
    from pmarlo_tpu_torch.md.setup import build_explicit_setup

    return build_explicit_setup(solvated_alanine(), cutoff=EXPLICIT_CUTOFF,
                                nonbonded=nonbonded, device="cpu")


def explicit_remd(x, mesh=None, nonbonded="cells"):
    """``ReplicaExchange`` of the solvated alanine through the cell sweep
    (replica-batched; ``"dense"``: the periodic sweep) with its
    constraints, from the minimized ``x``."""
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    setup = explicit_setup(nonbonded)
    return ReplicaExchange(setup.system, torch.as_tensor(x), RemdConfig(**EXPLICIT_REMD),
                           device="cpu", force_fn=setup.md_force_fn,
                           constraints=setup.constraints, minimize=False, mesh=mesh)


def slab_copies_in_step(system, x, mesh, fire: int, steps: int) -> dict:
    """FIRE from ``x``, then rigid-water ``run_md``, through the slab sweep
    of ``mesh``: this rank's copies of the positions after each (every rank
    holds the whole state, and the ranks must stay the same bits)."""
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.md.constraints import build_h_constraints, strip_constrained_bonded
    from pmarlo_tpu_torch.md.integrate import run_md, thermalize
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    x_min, _ = minimize_energy(system, x, force_fn=build_cell_force_fn(system, mesh=mesh),
                               max_iterations=fire)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(3)
    state, _ = run_md(system, thermalize(system, x_min, gen, 300.0), n_steps=steps,
                      dt=0.002, friction=1.0, temperature_K=300.0,
                      force_fn=build_cell_force_fn(strip_constrained_bonded(system), mesh=mesh),
                      constraints=build_h_constraints(system), report_interval=steps)
    return {"fire": x_min.cpu().numpy(), "md": state.positions.cpu().numpy()}


def task_slabs(device="cpu"):
    """The slab sweep of each mode against the unsharded one on every rank:
    energies and forces of both, this rank's scratch beside the unsharded
    scratch, its copy of the state through FIRE and ``run_md``, and JAX's
    refusals."""
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.parallel import replica_mesh

    world = dist.get_world_size()
    mesh = replica_mesh(device_type=device)
    out = {"modes": {}}
    for mode, tilt, elec in (("rf", None, "rf"), ("sheared", SLAB_TILT, "rf"),
                             ("pme", None, "pme")):
        system, x = slab_waters(device=device, tilt=tilt)
        x = jiggle(x, 7)
        fn = build_cell_force_fn(system, electrostatics=elec, mesh=mesh)
        serial = build_cell_force_fn(system, electrostatics=elec)
        e, f = fn(x)
        e0, f0 = serial(x)
        xs = torch.stack([x, jiggle(x, 8)])
        st = fn.init_state_batched(xs)
        eb, fb, _ = fn.apply_batched(xs, st)
        out["modes"][mode] = {
            "e": e.cpu().numpy(), "f": f.cpu().numpy(), "e0": e0.cpu().numpy(),
            "f0": f0.cpu().numpy(), "eb": eb.cpu().numpy(), "fb": fb.cpu().numpy(),
            "x": x.cpu().numpy(), "xs": xs.cpu().numpy(),
            "scratch": fn.scratch_bytes(x), "scratch0": serial.scratch_bytes(x),
            "local_shapes": fn.local_shapes, "serial_local_shapes": serial.local_shapes,
            "nx": fn.grid.nx,
        }
    system, x = slab_waters(device=device)
    out["in_step"] = slab_copies_in_step(system, jiggle(x, 7), mesh, SLAB_FIRE, SLAB_STEPS)
    system, _ = slab_waters(device=device, tilt=DRYRUN_TILT)
    small, _ = slab_waters(n_side=(2, 4, 4), device=device)
    out["refusals"] = {
        "indivisible": _raises(lambda: build_cell_force_fn(system, mesh=mesh)),
        "too_small": _raises(lambda: build_cell_force_fn(small, mesh=mesh)),
        "not_a_mesh": _raises(lambda: build_cell_force_fn(small, mesh=object()), TypeError),
    }
    out["world"] = world
    return out


def card_chignolin():
    """Chignolin (138 atoms) on the card and its pair force function
    (rows 3-5)."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_structure
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    system, x = build_system(chignolin_structure(), gb_model="gbn2", device="cuda",
                             dense_scales=False)
    return system, x, build_pair_force_fn(system)


def card_pair_remd(x_min, mesh=None):
    """Chignolin REMD through the pair kernels, 4 rungs, 60 steps, from
    ``x_min`` (minimized once, by the caller)."""
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    system, _, fn = card_chignolin()
    cfg = RemdConfig(n_replicas=4, t_min=300.0, t_max=360.0, exchange_frequency=20,
                     report_interval=10, seed=5)
    remd = ReplicaExchange(system, torch.as_tensor(x_min, device="cuda"), cfg,
                           device="cuda", force_fn=fn, minimize=False, mesh=mesh)
    return remd.run(60)


def card_slab_check(fn, serial, x):
    """The slab launch on ``x`` against the unsharded kernel (the whole
    evaluation) and against the plain slab sweep (this rank's partial), and
    two launches bitwise equal."""
    from pmarlo_tpu_torch.md import cell_force

    st = fn.init_state_batched(x[None])
    before = cell_force.launches["cell_force_slab"]
    ek, fk = fn.sweep(st.xw, st.order, st.cell_start)
    ek2, fk2 = fn.sweep(st.xw, st.order, st.cell_start)
    launched = cell_force.launches["cell_force_slab"] - before
    ep, fp = fn.sweep_reference(st.xw, st.order, st.cell_start)
    e, f = fn(x)
    e0, f0 = serial(x)
    return {
        "launched": launched, "bitwise": bool(torch.equal(fk, fk2) and torch.equal(ek, ek2)),
        "partial": (ek.sum().item(), fk.cpu().numpy(), ep.sum().item(), fp.cpu().numpy()),
        "whole": (e.item(), f.cpu().numpy(), e0.item(), f0.cpu().numpy()),
        "scratch": (fn.scratch_bytes(x), serial.scratch_bytes(x)),
    }


def task_card(x_min):
    """Rows 3-5 under a replica mesh and row 9's slab launch, on ``cuda``."""
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.md import pair_force
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.parallel import replica_mesh

    mesh = replica_mesh()
    out = {"device_type": mesh.device_type, "backend": dist.get_backend()}
    for k in pair_force.launches:
        pair_force.launches[k] = 0
    out["pair_remd"] = card_pair_remd(x_min, mesh)
    out["pair_launches"] = dict(pair_force.launches)
    out["slabs"] = {}
    for mode, tilt, elec in (("rf", None, "rf"), ("sheared", SLAB_TILT, "rf"),
                             ("pme", None, "pme")):
        system, x = slab_waters(device="cuda", tilt=tilt)
        x = jiggle(x, 7)
        out["slabs"][mode] = card_slab_check(
            build_cell_force_fn(system, electrostatics=elec, mesh=mesh),
            build_cell_force_fn(system, electrostatics=elec), x)
    structure, box = water_box_structure(12)
    system, x = build_system(structure, box=box, cutoff=0.45, hydrogen_mass=None,
                             device="cuda")
    x = jiggle(x.float(), 9, 0.005)
    out["slabs"]["water_box"] = card_slab_check(build_cell_force_fn(system, mesh=mesh),
                                                build_cell_force_fn(system), x)
    out["in_step"] = slab_copies_in_step(system, x, mesh, CARD_FIRE, CARD_STEPS)
    return out


TASKS = {"estimation": task_estimation, "remd": task_remd, "slabs": task_slabs,
         "card": task_card}
