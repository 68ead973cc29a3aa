"""Time the port's host-bound step paths of one checkout on the card, A/B-ready.

    python scripts/time_step_paths.py [CHECKOUT] [TAG]

CHECKOUT (default: this repository) is the root of a checkout of any
commit whose ``pmarlo_tpu_torch`` has ``run_replica_exchange(nonbonded=,
constraints=, gb_model=)``, ``build_pair_force_fn(gb_cutoff=)`` and
``md.constraints``; its kernels are built from its own sources, and its
shapes are those of this repository's ``chip_smoke.py``. To compare two
commits on one card, unpack the other one with ``git archive`` into a
git-ignored directory and run parent, change, change, parent in one call.
Prints one line: TAG and a JSON object, host wall (the card synchronised
at both ends):

- ``protein_remd_ms_per_step``: phase 7's 8-replica REMD of 27 chignolins
  (3,726 atoms, GBn2, X-H constraints, 4 fs, rows 3-5), 200 steps, the
  run's wall over its steps (exchanges and frames included, set-up not);
- ``explicit_remd_{dense,cells}_ms_per_step``: phase 13's 8-replica REMD
  of the solvated chignolin (2,315 atoms, rigid water + X-H, 2 fs) through
  row 8 and row 9, 200 steps each, as above;
- ``large_md_ms_per_step``: phase 17's 61,824-atom assembly (GBn2 cut at
  1.5 nm, Newton sweeps, bonded kernel, 27,328 X-H constraints, 4 fs),
  100 ``run_md`` steps after 300 FIRE iterations and 20 warm-up steps.

And ``scatter_us``, device microseconds a call (CUDA events, 200 calls)
of three ways to add rows by target, ``out[..., idx[t], :] +=
values[..., t, :]``, on two shapes: ``shake`` (the large assembly's
constraint rows, R = 1, the SHAKE / RATTLE correction) and ``bonded``
(the 3,726-atom system's bonded incidences, R = 8). ``index_add``:
``index_add_`` (CUDA atomics: the order of the adds, and so the last
bits, change from call to call); ``index_put``: ``index_put_(accumulate=
True)`` (sorted, fixed order); ``gather``: each target's rows through a
table padded with a zero row (``index_select``; the table (D, n), D the
most rows a target has), then a sum over D (fixed order; what
``md/analytic.py RowSums`` does). The last two are the same function
written inline here, whatever the checkout holds; ``*_max_diff`` is their
largest difference from ``index_add``.
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = sys.argv[1] if len(sys.argv) > 1 else str(HERE)
TAG = sys.argv[2] if len(sys.argv) > 2 else ROOT
sys.path.insert(0, ROOT)

_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from pmarlo_tpu_torch.data.chignolin import chignolin_assembly  # noqa: E402
from pmarlo_tpu_torch.md.analytic import make_bonded_params  # noqa: E402
from pmarlo_tpu_torch.md.constraints import (build_h_constraints,  # noqa: E402
                                             strip_constrained_bonded)
from pmarlo_tpu_torch.md.forcefield import build_system  # noqa: E402
from pmarlo_tpu_torch.md.integrate import run_md, thermalize  # noqa: E402
from pmarlo_tpu_torch.md.minimize import minimize_energy  # noqa: E402
from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn  # noqa: E402
from pmarlo_tpu_torch.remd.remd import RemdConfig, run_replica_exchange  # noqa: E402

STEPS = 200
LARGE_STEPS = 100


def _remd_ms(structure, dt_ps: float, **kw) -> float:
    cfg = RemdConfig(n_replicas=8, t_min=300.0, t_max=330.0, exchange_frequency=100,
                     report_interval=50, dt_ps=dt_ps, seed=0,
                     friction_per_ps=smoke.SHORT_RUN_FRICTION)
    res, _ = run_replica_exchange(structure, n_steps=STEPS, config=cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    return res.wall_seconds / STEPS * 1e3


def _large_ms() -> tuple:
    system, x0 = build_system(chignolin_assembly(smoke.LARGE_COPIES), gb_model="gbn2",
                              device="cuda", dense_scales=False)
    cut = dict(tile=smoke.LARGE_TILE, gb_cutoff=smoke.GB_CUTOFF, order_from=x0)
    spec = build_h_constraints(system)
    fn_md = build_pair_force_fn(strip_constrained_bonded(system), **cut)
    x_min, _ = minimize_energy(system, x0, force_fn=build_pair_force_fn(system, **cut),
                               max_iterations=smoke.LARGE_FIRE)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    kw = dict(dt=smoke.LARGE_DT_PS, friction=1.0, temperature_K=300.0, constraints=spec,
              force_fn=fn_md)
    state = thermalize(system, x_min, gen, 300.0)
    state, _ = run_md(system, state, n_steps=20, report_interval=20, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = run_md(system, state, n_steps=LARGE_STEPS, report_interval=50, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / LARGE_STEPS * 1e3, system, spec


def _gather_table(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(n, D): each target's positions in ``idx`` in order, padded with
    ``len(idx)`` (the zero row appended to the values)."""
    both = idx.cpu().numpy()
    deg = np.bincount(both, minlength=n)
    table = np.full((n, max(int(deg.max()), 1)), both.size, np.int64)
    by_target = np.argsort(both, kind="stable")
    first = np.cumsum(deg) - deg
    table[both[by_target], np.arange(both.size) - first[both[by_target]]] = by_target
    return torch.as_tensor(table, device=idx.device)


def _scatter(out: dict, name: str, idx: torch.Tensor, n: int, R: int) -> None:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    v = torch.randn((R, idx.shape[0], 3), device="cuda", generator=gen)
    table = _gather_table(idx, n).T.contiguous()
    flat = table.reshape(-1)
    zero = v.new_zeros((R, 1, 3))
    b = torch.arange(R, device="cuda")[:, None].expand(R, idx.shape[0])
    ib = idx[None, :].expand(R, -1)

    def index_add():
        return torch.zeros((R, n, 3), device="cuda").index_add_(1, idx, v)

    def index_put():
        return torch.zeros((R, n, 3), device="cuda").index_put_((b, ib), v, accumulate=True)

    def gather():
        rows = torch.cat([v, zero], 1).index_select(1, flat)
        return rows.unflatten(1, tuple(table.shape)).sum(1)

    ref = index_add()
    for fn_name, fn in (("index_add", index_add), ("index_put", index_put), ("gather", gather)):
        out[f"{name}_{fn_name}_us"] = smoke._cuda_ms(fn, 200) * 1e3
        if fn_name != "index_add":
            out[f"{name}_{fn_name}_max_diff"] = float((fn() - ref).abs().max())
    out[f"{name}_rows"] = int(idx.shape[0])
    out[f"{name}_table_width"] = int(table.shape[0])


def main() -> None:
    torch.cuda.init()
    out = {"card": smoke._card()}
    structure = chignolin_assembly(smoke.PROTEIN_COPIES)
    out["protein_remd_ms_per_step"] = _remd_ms(
        structure, smoke.PROTEIN_DT_PS, use_kernel=True, constraints="hbonds", gb_model="gbn2")
    pdb = str(Path(ROOT) / smoke.SOLVATED_PDB)
    for tag, nonbonded in (("dense", "auto"), ("cells", "cells")):
        out[f"explicit_remd_{tag}_ms_per_step"] = _remd_ms(pdb, smoke.DT_PS, nonbonded=nonbonded)
    out["large_md_ms_per_step"], large, spec = _large_ms()
    scatter = {}
    _scatter(scatter, "shake", torch.cat([spec.idx1, spec.idx2]), large.n_atoms, 1)
    protein, _ = build_system(structure, gb_model="gbn2", device="cuda")
    p = make_bonded_params(protein)
    idx = torch.cat([getattr(p, name)[:, k] for name in ("bond_idx", "angle_idx", "tor_idx")
                     for k in range(getattr(p, name).shape[1])])
    _scatter(scatter, "bonded", idx, protein.n_atoms, 8)
    out["scatter_us"] = scatter
    print(TAG, json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
