"""Time the port's two explicit-solvent sweeps of one checkout on the card.

    python scripts/time_explicit_sweeps.py [CHECKOUT] [TAG]

CHECKOUT (default: this repository) is the root of a checkout of any
commit whose ``pmarlo_tpu_torch`` has ``build_periodic_force_fn`` and
``build_cell_force_fn``; its kernels are built from its own sources. To
compare two commits on one card, unpack the other one with ``git archive``
into a git-ignored directory and run parent, change, change, parent in one
call. Prints one line: TAG and a JSON object of mean device ms a sweep
(CUDA events, 50 launches after one warm-up) at the main paths' shapes:

- ``periodic_r8``: the dense sweep on the shipped solvated chignolin
  (2,315 atoms), R = 8 (explicit REMD with ``nonbonded="auto"``);
- ``cell_chignolin_r8``: the cell sweep at the same shape (``"cells"``);
- ``cell_water_r1`` / ``cell_water_r4``: the cell sweep on the 27,783-atom
  TIP3P box at R = 1 (``run_md``) and R = 4.

Positions are the files' own plus Gaussian noise from fixed seeds (no
minimization), so pair counts differ a little from ``chip_smoke.py``'s.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parents[1])
TAG = sys.argv[2] if len(sys.argv) > 2 else ROOT
sys.path.insert(0, ROOT)

from pmarlo_tpu_torch.data.water import water_box_structure  # noqa: E402
from pmarlo_tpu_torch.io.pdb import read_pdb  # noqa: E402
from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn  # noqa: E402
from pmarlo_tpu_torch.md.cells import bin_atoms  # noqa: E402
from pmarlo_tpu_torch.md.forcefield import build_system  # noqa: E402
from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn  # noqa: E402


def _ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _noisy(x: torch.Tensor, R: int, seed: int, sigma: float) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return x[None] + torch.as_tensor(rng.normal(0.0, sigma, (R,) + tuple(x.shape)),
                                     dtype=torch.float32, device="cuda")


def _binned(fn, x: torch.Tensor):
    order, cell_start, _, xw = bin_atoms(fn.grid, x)
    return xw, order.contiguous(), cell_start.contiguous()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_explicit_sweeps.py needs a CUDA card")
    st = read_pdb(str(Path(ROOT) / "examples/outputs/explicit_solvent/chignolin_solvated.pdb"))
    system, pos = build_system(st, box=st.box, cutoff=0.9, device="cuda")
    x = _noisy(pos, 8, 11, 0.005)
    dense = build_periodic_force_fn(system)
    cells = build_cell_force_fn(system)
    binned = _binned(cells, x)
    out = {"periodic_r8": _ms(lambda: dense.sweep(x)),
           "cell_chignolin_r8": _ms(lambda: cells.sweep(*binned))}
    structure, box = water_box_structure(21)
    water, x0 = build_system(structure, box=box, cutoff=0.9, hydrogen_mass=None, device="cuda")
    cells = build_cell_force_fn(water)
    for R in (1, 4):
        binned = _binned(cells, _noisy(x0, R, 13, 0.02))
        out[f"cell_water_r{R}"] = _ms(lambda: cells.sweep(*binned))
    print(TAG, json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
