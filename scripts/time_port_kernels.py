"""Time the port's redesigned kernels of one checkout on the card, A/B-ready.

    python scripts/time_port_kernels.py [CHECKOUT] [TAG] [--profile] [--fused]

CHECKOUT (default: this repository) is the root of a checkout of any
commit whose ``pmarlo_tpu_torch`` has ``build_periodic_force_fn``,
``build_cell_force_fn``, ``build_bonded_window`` and
``build_pair_force_fn(gb_cutoff=, newton=)``; its kernels are built from
its own sources, and timed by this repository's ``chip_smoke.py``
(``_cuda_ms``, ``_graph_ms``). To compare two commits on one card, unpack
the other one with ``git archive`` into a git-ignored directory and run
parent, change, change, parent in one call. Prints one line: TAG and a
JSON object of device ms (CUDA events):

- ``*_call_ms``: wrapper calls back to back after one warm-up, the time a
  caller sees on the card's stream, host work between launches included;
- ``*_graph_ms``: one replay of a CUDA graph that captured the same calls,
  over their number (five replays, the median): the kernels and the
  wrapper's own small device operations, without the host.

Shapes, positions the files' own plus Gaussian noise from fixed seeds (no
minimization), so pair counts differ a little from ``chip_smoke.py``'s:

- ``periodic_r8``: the dense periodic sweep on the shipped solvated
  chignolin (2,315 atoms), R = 8; ``cell_chignolin_r8``: the cell sweep
  there; ``cell_water_r1`` / ``cell_water_r4``: the cell sweep on the
  27,783-atom TIP3P box (50 calls each, call times only);
- the fused kernels at R = 32 (``chip_smoke.py`` phases 2, 8 and 9's
  shapes, crystal positions plus noise): ``chunk_n22`` (alanine) and
  ``chunk_n138`` (chignolin), 100 steps a call; ``bias_n138``, the same
  with the harmonic CV bias of a random default-width DeepTICA model;
  ``remd_n138`` / ``remd_bias_n138``, ``run_fused`` of 200 steps (2
  windows, 4 frames) unbiased and biased, a call and the kernel's device
  time (``*_device_ms``, ``torch.profiler``); with ``--fused`` only these;
- phase 17's: ``chignolin_assembly((8, 8, 7))`` (61,824 atoms) in GBn2
  with the X-H bond terms stripped, R = 1, tile 128, cutoff 1.5 nm, Morton
  order: ``bonded`` (50 calls), the ordered culled sweeps
  ``culled_{born,energy,force}`` and the Newton sweeps
  ``newton_{born,energy,force}``, each with its own patch list (20 calls).

With ``--profile``, ``kernels_us``: each CUDA kernel's mean device
microseconds a launch over 20 bonded calls and 20 ordered force sweeps,
from ``torch.profiler``.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
ARGS = [a for a in sys.argv[1:] if a not in ("--profile", "--fused")]
PROFILE = "--profile" in sys.argv[1:]
FUSED_ONLY = "--fused" in sys.argv[1:]
ROOT = ARGS[0] if ARGS else str(HERE)
TAG = ARGS[1] if len(ARGS) > 1 else ROOT
sys.path.insert(0, ROOT)

_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

from pmarlo_tpu_torch.data.chignolin import chignolin_assembly  # noqa: E402
from pmarlo_tpu_torch.data.water import water_box_structure  # noqa: E402
from pmarlo_tpu_torch.io.pdb import read_pdb  # noqa: E402
from pmarlo_tpu_torch.md.bonded_window import build_bonded_window  # noqa: E402
from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn  # noqa: E402
from pmarlo_tpu_torch.md.cells import bin_atoms  # noqa: E402
from pmarlo_tpu_torch.md.constraints import strip_constrained_bonded  # noqa: E402
from pmarlo_tpu_torch.md.forcefield import build_system  # noqa: E402
from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn  # noqa: E402
from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn  # noqa: E402


def _time(out: dict, name: str, call, reps: int, graph: bool = True) -> None:
    out[f"{name}_call_ms"] = smoke._cuda_ms(call, reps)
    if graph:
        out[f"{name}_graph_ms"] = smoke._graph_ms(call, reps)


def _noisy(x: torch.Tensor, R: int, seed: int, sigma: float) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return (x[None] + torch.as_tensor(rng.normal(0.0, sigma, (R,) + tuple(x.shape)),
                                      dtype=torch.float32, device="cuda")).contiguous()


def _binned(fn, x: torch.Tensor):
    order, cell_start, _, xw = bin_atoms(fn.grid, x)
    return xw, order.contiguous(), cell_start.contiguous()


def _explicit(out: dict) -> None:
    st = read_pdb(str(Path(ROOT) / "examples/outputs/explicit_solvent/chignolin_solvated.pdb"))
    system, pos = build_system(st, box=st.box, cutoff=0.9, device="cuda")
    x = _noisy(pos, 8, 11, 0.005)
    dense = build_periodic_force_fn(system)
    cells = build_cell_force_fn(system)
    binned = _binned(cells, x)
    _time(out, "periodic_r8", lambda: dense.sweep(x), 50, graph=False)
    _time(out, "cell_chignolin_r8", lambda: cells.sweep(*binned), 50, graph=False)
    structure, box = water_box_structure(21)
    water, x0 = build_system(structure, box=box, cutoff=0.9, hydrogen_mass=None, device="cuda")
    cells = build_cell_force_fn(water)
    for R in (1, 4):
        binned = _binned(cells, _noisy(x0, R, 13, 0.02))
        _time(out, f"cell_water_r{R}", lambda: cells.sweep(*binned), 50, graph=False)


def _fused(out: dict) -> None:
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.data.chignolin import chignolin_structure
    from pmarlo_tpu_torch.features import TopologyInfo, phi_psi_indices
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
    from pmarlo_tpu_torch.md.topology import build_topology
    from pmarlo_tpu_torch.remd.remd import ReplicaExchange

    R = smoke.N_REPLICAS
    for tag, structure in (("n22", alanine_dipeptide_structure()),
                           ("n138", chignolin_structure())):
        system, pos = build_system(structure, gb_model="gbn2", device="cuda")
        x, v, seeds, temps = smoke._md_inputs(system, pos, R, seed=8)
        chunk = build_fused_chunk(system, dt=smoke.DT_PS, friction=1.0, n_replicas=R)
        _time(out, f"chunk_{tag}", lambda: chunk(x, v, seeds, temps, 100, 0), 10, graph=False)
        out[f"chunk_{tag}_shape"] = chunk.last_launch
    info = TopologyInfo.from_topology(build_topology(structure))
    phi, psi, _ = phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    quads = np.concatenate([phi, psi], axis=0)
    model = smoke._random_model(len(quads), seed=8)
    biased = build_fused_chunk(system, dt=smoke.DT_PS, friction=1.0, n_replicas=R,
                               bias_model=model, bias_quads=quads, bias_strength=2.0)
    _time(out, "bias_n138", lambda: biased(x, v, seeds, temps, 100, 0), 10, graph=False)
    cfg = smoke._remd_config(seed=9)
    for tag, kb in (("remd_n138", None),
                    ("remd_bias_n138", {"model": model, "quads": quads, "strength": 2.0})):
        r = ReplicaExchange(system, pos, cfg, device="cuda", minimize=False, use_kernel=True,
                            kernel_bias=kb)
        _time(out, tag, lambda: r.run_fused(200), 5, graph=False)
        out[f"{tag}_device_ms"] = smoke._device_ms(lambda: r.run_fused(200), 5, "fused_remd")


def _kernels_us(calls) -> dict:
    """Mean device microseconds a launch of each CUDA kernel that
    ``calls`` (each called 20 times) launch, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in calls:
            for _ in range(20):
                call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        device_us = getattr(ev, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(ev, "self_cuda_time_total", 0.0)
        if device_us > 0 and ev.count > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            out[ev.key[:80]] = device_us / ev.count
    return out


def _large(out: dict) -> None:
    system, x0 = build_system(chignolin_assembly((8, 8, 7)), gb_model="gbn2", device="cuda",
                              dense_scales=False)
    md_system = strip_constrained_bonded(system)
    x = _noisy(x0, 1, 31, 0.005)
    out["atoms"] = system.n_atoms
    bonded = build_bonded_window(md_system)
    _time(out, "bonded", lambda: bonded(x), 50)
    cut = dict(tile=128, gb_cutoff=1.5, order_from=x0)
    fo = build_pair_force_fn(md_system, newton=False, **cut)
    xs = fo.to_storage(x).contiguous()
    close = fo.close_tiles(xs)
    B, dB = fo.born_radii(fo.born(xs, close))
    _, dEdB = fo.energy_rows(xs, B, close)
    _, c = fo.gb_terms(B, dB, dEdB)
    B, c = B.contiguous(), c.contiguous()
    fn = build_pair_force_fn(md_system, newton=True, **cut)
    for mode, f in (("culled", fo), ("newton", fn)):
        _time(out, f"{mode}_born", lambda: f.born(xs, close), 20)
        _time(out, f"{mode}_energy", lambda: f.energy_rows(xs, B, close), 20)
        _time(out, f"{mode}_force", lambda: f.pair_forces(xs, B, c, close), 20)
    if PROFILE:
        out["kernels_us"] = _kernels_us([lambda: bonded(x),
                                         lambda: fo.pair_forces(xs, B, c, close)])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_port_kernels.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    out = {"card": card}
    _fused(out)
    if not FUSED_ONLY:
        _explicit(out)
        _large(out)
    print(TAG, json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
