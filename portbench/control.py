#!/usr/bin/env python3
"""The readings that the limits of ``portbench/limits/<cell>.json`` are set
from, on the card at the cell's own size:

- the program: for each seed, set-up as a run makes it, then segments
  judged as a run judges them (every number of ``check.judge``);
- the control: the plain reference put in the program's place with its
  force and energy evaluation in bfloat16 (the configuration states
  float32, and the port has no lower-precision path of its own), the state
  kept in float32. As a served model's control reads its gaps at the
  program's own tokens, it does not integrate a whole segment: from the
  program's state at a segment's start it integrates the windows the check
  replays, gives the energies of every frame (its own frames there, the
  program's after), and decides every exchange from those energies; the
  same comparison judges it.

- a planted fault of the CV bias (``--fault``), on the program's side: the
  kernel run with the bias dropped (``bias-dropped``) or with its strength,
  and so its gradient, negated (``bias-flipped``), while the reference keeps
  the cell's bias.

    python3 portbench/control.py --workload <config>.<mix> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--segments 3] [--fault bias-dropped]

The cell is found by its name (``configs/<config>.json``,
``traffic/<mix>.json``), whether or not ``BENCHMARK.json`` lists it, and no
limit is read. Prints one JSON line a seed: every number the check compares
and, in a cell with a CV bias, the bias's largest energy and largest force
component over the judged frames (the reference's, kJ/mol and kJ/mol/nm).
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)


def control_segment(session, start: dict, ref, program) -> types.SimpleNamespace:
    """A segment's outputs from the reference in the program's place:
    ``ref``'s type for forces and energies, float32 for the state; the
    frames after the replayed windows are ``program``'s."""
    from portbench.check import REPLAY_WINDOWS
    from portbench.reference.md import (baoab_window, ladder, swap_decisions, swap_target,
                                        swap_uniforms)

    R, dev = session.R, ref.device
    temps = ladder(session.t_min, session.t_max, R)
    fpc = session.exchange // session.report
    A = session.steps // session.exchange
    x = torch.as_tensor(start["positions"], device=dev)
    v = torch.as_tensor(start["velocities"], device=dev)
    seeds = torch.as_tensor(start["seeds"], device=dev)
    ids = np.asarray(start["ids"])
    u = swap_uniforms(session.seed, start["attempt"] + np.arange(A), R)
    frames, energies, hist, step = [], [], [ids], int(start["step"])
    for a in range(A):
        for k in range(fpc):
            if a < REPLAY_WINDOWS:
                x, v = baoab_window(ref, x, v, seeds, temps, step, session.report, session.dt,
                                    session.friction, state_dtype=torch.float32)
                step += session.report
            else:
                x = torch.as_tensor(program.positions[a * fpc + k], device=dev)
            frames.append(x.cpu().numpy())
            energies.append(ref.energy(x).float().cpu().numpy())
        left, acc, _ = swap_decisions(energies[-1].astype(np.float64), temps, u[a], a)
        src = swap_target(R, left, acc)
        t = torch.as_tensor(src, device=dev)
        scale = torch.as_tensor(np.sqrt(temps / temps[src]), device=dev, dtype=v.dtype)
        x, v, seeds = x[t], v[t] * scale[:, None, None], seeds[t]
        ids = ids[src]
        hist.append(ids)
    return types.SimpleNamespace(positions=np.stack(frames), potential_energy=np.stack(energies),
                                 replica_ids=np.stack(hist))


FAULTS = ("bias-dropped", "bias-flipped")


def plant(fault: str) -> None:
    """Every ``ReplicaExchange`` built from here on hands its kernel the CV
    bias dropped or with its strength negated."""
    from pmarlo_tpu_torch.remd.remd import ReplicaExchange

    init = ReplicaExchange.__init__

    def planted(self, *args, kernel_bias=None, **kwargs):
        if kernel_bias is not None:
            kernel_bias = (None if fault == "bias-dropped"
                           else dict(kernel_bias, strength=-kernel_bias["strength"]))
        init(self, *args, kernel_bias=kernel_bias, **kwargs)

    ReplicaExchange.__init__ = planted


def bias_size(session, results, device) -> dict:
    """The cell's CV bias at the program's frames, by the reference in
    float64: its largest |energy| and largest |force| component."""
    from portbench.check import reference_for

    bias = reference_for(session, device=device).bias
    e_max = f_max = 0.0
    for r in results:
        x = torch.as_tensor(np.asarray(r.positions), device=device).reshape(-1, session.N, 3)
        for s in range(0, x.shape[0], 1024):
            y = x[s:s + 1024].to(torch.float64).requires_grad_(True)
            e = bias.energy(y)
            (g,) = torch.autograd.grad(e.sum(), y)
            e_max = max(e_max, float(e.abs().max()))
            f_max = max(f_max, float(g.abs().max()))
    return {"bias_energy_max_kj": e_max, "bias_force_max_kj_nm": f_max}


def main(argv=None) -> int:
    from portbench import check, generator, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--segments", type=int, default=3)
    p.add_argument("--fault", choices=FAULTS, default=None)
    p.add_argument("--device", default="cuda", help="cpu: the program's plain path (tests)")
    a = p.parse_args(argv)
    config_name, mix_name = a.workload.rsplit(".", 1)
    config = generator.load_json("configs", config_name)
    mix = generator.load_json("traffic", mix_name)
    limits = collections.defaultdict(lambda: float("inf"))
    if a.device == "cuda" and not torch.cuda.is_available():
        print("control.py reads the card; no CUDA device", file=sys.stderr)
        return 2
    if a.fault:
        plant(a.fault)
    jobs = [(int(s), "program") for s in a.seeds.split(",") if s] + \
        [(int(s), "control") for s in a.control_seeds.split(",") if s]
    for seed, side in jobs:
        t0 = time.perf_counter()
        session = generator.Session(config, mix, seed, device=a.device)
        session.setup()
        starts, results = [], []
        for _ in range(a.segments if side == "program" else 1):
            starts.append(harness._host(session.state()))
            results.append(session.segment())
        session.close()
        if side == "control":
            low = check.reference_for(session, dtype=torch.bfloat16, device=a.device)
            results = [control_segment(session, starts[0], low, results[0])]
        t1 = time.perf_counter()
        numbers = check.judge(session, starts, results, limits, device=a.device)
        n_failed = sum(check.failed(r, session.R) for r in results)
        line = {"workload": a.workload, "side": side, "fault": a.fault, "seed": seed,
                "failed": n_failed, "numbers": {k: d["value"] for k, d in numbers.items()},
                "run_s": t1 - t0, "judge_s": time.perf_counter() - t1}
        if session.bias is not None and side == "program":
            line.update(bias_size(session, results, a.device))
        print(json.dumps(line), flush=True)
        del session
        if a.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
