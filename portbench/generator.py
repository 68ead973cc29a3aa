"""The one generator of the benchmark's traffic: a chemist's REMD job that
asks for its next segment as soon as the last one has returned (a closed
loop with one client).

A mix (``portbench/traffic/<mix>.json``) names the method of
``ReplicaExchange`` that runs a segment of ``steps_per_segment`` steps
(``"run_fused"``: the whole segment in one launch) and the CV bias the
kernel carries (``null``, or the DeepTICA harmonic expansion over the phi /
psi pairs of the interior residues). A configuration
(``portbench/configs/<config>.json``) gives the structure, the implicit
solvent and pmarlo's settings. Set-up builds the system from the frozen input,
minimizes it as ``ReplicaExchange(minimize=True)`` does, draws velocities
and Philox seeds from the seed, makes the bias model's weights on the
device from the seed, and warms up with one segment at the cell's shapes.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference.params import system_params

HERE = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def phi_psi_pairs(atom_names: List[str], residue_ids: List[int]) -> np.ndarray:
    """(2M, 4) atom quadruples: phi then psi of every residue with a peptide
    neighbour on both sides (M residues), phi = C(i-1) N CA C,
    psi = N CA C N(i+1)."""
    res: Dict[int, Dict[str, int]] = {}
    for k, (a, r) in enumerate(zip(atom_names, residue_ids)):
        res.setdefault(int(r), {})[a] = k
    ids = sorted(res)
    phi, psi = [], []
    for r in ids:
        cur, prev, nxt = res[r], res.get(r - 1), res.get(r + 1)
        if prev is None or nxt is None or "C" not in prev or "N" not in nxt:
            continue
        if not all(a in cur for a in ("N", "CA", "C")):
            continue
        phi.append((prev["C"], cur["N"], cur["CA"], cur["C"]))
        psi.append((cur["N"], cur["CA"], cur["C"], nxt["N"]))
    return np.asarray(phi + psi, np.int64).reshape(-1, 4)


def bias_weights(seed: int, widths: List[int], device) -> Dict[str, list]:
    """A DeepTICA model's weights, standardisation and whitening from the
    seed, made on the device in two calls, in float32: w ~ N(0, 2 / (in +
    out)), b ~ N(0, 0.1^2), the feature means ~ N(0, 0.3^2) and scales in
    (0.5, 1), the whitening mean ~ N(0, 0.1^2) and matrix ~ N(0, 1)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    k, n_out = widths[0], widths[-1]
    n = sum(a * b + b for a, b in zip(widths[:-1], widths[1:])) + k + n_out + n_out * n_out
    z = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    u = torch.rand(k, generator=g, device=device, dtype=torch.float32)
    out: Dict[str, list] = {"w": [], "b": []}
    o = 0
    for a, b in zip(widths[:-1], widths[1:]):
        out["w"].append(z[o:o + a * b].reshape(a, b) * math.sqrt(2.0 / (a + b)))
        o += a * b
        out["b"].append(z[o:o + b] * 0.1)
        o += b
    out["scaler_mean"] = z[o:o + k] * 0.3
    o += k
    out["scaler_scale"] = 0.5 + 0.5 * u
    out["whiten_mean"] = z[o:o + n_out] * 0.1
    o += n_out
    out["whiten_transform"] = z[o:o + n_out * n_out].reshape(n_out, n_out)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    return {key: [host(t) for t in v] if isinstance(v, list) else host(v)
            for key, v in out.items()}


class Session:
    """One cell's job: ``setup()``, then ``segment()`` as often as the window
    allows. ``device="cpu"`` runs the program's plain versions (tests
    only; the benchmark itself refuses to run without a card)."""

    def __init__(self, config: dict, mix: dict, seed: int, device: str = "cuda"):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        md, remd = config["md"], config["remd"]
        self.R = int(remd["n_replicas"])
        self.steps = int(md["steps_per_segment"])
        self.dt = float(md["timestep_ps"])
        self.friction = float(md["friction_per_ps"])
        self.report = int(md["report_interval"])
        self.exchange = int(remd["exchange_frequency"])
        self.t_min, self.t_max = float(remd["t_min"]), float(remd["t_max"])
        self.entry = mix["entry"]
        self.pdb = HERE / config["input"]
        self.inputs = system_params(self.pdb, config["hydrogen_mass_amu"], config["gb_model"])
        self.N = len(self.inputs["masses"])
        self.bias: Optional[dict] = None
        self.remd = None

    def setup(self) -> None:
        from pmarlo_tpu_torch.io.pdb import read_pdb
        from pmarlo_tpu_torch.md.forcefield import build_system
        from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

        t = [time.perf_counter()]
        system, positions = build_system(
            read_pdb(self.pdb), gb_model=self.config["gb_model"],
            hydrogen_mass=self.config["hydrogen_mass_amu"], device=self.device)
        cfg = RemdConfig(n_replicas=self.R, t_min=self.t_min, t_max=self.t_max,
                         exchange_frequency=self.exchange, dt_ps=self.dt,
                         friction_per_ps=self.friction, report_interval=self.report,
                         seed=self.seed)
        kernel_bias = None
        spec = self.mix.get("bias")
        if spec is not None:
            if spec["kind"] != "deeptica_harmonic" or spec["dihedrals"] != "phi_psi_pairs":
                raise ValueError(f"unknown bias {spec}")
            from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig, deeptica_from_numpy

            quads = phi_psi_pairs(self.inputs["atom_names"], self.inputs["residue_ids"])
            dcfg = DeepTICAConfig()
            widths = [2 * len(quads), *dcfg.hidden, dcfg.n_out]
            w = bias_weights(self.seed, widths, self.device)
            model = deeptica_from_numpy(
                dcfg, [{"w": a, "b": b} for a, b in zip(w["w"], w["b"])],
                w["scaler_mean"], w["scaler_scale"],
                {"mean": w["whiten_mean"], "transform": w["whiten_transform"]},
                device=self.device)
            self.bias = {"weights": w, "quads": quads, "strength": float(spec["strength"]),
                         "widths": widths}
            kernel_bias = {"model": model, "quads": quads, "strength": float(spec["strength"])}
        t.append(time.perf_counter())
        self.remd = ReplicaExchange(system, positions, cfg, device=self.device,
                                    use_kernel=self.device.type == "cuda", minimize=True,
                                    kernel_bias=kernel_bias)
        #: the minimized structure, which the check holds against the input
        self.start = {"positions": self.remd.state.positions.cpu().numpy()}
        self.done = 0
        t.append(time.perf_counter())
        self.segment()                      # warm-up at the cell's own shapes
        t.append(time.perf_counter())
        #: seconds of each stage: the system and bias model, ReplicaExchange
        #: (FIRE minimization, velocities, seeds), the warm-up segment
        self.stages = list(zip(("system and bias", "ReplicaExchange with FIRE", "warm-up segment"),
                               np.diff(t)))

    def state(self) -> dict:
        """The program's state before the next segment (references only:
        nothing is copied), with the global index of its first step and
        exchange attempt, counted here."""
        s = self.remd.state
        return {"positions": s.positions, "velocities": s.velocities, "seeds": s.seeds,
                "ids": self.remd.replica_ids, "step": self.done * self.steps,
                "attempt": self.done * (self.steps // self.exchange)}

    def segment(self):
        out = getattr(self.remd, self.entry)(self.steps)
        self.done += 1
        return out

    def close(self) -> None:
        self.remd = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
