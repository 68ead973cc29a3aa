"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of numbers each:

1. build   - compile ``pmarlo_tpu_torch/csrc`` with nvcc (sm_90a), one
             nvcc a source, all started together.
2. kernel  - the fused Langevin kernel against its plain PyTorch twin at
             R=32 on alanine dipeptide in GBn2: energies and forces, then
             100 steps at friction 0 and at friction 1/ps.
3. thermo  - 10,000 kernel steps at 1/ps on the 300-450 K ladder: the
             ladder-averaged kinetic/target temperature ratio.
4. remd    - the main path: 32-replica REMD, 20,000 steps, one kernel
             launch per exchange window, then phi/psi -> MSM -> FES on
             rungs 0-3, and the 35-shard synthetic MSM build.
5. times   - REMD aggregate ns/day for the kernel and the plain path, and
             the warm MSM build.
6. pair    - the three GB pair kernels against their plain twins on the
             3,726-atom chignolin assembly (R=8, minimized + 0.005 nm
             noise): Born integrals, energy rows, dE/dB, forces, then the
             whole energy and forces, and both against a float64 twin;
             ms per sweep and per evaluation.
7. protein - the protein-scale path: 8-rung 300-330 K REMD of the assembly
             with every X-H bond constrained at 4 fs, through
             ``run_replica_exchange`` (pair kernels, FIRE, SHAKE/RATTLE,
             swaps); launches, ns/day, acceptance, temperature,
             constraint deviation. Its step count is cut to fit the time
             limit; atoms and replicas are not.

Then the card's name and power limit, one JSON line of the kernels, and
the last line ``{"ok": true, "device": {...}}``. A failed check raises and
the script exits non-zero without that line. It needs a CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

N_REPLICAS = 32
N_STEPS = 20_000
DT_PS = 0.002
EXCHANGE_FREQUENCY = 100
PLAIN_STEPS = 2_000
PROTEIN_COPIES = (3, 3, 3)        # 27 chignolins, 3,726 atoms
PROTEIN_REPLICAS = 8
PROTEIN_STEPS = 3_000            # cut to fit: ~29 ms a step on the H100
PROTEIN_DT_PS = 0.004
PAIR_KERNELS = ("pair_born", "pair_energy", "pair_force")


def _line(phase: str, numbers: dict) -> None:
    print(f"{phase}: {json.dumps(numbers)}", flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (warm)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ladder(n: int = N_REPLICAS) -> torch.Tensor:
    from pmarlo_tpu_torch.remd.remd import RemdConfig

    lad = RemdConfig(n_replicas=n, t_min=300.0, t_max=450.0).ladder()
    return torch.as_tensor(lad, dtype=torch.float32, device="cuda")


def _reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from pmarlo_tpu_torch.md import fused_md, pair_force

    fused_md.launches = 0
    for k in pair_force.launches:
        pair_force.launches[k] = 0


def _counts() -> dict:
    from pmarlo_tpu_torch.md import fused_md, pair_force

    return {"fused_md_chunk": fused_md.launches, **pair_force.launches}


def _mb_velocities(system, temps: torch.Tensor, rng) -> torch.Tensor:
    """Maxwell-Boltzmann velocities (R, N, 3) from a numpy generator."""
    from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL

    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * temps.cpu().numpy()
    m = system.masses.cpu().numpy()
    z = rng.standard_normal((len(kT), system.n_atoms, 3))
    v = np.sqrt(kT[:, None, None] / m[None, :, None]) * z
    return torch.as_tensor(v, dtype=torch.float32, device="cuda")


def phase_build() -> dict:
    from pmarlo_tpu_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build_library()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _kernels.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    out = {"build_s": secs, "library": path.name, "ptxas": ptxas}
    _line("phase 1 build", out)
    return out


def phase_kernel_vs_plain(system, x_min) -> dict:
    """Kernel against the plain twin on the same inputs (R=32)."""
    from pmarlo_tpu_torch.md import analytic
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk

    rng = np.random.default_rng(0)
    R = N_REPLICAS
    x = x_min[None] + torch.as_tensor(
        rng.normal(0.0, 0.005, (R, system.n_atoms, 3)), dtype=torch.float32,
        device="cuda",
    )
    temps = _ladder()
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, R), dtype=torch.int32,
                            device="cuda")
    v = _mb_velocities(system, temps, rng)
    out = {}

    chunk0 = build_fused_chunk(system, dt=DT_PS, friction=0.0, n_replicas=R)
    ek, fk = chunk0.energy_and_forces(x)
    ep, fp = analytic.energy_and_forces(chunk0.dense, x)
    torch.cuda.synchronize()
    out["force_max_abs_err"] = float((fk - fp).abs().max())
    out["force_rel_err"] = out["force_max_abs_err"] / float(fp.abs().max())
    out["energy_rel_err"] = float((ek - ep).abs().max() / ep.abs().max())
    _check(out["force_rel_err"] <= 1e-4, f"kernel forces rel err {out['force_rel_err']}")
    _check(out["energy_rel_err"] <= 1e-4, f"kernel energy rel err {out['energy_rel_err']}")
    out["forces_ms"] = _cuda_ms(lambda: chunk0.energy_and_forces(x), 50)
    out["forces_plain_ms"] = _cuda_ms(lambda: analytic.energy_and_forces(chunk0.dense, x), 50)

    for friction in (0.0, 1.0):
        chunk = build_fused_chunk(system, dt=DT_PS, friction=friction, n_replicas=R)
        xk, vk, ek = chunk(x, v, seeds, temps, 100, 0)
        xp, vp, ep = chunk.reference(x, v, seeds, temps, 100, 0)
        torch.cuda.synchronize()
        # the kernel's energies against the twin's at the kernel's own final
        # positions; the two trajectories' energies also differ by the
        # ~1e-6 nm their float rounding has grown to (reported, not gated:
        # max |dx| gates the trajectories)
        e_at_xk, _ = analytic.energy_and_forces(chunk.dense, xk)
        tag = f"friction{friction:g}"
        out[f"{tag}_max_dx_nm"] = float((xk - xp).abs().max())
        out[f"{tag}_energy_rel_err"] = float((ek - e_at_xk).abs().max() / e_at_xk.abs().max())
        out[f"{tag}_traj_energy_rel_diff"] = float((ek - ep).abs().max() / ep.abs().max())
        _check(bool(torch.isfinite(xk).all()), f"{tag}: kernel positions finite")
        _check(out[f"{tag}_max_dx_nm"] <= 1e-3, f"{tag}: max |dx| {out[f'{tag}_max_dx_nm']}")
        _check(out[f"{tag}_energy_rel_err"] <= 1e-4,
               f"{tag}: energy rel err {out[f'{tag}_energy_rel_err']}")
    out["chunk100_ms"] = _cuda_ms(lambda: chunk(x, v, seeds, temps, 100, 0), 20)
    out["chunk100_plain_ms"] = _cuda_ms(
        lambda: chunk.reference(x, v, seeds, temps, 100, 0), 3)
    _line("phase 2 kernel", out)
    return out


def phase_thermostat(system, x_min) -> dict:
    """Kinetic temperature over 10,000 kernel steps at 1/ps."""
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
    from pmarlo_tpu_torch.md.integrate import instantaneous_temperature

    rng = np.random.default_rng(1)
    R = N_REPLICAS
    temps = _ladder()
    chunk = build_fused_chunk(system, dt=DT_PS, friction=1.0, n_replicas=R)
    x = x_min[None].expand(R, -1, -1).contiguous()
    v = _mb_velocities(system, temps, rng)
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, R), dtype=torch.int32,
                            device="cuda")
    ratios = []
    for w in range(100):
        x, v, _ = chunk(x, v, seeds, temps, 100, 100 * w)
        if w >= 10:         # the first 1,000 steps equilibrate
            # the state velocities are the post-O half-step velocities,
            # which folded BAOAB keeps at the target temperature
            ratios.append(instantaneous_temperature(system, v) / temps)
    per_rung = torch.stack(ratios).mean(0)
    ratio = float(per_rung.mean())
    out = {
        "steps": 10_000,
        "kinetic_over_target": ratio,
        "per_rung_min": float(per_rung.min()),
        "per_rung_max": float(per_rung.max()),
    }
    _check(bool(torch.isfinite(x).all()), "thermostat positions finite")
    _check(0.97 <= ratio <= 1.03, f"kinetic/target temperature {ratio}")
    _line("phase 3 thermostat", out)
    return out


def _phi_psi_quads(system) -> torch.Tensor:
    ai = system.atom_index
    quads = [
        [ai(1, "C"), ai(2, "N"), ai(2, "CA"), ai(2, "C")],    # phi
        [ai(2, "N"), ai(2, "CA"), ai(2, "C"), ai(3, "N")],    # psi
    ]
    return torch.as_tensor(quads, dtype=torch.int64, device="cuda")


def _synthetic_msm_shards():
    """bench.py bench_msm: 35 shards, ~13k frames, two 4-D blobs."""
    rng = np.random.default_rng(0)
    shards = []
    per = 13_000 // 35
    for _ in range(35):
        X = np.concatenate([
            rng.normal(-1, 0.3, (per // 2, 4)),
            rng.normal(1, 0.3, (per - per // 2, 4)),
        ]).astype(np.float32)
        rng.shuffle(X)
        shards.append({"features": X, "metadata": {"stride": 1}})
    return shards


def _msm_build(shards):
    from pmarlo_tpu_torch.analysis.discretize import discretize_dataset
    from pmarlo_tpu_torch.msm.free_energy import generate_2d_fes

    result = discretize_dataset(shards, n_states=50, lag=10, seed=0)
    pooled = np.concatenate([s["features"] for s in shards])
    generate_2d_fes(pooled[:, 0], pooled[:, 1], temperature_K=300.0, bins=32)
    return result


def phase_main_path(system, positions) -> dict:
    from pmarlo_tpu_torch.analysis.discretize import discretize_dataset
    from pmarlo_tpu_torch.md.forces import dihedral_angles
    from pmarlo_tpu_torch.msm.free_energy import generate_2d_fes
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    cfg = RemdConfig(
        n_replicas=N_REPLICAS, t_min=300.0, t_max=450.0,
        exchange_frequency=EXCHANGE_FREQUENCY,
        report_interval=EXCHANGE_FREQUENCY, dt_ps=DT_PS, seed=0,
    )
    remd = ReplicaExchange(system, positions, cfg, device="cuda", use_kernel=True)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = remd.run(N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    n_launches = counts["fused_md_chunk"]
    out = {
        "launches": n_launches,
        "frames": list(res.positions.shape),
        "mean_acceptance": res.mean_acceptance,
        "remd_wall_s": wall,
    }
    _check(n_launches == N_STEPS // EXCHANGE_FREQUENCY,
           f"main path made {n_launches} kernel launches")
    _check(all(counts[k] == 0 for k in PAIR_KERNELS),
           f"alanine path launched pair kernels: {counts}")
    _check(bool(np.isfinite(res.positions).all()), "REMD frames finite")
    _check(bool(np.isfinite(res.potential_energy).all()), "REMD energies finite")
    _check(0.0 < res.mean_acceptance < 1.0, f"mean acceptance {res.mean_acceptance}")

    # phi/psi of the four coldest rungs -> shards -> MSM -> FES
    quads = _phi_psi_quads(system)
    frames = torch.as_tensor(res.positions[:, :4], device="cuda")  # (F, 4, N, 3)
    ang = dihedral_angles(frames, quads).cpu().numpy()             # (F, 4, 2)
    shards = []
    for rung in range(4):
        a = ang[:, rung]
        X = np.concatenate([np.cos(a), np.sin(a)], axis=1).astype(np.float32)
        shards.append({"features": X, "metadata": {"stride": 1}})
    msm = discretize_dataset(shards, n_states=16, lag=2, seed=0)
    T = msm.transition_matrix
    _check(np.allclose(T.sum(1), 1.0, atol=1e-8), "MSM rows sum to 1")
    _check(all(((d >= 0) & (d < msm.n_states)).all() for d in msm.dtrajs),
           "MSM labels in range")
    fes = generate_2d_fes(ang[:, :4, 0].ravel(), ang[:, :4, 1].ravel(),
                          temperature_K=300.0, bins=32,
                          periodic=(True, True))
    finite = np.isfinite(fes.free_energy)
    _check(bool(finite.any()), "FES has finite bins")
    out.update({
        "msm_states": int(msm.n_states),
        "msm_active": int(len(msm.active_states)),
        "msm_counted_pairs": int(msm.counted_pairs),
        "fes_occupied_bin_fraction": float(fes.finite_fraction),
    })
    # the process's first build of the synthetic set: the cold time
    shards = _synthetic_msm_shards()
    t0 = time.perf_counter()
    synth = _msm_build(shards)
    torch.cuda.synchronize()
    out["msm_build_cold_s"] = time.perf_counter() - t0
    _check(synth.counted_pairs > 0, "synthetic MSM counted pairs")
    out["synthetic_msm_counted_pairs"] = int(synth.counted_pairs)
    _line("phase 4 main path", out)
    return out


def phase_times(system, positions, main: dict) -> dict:
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    sim_ns = N_STEPS * DT_PS * 1e-3 * N_REPLICAS
    out = {
        "kernel_remd_wall_s": main["remd_wall_s"],
        "kernel_ns_per_day_aggregate": sim_ns * 86_400.0 / main["remd_wall_s"],
    }
    cfg = RemdConfig(
        n_replicas=N_REPLICAS, t_min=300.0, t_max=450.0,
        exchange_frequency=EXCHANGE_FREQUENCY,
        report_interval=EXCHANGE_FREQUENCY, dt_ps=DT_PS, seed=0,
    )
    plain = ReplicaExchange(system, positions, cfg, device="cuda", use_kernel=False)
    plain.run(EXCHANGE_FREQUENCY)       # warm-up window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.run(PLAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["plain_remd_steps"] = PLAIN_STEPS
    out["plain_remd_wall_s"] = wall
    out["plain_ns_per_day_aggregate"] = (
        PLAIN_STEPS * DT_PS * 1e-3 * N_REPLICAS * 86_400.0 / wall
    )
    shards = _synthetic_msm_shards()
    out["msm_build_cold_s"] = main["msm_build_cold_s"]
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        _msm_build(shards)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    out["msm_build_warm_s"] = float(np.median(warm))
    _line("phase 5 times", out)
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def phase_pair(system, x_min) -> dict:
    """The three pair kernels against their plain twins, R=8, N=3,726."""
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    rng = np.random.default_rng(6)
    R = PROTEIN_REPLICAS
    x = x_min[None] + torch.as_tensor(
        rng.normal(0.0, 0.005, (R, system.n_atoms, 3)), dtype=torch.float32,
        device="cuda",
    )
    fn = build_pair_force_fn(system)
    Ip = fn.born_reference(x)
    Ik = fn.born(x)
    B, dB = fn.born_radii(Ip)
    ep, dp = fn.energy_rows_reference(x, B)
    ek, dk = fn.energy_rows(x, B)
    _, c = fn.gb_terms(B, dB, dp)
    Fp = fn.pair_forces_reference(x, B, c)
    Fk = fn.pair_forces(x, B, c)
    Ek, Gk = fn(x)
    Ep, Gp = fn.reference(x)
    # how close each float32 path comes to a float64 evaluation
    E64, G64 = build_pair_force_fn(system, dtype=torch.float64).reference(x.double())
    torch.cuda.synchronize()
    out = {
        "atoms": system.n_atoms, "replicas": R, "band": fn.band_D,
        "born_max_abs_err": float((Ik - Ip).abs().max()),
        "born_rel_err": _rel(Ik, Ip),
        "e_rows_rel_err": _rel(ek, ep),
        "dEdB_max_abs_err": float((dk - dp).abs().max()),
        "dEdB_rel_err": _rel(dk, dp),
        "force_max_abs_err": float((Fk - Fp).abs().max()),
        "force_rel_err": _rel(Fk, Fp),
        "total_energy_rel_err": _rel(Ek, Ep),
        "total_force_rel_err": _rel(Gk, Gp),
        "energy_vs_float64": _rel(Ek.double(), E64),
        "plain_energy_vs_float64": _rel(Ep.double(), E64),
        "force_vs_float64": _rel(Gk.double(), G64),
    }
    for key in ("born_rel_err", "e_rows_rel_err", "dEdB_rel_err", "total_energy_rel_err"):
        _check(out[key] <= 1e-5, f"{key} {out[key]}")
    for key in ("force_rel_err", "total_force_rel_err"):
        _check(out[key] <= 1e-4, f"{key} {out[key]}")
    _check(bool(torch.isfinite(Gk).all()), "pair forces finite")
    out["born_ms"] = _cuda_ms(lambda: fn.born(x), 20)
    out["born_plain_ms"] = _cuda_ms(lambda: fn.born_reference(x), 3)
    out["energy_ms"] = _cuda_ms(lambda: fn.energy_rows(x, B), 20)
    out["energy_plain_ms"] = _cuda_ms(lambda: fn.energy_rows_reference(x, B), 3)
    out["force_ms"] = _cuda_ms(lambda: fn.pair_forces(x, B, c), 20)
    out["force_plain_ms"] = _cuda_ms(lambda: fn.pair_forces_reference(x, B, c), 3)
    out["eval_ms"] = _cuda_ms(lambda: fn(x), 20)
    out["eval_plain_ms"] = _cuda_ms(lambda: fn.reference(x), 3)
    _line("phase 6 pair", out)
    return out


def phase_protein_remd() -> dict:
    """Path 1 of the protein slice through ``run_replica_exchange``."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.md.constraints import build_h_constraints, constraint_violation
    from pmarlo_tpu_torch.remd.remd import RemdConfig, run_replica_exchange

    cfg = RemdConfig(
        n_replicas=PROTEIN_REPLICAS, t_min=300.0, t_max=330.0,
        exchange_frequency=100, report_interval=50, dt_ps=PROTEIN_DT_PS, seed=0,
    )
    structure = chignolin_assembly(PROTEIN_COPIES)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res, system = run_replica_exchange(
        structure, n_steps=PROTEIN_STEPS, config=cfg, device="cuda",
        use_kernel=True, constraints="hbonds", gb_model="gbn2",
    )
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _counts()
    # one launch of each pair kernel per force evaluation: 500 FIRE
    # iterations + the final energy, one per MD step, one per frame
    evals = 501 + PROTEIN_STEPS + PROTEIN_STEPS // cfg.report_interval
    spec = build_h_constraints(system)
    frames = torch.as_tensor(res.positions, device="cuda")
    deviation = float(constraint_violation(spec, frames))
    # kinetic/target over the frames after the first picosecond
    warm = int(round(1.0 / (cfg.report_interval * cfg.dt_ps)))
    ratio = res.kinetic_temperature[warm:] / res.temperatures[None, :]
    sim_ns = PROTEIN_STEPS * cfg.dt_ps * 1e-3 * PROTEIN_REPLICAS
    out = {
        "atoms": system.n_atoms,
        "replicas": PROTEIN_REPLICAS,
        "steps": PROTEIN_STEPS,
        "dt_ps": cfg.dt_ps,
        "constraints": spec.n_constraints,
        "launches": {k: counts[k] for k in PAIR_KERNELS},
        "force_evaluations": evals,
        "fused_launches": counts["fused_md_chunk"],
        "total_wall_s": total,
        "run_wall_s": res.wall_seconds,
        "ns_per_day_aggregate": sim_ns * 86_400.0 / res.wall_seconds,
        "mean_acceptance": res.mean_acceptance,
        "pair_acceptance": [float(a) for a in res.acceptance_matrix],
        "kinetic_over_target": float(ratio.mean()),
        "kinetic_over_target_per_rung": [float(r) for r in ratio.mean(0)],
        "max_constraint_deviation_nm": deviation,
        "frames": list(res.positions.shape),
        "frames_finite": bool(np.isfinite(res.positions).all()),
    }
    _check(all(counts[k] == evals for k in PAIR_KERNELS),
           f"pair launches {counts} for {evals} force evaluations")
    _check(counts["fused_md_chunk"] == 0, "the protein path launched the fused chunk")
    _check(out["frames_finite"], "protein REMD frames finite")
    _check(bool(np.isfinite(res.potential_energy).all()), "protein energies finite")
    _check(deviation <= 1e-4, f"constraint deviation {deviation} nm")
    _check(0.0 < res.mean_acceptance < 1.0, f"mean acceptance {res.mean_acceptance}")
    _check(0.95 <= out["kinetic_over_target"] <= 1.05,
           f"kinetic/target temperature {out['kinetic_over_target']}")
    _line("phase 7 protein remd", out)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch sees none")
    import pmarlo_tpu_torch  # noqa: F401  (pins float32 matmuls)
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    phase_build()
    system, positions = build_system(
        alanine_dipeptide_structure(), gb_model="gbn2", device="cuda"
    )
    x_min, _ = minimize_energy(system, positions)
    kern = phase_kernel_vs_plain(system, x_min)
    phase_thermostat(system, x_min)
    main_path = phase_main_path(system, positions)
    phase_times(system, positions, main_path)

    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    protein, ppos = build_system(
        chignolin_assembly(PROTEIN_COPIES), gb_model="gbn2", device="cuda",
        dense_scales=False,
    )
    px_min, _ = minimize_energy(protein, ppos, force_fn=build_pair_force_fn(protein))
    pair = phase_pair(protein, px_min)
    remd = phase_protein_remd()

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    kernels = [{
        "name": "fused_md_chunk",
        "route": "cuda",
        "source": "pmarlo_tpu_torch/csrc/fused_md.cu",
        "replaces": "pmarlo_tpu/md/pallas_md.py:791",
        "launches": main_path["launches"],
        "max_abs_err": kern["force_max_abs_err"],
        "ms": kern["chunk100_ms"],
        "plain_ms": kern["chunk100_plain_ms"],
    }]
    for name, line, err, tag in (
        ("pair_born", 465, "born_max_abs_err", "born"),
        ("pair_energy", 486, "dEdB_max_abs_err", "energy"),
        ("pair_force", 513, "force_max_abs_err", "force"),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pmarlo_tpu_torch/csrc/pair_force.cu",
            "replaces": f"pmarlo_tpu/md/pallas_pair.py:{line}",
            "launches": remd["launches"][name],
            "max_abs_err": pair[err],
            "ms": pair[f"{tag}_ms"],
            "plain_ms": pair[f"{tag}_plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
