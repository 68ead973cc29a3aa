"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of numbers each:

1. build   - compile ``pmarlo_tpu_torch/csrc`` with nvcc (sm_90a).
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


def _mb_velocities(system, temps: torch.Tensor, rng) -> torch.Tensor:
    """Maxwell-Boltzmann velocities (R, N, 3) from a numpy generator."""
    from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL

    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * temps.cpu().numpy()
    m = system.masses.cpu().numpy()
    z = rng.standard_normal((len(kT), system.n_atoms, 3))
    v = np.sqrt(kT[:, None, None] / m[None, :, None]) * z
    return torch.as_tensor(v, dtype=torch.float32, device="cuda")


def phase_build() -> dict:
    from pmarlo_tpu_torch.md import fused_md

    t0 = time.perf_counter()
    path = fused_md.build_library()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in fused_md.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
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
    from pmarlo_tpu_torch.md import fused_md
    from pmarlo_tpu_torch.md.forces import dihedral_angles
    from pmarlo_tpu_torch.msm.free_energy import generate_2d_fes
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    cfg = RemdConfig(
        n_replicas=N_REPLICAS, t_min=300.0, t_max=450.0,
        exchange_frequency=EXCHANGE_FREQUENCY,
        report_interval=EXCHANGE_FREQUENCY, dt_ps=DT_PS, seed=0,
    )
    fused_md.launches = 0
    remd = ReplicaExchange(system, positions, cfg, device="cuda", use_kernel=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = remd.run(N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launches = fused_md.launches
    out = {
        "launches": n_launches,
        "frames": list(res.positions.shape),
        "mean_acceptance": res.mean_acceptance,
        "remd_wall_s": wall,
    }
    _check(n_launches == N_STEPS // EXCHANGE_FREQUENCY,
           f"main path made {n_launches} kernel launches")
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

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_md_chunk",
        "route": "cuda",
        "source": "pmarlo_tpu_torch/csrc/fused_md.cu",
        "replaces": "pmarlo_tpu/md/pallas_md.py:791",
        "launches": main_path["launches"],
        "max_abs_err": kern["force_max_abs_err"],
        "ms": kern["chunk100_ms"],
        "plain_ms": kern["chunk100_plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
