"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, the plain
reference (``portbench/reference``, float64) judges what the timed path
returned:

- ``swap_mismatches``: every exchange attempt of every segment of the
  window. From each window's last frame energies (the program's), the
  ladder and the Philox uniforms of the attempt, the reference decides each
  attempted pair; the program's replica ids must move by exactly those
  swaps. A decision within ``SWAP_MARGIN`` of its threshold may go either
  way (float32 against float64 rounding); the limit is 0.
- ``frame_energy_gap_kj``: every frame of a sample of segments drawn from
  the seed: the program's frame energy against the reference's energy at
  the frame's positions (the implicit solvent, LJ, Coulomb, bonded terms, the
  CV bias where the cell has it).
- ``replay_dx_nm``: the same sample: the reference integrates the first
  ``REPLAY_WINDOWS`` exchange windows of each segment from the program's
  state at the segment's start (positions, velocities, Philox seeds), on the
  same noise stream, and moves the configurations as the program's ids say
  (the swaps themselves are judged above); its frames against the
  program's. The later windows cannot be followed: MD is chaotic, so two
  correct float32 and float64 runs part after some hundreds of steps. The
  stage it skips is judged by the two numbers above.
- ``start_energy_rise_kj``: the start by itself: the reference's energy at
  the program's minimized structure less that at the frozen input.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .reference.md import (DeepTICABias, Reference, baoab_window, ladder, swap_decisions,
                           swap_uniforms)

SWAP_MARGIN = 1e-4
REPLAY_WINDOWS = 2
SAMPLE_SEGMENTS = 3


def reference_for(session, dtype=torch.float64, device="cpu") -> Reference:
    bias = None
    if session.bias is not None:
        b = session.bias
        bias = DeepTICABias(b["weights"], b["quads"], b["strength"], dtype, device)
    return Reference(session.inputs, dtype=dtype, device=device, bias=bias)


def sample(n_segments: int, seed: int) -> List[int]:
    rng = np.random.default_rng(int(seed))
    k = min(SAMPLE_SEGMENTS, n_segments)
    return sorted(int(i) for i in rng.choice(n_segments, size=k, replace=False))


def failed(result, R: int) -> bool:
    """Frames or energies not finite, or an ids row not a permutation."""
    ids = np.asarray(result.replica_ids)
    perm = (np.sort(ids, axis=1) == np.arange(R)[None, :]).all()
    return not (np.isfinite(result.positions).all() and np.isfinite(result.potential_energy).all()
                and perm)


def swap_mismatches(session, start: dict, result) -> int:
    R = session.R
    temps = ladder(session.t_min, session.t_max, R)
    fpc = session.exchange // session.report
    ids = np.asarray(result.replica_ids)
    A = ids.shape[0] - 1
    E = np.asarray(result.potential_energy, np.float64)[fpc - 1::fpc][:A]   # (A, R)
    u = swap_uniforms(session.seed, start["attempt"] + np.arange(A), R)
    bad = 0
    for parity in (0, 1):
        a = np.arange(parity, A, 2)
        if not len(a):
            continue
        left, acc_ref, margin = swap_decisions(E[a], temps, u[a], parity)
        prev, nxt = ids[a], ids[a + 1]
        acc_prog = (nxt[:, left] == prev[:, left + 1]) & (nxt[:, left + 1] == prev[:, left])
        bad += int(((acc_prog != acc_ref) & (margin > SWAP_MARGIN)).sum())
        # every rung not in an accepted pair keeps its identity
        expect = prev.copy()
        expect[:, left] = np.where(acc_prog, prev[:, left + 1], prev[:, left])
        expect[:, left + 1] = np.where(acc_prog, prev[:, left], prev[:, left + 1])
        bad += int((expect != nxt).any(axis=1).sum())
    return bad


def replay_dx(session, ref: Reference, start: dict, result) -> float:
    R, dev = session.R, ref.device
    temps = ladder(session.t_min, session.t_max, R)
    fpc = session.exchange // session.report
    x = torch.as_tensor(start["positions"], device=dev)
    v = torch.as_tensor(start["velocities"], device=dev)
    seeds = torch.as_tensor(start["seeds"], device=dev)
    ids = np.asarray(result.replica_ids)
    step, worst = int(start["step"]), 0.0
    for w in range(REPLAY_WINDOWS):
        for k in range(fpc):
            x, v = baoab_window(ref, x, v, seeds, temps, step, session.report,
                                session.dt, session.friction)
            step += session.report
            got = torch.as_tensor(result.positions[w * fpc + k], device=dev, dtype=x.dtype)
            worst = float(np.max([worst, float((x - got).abs().max())]))
        # the configuration each rung takes: where its next identity sat
        src = np.argsort(ids[w])[ids[w + 1]]
        t = torch.as_tensor(src, device=dev)
        scale = torch.as_tensor(np.sqrt(temps / temps[src]), device=dev, dtype=v.dtype)
        x, v, seeds = x[t], v[t] * scale[:, None, None], seeds[t]
    return worst


def judge(session, starts: List[dict], results: list, limits: Dict[str, float],
          device="cpu", ref: Optional[Reference] = None) -> Dict[str, Dict[str, float]]:
    """Every number compared, with its limit. ``starts[i]`` is the program's
    state before segment ``i`` (host arrays), ``results[i]`` what it
    returned."""
    ref = ref or reference_for(session, device=device)
    picked = sample(len(results), session.seed)
    n = {"swap_mismatches": float(sum(swap_mismatches(session, s, r)
                                      for s, r in zip(starts, results)))}
    # np.max, not max(): a gap that is not a number stays one
    n["frame_energy_gap_kj"] = float(np.max([
        np.max(np.abs(ref.energies(np.asarray(results[i].positions))
                      - results[i].potential_energy)) for i in picked]))
    n["replay_dx_nm"] = float(np.max([replay_dx(session, ref, starts[i], results[i])
                                      for i in picked]))
    e0 = ref.energies(np.stack([session.inputs["positions"], session.start["positions"][0]]))
    n["start_energy_rise_kj"] = float(e0[1] - e0[0])
    # a number that is not finite (a frame or an energy that is not) fails
    return {k: {"value": v if np.isfinite(v) else float("inf"), "limit": float(limits[k])}
            for k, v in n.items()}


def passes(numbers: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(d["value"]) and d["value"] <= d["limit"] for d in numbers.values())
