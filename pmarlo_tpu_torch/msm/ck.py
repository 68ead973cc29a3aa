"""Chapman-Kolmogorov validation: T(tau)^k vs T(k*tau).

Reference: src/pmarlo/markov_state_model/_ck.py:61-110 (micro over top-N
connected states + macro over PCCA-lumped trajectories), ck_runner.py:293
(CKRunResult.max_error = worst RMS), validation/ck_rule.py:15-117
(ESS-adjusted guardrail decision).

Host copy of ``pmarlo_tpu/msm/ck.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.errors import EstimationError
from .estimation import build_msm


@dataclasses.dataclass
class CKResult:
    """(reference results.py CKResult / ck_runner.py:32 CKRunResult)."""

    lag: int
    factors: List[int]
    predicted: Dict[int, np.ndarray]    # k -> T(tau)^k (restricted)
    estimated: Dict[int, np.ndarray]    # k -> T(k tau)
    mse: Dict[int, float]
    rms: Dict[int, float]
    states: np.ndarray
    insufficient_data: bool = False

    @property
    def max_error(self) -> float:
        return max(self.rms.values()) if self.rms else float("nan")

    def to_dict(self) -> Dict:
        return {
            "lag": self.lag,
            "factors": self.factors,
            "mse": {int(k): float(v) for k, v in self.mse.items()},
            "rms": {int(k): float(v) for k, v in self.rms.items()},
            "max_error": float(self.max_error),
            "insufficient_data": self.insufficient_data,
        }


def ck_test(
    dtrajs: "np.ndarray | Sequence[np.ndarray]",
    lag: int,
    factors: Sequence[int] = (2, 3, 4),
    *,
    n_states: Optional[int] = None,
    top_n_states: Optional[int] = None,
    min_transitions: int = 5,
    reversible: bool = True,
) -> CKResult:
    """Micro-level CK test on the top-populated connected states
    (reference _ck.py:61 compute_ck_test_micro)."""
    if isinstance(dtrajs, np.ndarray) and dtrajs.ndim == 1:
        dtrajs = [dtrajs]
    dtrajs = [np.asarray(d, dtype=np.int64) for d in dtrajs]
    base = build_msm(dtrajs, lag, n_states, reversible=reversible)
    n_states = base.n_states

    # restrict to well-sampled active states
    counts_per_state = base.counts.sum(axis=1)
    active = base.active_states
    active = np.asarray(
        [s for s in active if counts_per_state[s] >= min_transitions], dtype=np.int64
    )
    if top_n_states is not None and len(active) > top_n_states:
        order = np.argsort(-base.stationary_distribution[active])
        active = np.sort(active[order[:top_n_states]])
    if len(active) < 2:
        return CKResult(
            lag=lag, factors=list(factors), predicted={}, estimated={},
            mse={}, rms={}, states=active, insufficient_data=True,
        )

    T_base = base.transition_matrix[np.ix_(active, active)]
    # re-normalize after restriction
    T_base = T_base / np.maximum(T_base.sum(axis=1, keepdims=True), 1e-300)

    predicted, estimated, mse, rms = {}, {}, {}, {}
    insufficient = False
    max_len = max(d.shape[0] for d in dtrajs)
    for k in factors:
        long_lag = lag * int(k)
        if long_lag >= max_len:
            insufficient = True
            continue
        try:
            long_msm = build_msm(dtrajs, long_lag, n_states, reversible=reversible)
        except EstimationError:
            insufficient = True
            continue
        T_long = long_msm.transition_matrix[np.ix_(active, active)]
        T_long = T_long / np.maximum(T_long.sum(axis=1, keepdims=True), 1e-300)
        T_pred = np.linalg.matrix_power(T_base, int(k))
        predicted[int(k)] = T_pred
        estimated[int(k)] = T_long
        err2 = (T_pred - T_long) ** 2
        mse[int(k)] = float(err2.mean())
        rms[int(k)] = float(np.sqrt(err2.mean()))
    return CKResult(
        lag=lag, factors=[int(k) for k in factors], predicted=predicted,
        estimated=estimated, mse=mse, rms=rms, states=active,
        insufficient_data=insufficient or not mse,
    )


def ck_test_macrostates(
    dtrajs: "np.ndarray | Sequence[np.ndarray]",
    lag: int,
    macro_assignments: np.ndarray,
    factors: Sequence[int] = (2, 3, 4),
) -> CKResult:
    """CK at macrostate level: lump micro dtrajs through a PCCA assignment
    then run the micro test on the lumped labels
    (reference _ck.py:110 compute_ck_test_macrostates)."""
    macro_assignments = np.asarray(macro_assignments, dtype=np.int64)
    if isinstance(dtrajs, np.ndarray) and dtrajs.ndim == 1:
        dtrajs = [dtrajs]
    lumped = []
    for d in dtrajs:
        d = np.asarray(d, dtype=np.int64)
        valid = (d >= 0) & (d < len(macro_assignments))
        out = np.where(valid, macro_assignments[np.clip(d, 0, None)], -1)
        lumped.append(out)
    n_macro = int(macro_assignments.max()) + 1
    return ck_test(lumped, lag, factors, n_states=n_macro)


# --- guardrail decision (reference validation/ck_rule.py) ---------------------

@dataclasses.dataclass(frozen=True)
class CKConfig:
    """(reference ck_rule.py:15)."""

    threshold: float = 0.1
    mode: str = "absolute"          # absolute | ess_adjusted
    sigma_multiplier: float = 3.0
    threshold_cap: float = 0.25
    pass_fraction: float = 0.75

    def __post_init__(self):
        if self.mode not in ("absolute", "ess_adjusted"):
            raise ValueError(f"mode must be absolute|ess_adjusted, got {self.mode!r}")
        if not (0 < self.pass_fraction <= 1):
            raise ValueError("pass_fraction must be in (0, 1]")


def ck_error(predicted: np.ndarray, estimated: np.ndarray) -> float:
    """RMS CK error (reference ck_rule.py:36)."""
    return float(np.sqrt(((np.asarray(predicted) - np.asarray(estimated)) ** 2).mean()))


def decide_ck(
    result: CKResult,
    config: CKConfig = CKConfig(),
    ess_per_factor: Optional[Dict[int, float]] = None,
) -> Dict:
    """Pass/fail decision over CK factors (reference ck_rule.py:69-117).

    absolute: rms <= threshold. ess_adjusted: threshold becomes
    min(multinomial RMS standard error * sigma_multiplier, cap).
    """
    if result.insufficient_data and not result.rms:
        return {"passed": False, "reason": "insufficient_data", "per_factor": {}}
    per_factor = {}
    for k, rms in result.rms.items():
        thr = config.threshold
        if config.mode == "ess_adjusted":
            ess = (ess_per_factor or {}).get(k, None)
            if ess is not None and ess > 0:
                n_elem = result.predicted[k].size
                se = np.sqrt(0.25 / ess)  # worst-case multinomial RMS SE
                thr = min(se * config.sigma_multiplier, config.threshold_cap)
        per_factor[int(k)] = {"rms": float(rms), "threshold": float(thr),
                              "passed": bool(rms <= thr)}
    n_pass = sum(1 for v in per_factor.values() if v["passed"])
    passed = bool(per_factor) and n_pass / len(per_factor) >= config.pass_fraction
    return {"passed": passed, "per_factor": per_factor,
            "pass_fraction": n_pass / max(len(per_factor), 1)}


def run_ck(
    dtrajs,
    lag: int,
    output_dir,
    factors: Sequence[int] = (2, 3, 4),
    n_states: Optional[int] = None,
    config: CKConfig = CKConfig(),
) -> CKResult:
    """Standalone CK run with plot + CSV + JSON artifacts
    (reference ck_runner.py:293 run_ck)."""
    import csv
    from pathlib import Path

    from ..utils.json_io import write_json

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    result = ck_test(dtrajs, lag, factors, n_states=n_states)
    decision = decide_ck(result, config)
    write_json(output_dir / "ck.json", {**result.to_dict(), "decision": decision})
    with (output_dir / "ck.csv").open("w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["factor", "mse", "rms"])
        for k in sorted(result.mse):
            writer.writerow([k, result.mse[k], result.rms[k]])
    if result.predicted:
        from ..visualization.plots import plot_ck

        plot_ck(result, output_dir / "ck.png")
    return result


__all__ = ["CKResult", "ck_test", "ck_test_macrostates", "CKConfig",
           "ck_error", "decide_ck", "run_ck"]
