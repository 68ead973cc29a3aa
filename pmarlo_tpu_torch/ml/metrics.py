"""Training-metrics normalization + DeepTICA config-section helpers.

Reference roles: src/pmarlo/features/deeptica/metrics.py:10
(normalize_training_metrics — infer best score/epoch/tau when the raw
history lacks them) and src/pmarlo/features/deeptica/config.py:12,35
(resolve_deeptica / sanitize_deeptica_payload — parse a transform config
section and trim a training-result payload to its stable summary
fields). The TPU trainer (ml/deeptica.py) already records ``best``
explicitly; this normalizer exists for histories produced elsewhere
(deserialized bundles, external pipelines) and for name-level API
parity.

Host copy of ``pmarlo_tpu/ml/metrics.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence


def _finite(v: Any) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def normalize_training_metrics(
    metrics: "Mapping[str, Any] | None",
    *,
    tau_schedule: Optional[Sequence[Any]] = None,
    epochs_per_tau: "int | float | None" = None,
) -> Dict[str, Any]:
    """Return a copy of ``metrics`` with ``best_val_score`` /
    ``best_epoch`` / ``best_tau`` filled in when inferable.

    Two history shapes are understood: the TPU trainer's
    ``{"epochs": [{"val_vamp2", "epoch", "tau"}, ...], "best": {...}}``
    and the reference's flat ``{"val_score_curve": [...]}`` (where
    ``tau_schedule`` + ``epochs_per_tau`` locate the tau stage).
    Non-mapping input returns ``{}``.
    """
    if not isinstance(metrics, Mapping):
        return {}
    out: Dict[str, Any] = dict(metrics)

    best = out.get("best")
    if isinstance(best, Mapping):
        out.setdefault("best_val_score", _finite(best.get("val_vamp2")))
        out.setdefault("best_epoch", best.get("epoch"))
        out.setdefault("best_tau", best.get("tau"))
        return out

    records = out.get("epochs")
    if isinstance(records, Sequence) and records and isinstance(
        records[0], Mapping
    ):
        scored = [
            (i, _finite(r.get("val_vamp2")))
            for i, r in enumerate(records)
        ]
        scored = [(i, s) for i, s in scored if s is not None]
        if scored:
            i_best, s_best = max(scored, key=lambda t: t[1])
            out.setdefault("best_val_score", s_best)
            out.setdefault("best_epoch", records[i_best].get("epoch", i_best))
            out.setdefault("best_tau", records[i_best].get("tau"))
        return out

    curve = out.get("val_score_curve")
    if isinstance(curve, Sequence):
        scored = [(i, _finite(v)) for i, v in enumerate(curve)]
        scored = [(i, s) for i, s in scored if s is not None]
        if scored:
            i_best, s_best = max(scored, key=lambda t: t[1])
            out.setdefault("best_val_score", s_best)
            out.setdefault("best_epoch", i_best)
            if (
                "best_tau" not in out
                and tau_schedule
                and epochs_per_tau
                and float(epochs_per_tau) > 0
            ):
                stage = min(
                    int(i_best // float(epochs_per_tau)),
                    len(tau_schedule) - 1,
                )
                out["best_tau"] = tau_schedule[stage]
    return out


def resolve_deeptica(
    transform_cfg: Mapping[str, Any],
) -> "tuple[bool, Dict[str, Any] | None]":
    """Parse the ``deeptica`` section of a transform config:
    ``(enabled, options-or-None)``. Missing/non-mapping section means
    disabled. ``enabled`` defaults True; ``min_pairs`` is coerced to int
    (dropped if uncoercible) and ``skip_on_failure`` to bool."""
    section = transform_cfg.get("deeptica")
    if not isinstance(section, Mapping):
        return False, None
    cfg = dict(section)
    enabled = bool(cfg.pop("enabled", True))
    if "skip_on_failure" in cfg:
        cfg["skip_on_failure"] = bool(cfg["skip_on_failure"])
    if "min_pairs" in cfg:
        try:
            cfg["min_pairs"] = int(cfg["min_pairs"])
        except (TypeError, ValueError):
            cfg.pop("min_pairs")
    return enabled, (cfg or None)


#: stable summary fields kept by sanitize_deeptica_payload
_PAYLOAD_FIELDS = (
    "applied", "skipped", "reason", "method", "lag", "lag_used", "n_out",
    "pairs_total", "warnings", "lag_candidates",
)


def sanitize_deeptica_payload(raw: Mapping[str, Any]) -> Dict[str, Any]:
    """Trim a DeepTICA training-result payload to its stable summary
    fields (plus at most 5 trimmed ``attempts`` entries) for JSON
    artifact export."""
    summary: Dict[str, Any] = {
        k: raw[k] for k in _PAYLOAD_FIELDS if k in raw
    }
    attempts = raw.get("attempts")
    if isinstance(attempts, Sequence):
        summary["attempts"] = [
            {
                "lag": a.get("lag"),
                "pairs_total": a.get("pairs_total"),
                "status": a.get("status"),
            }
            for a in list(attempts)[:5]
            if isinstance(a, Mapping)
        ]
    return summary


__all__ = [
    "normalize_training_metrics",
    "resolve_deeptica",
    "sanitize_deeptica_payload",
]
