"""End-to-end TPT conformation discovery.

Reference: src/pmarlo/conformations/finder.py:222 find_conformations —
validate T/pi -> PCCA+ memberships with exhaustive input validation
(:45-219) -> state auto-detection -> TPT -> KIS -> metastable/transition
classification (committor tolerance around 0.5, :387-416) -> representative
picking -> optional PDB export -> ConformationSet.

Host copy of ``pmarlo_tpu/conformations/finder.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..msm.pcca import pcca_assignments
from ..msm.tpt import reactive_flux
from ..utils.errors import EstimationError
from ..utils.msm_utils import check_transition_matrix, stationary_distribution
from .kinetic_importance import KineticImportanceScore
from .representative_picker import FrameIndexLookup, RepresentativePicker
from .results import Conformation, ConformationSet
from .state_detection import StateDetector
from .uncertainty import UncertaintyQuantifier

logger = logging.getLogger("pmarlo_tpu")


def _validate_inputs(T: np.ndarray, pi: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Exhaustive input validation (reference finder.py:45-219)."""
    T = np.asarray(T, dtype=np.float64)
    check_transition_matrix(T, tol=1e-6)
    if pi is None:
        pi = stationary_distribution(T)
    else:
        pi = np.asarray(pi, dtype=np.float64)
        if pi.shape != (T.shape[0],):
            raise EstimationError(f"pi shape {pi.shape} != ({T.shape[0]},)")
        if np.any(pi < -1e-12):
            raise EstimationError("pi has negative entries")
        total = pi.sum()
        if not np.isclose(total, 1.0, atol=1e-6):
            raise EstimationError(f"pi sums to {total:.6f}, expected 1")
        pi = np.maximum(pi, 0.0)
        pi = pi / pi.sum()
    return T, pi


def find_conformations(
    transition_matrix: np.ndarray,
    stationary_dist: Optional[np.ndarray] = None,
    *,
    source: Optional[Sequence[int]] = None,
    sink: Optional[Sequence[int]] = None,
    n_macrostates: int = 2,
    committor_tolerance: float = 0.1,
    n_pathways: int = 10,
    # representative picking (all optional)
    features: Optional[np.ndarray] = None,
    dtraj: Optional[np.ndarray] = None,
    traj_lengths: Optional[Sequence[int]] = None,
    trajectories: Optional[Sequence[np.ndarray]] = None,
    topology=None,
    output_dir: Optional["str | Path"] = None,
    # uncertainty (optional; needs dtrajs)
    bootstrap: bool = False,
    dtrajs_for_bootstrap: Optional[Sequence[np.ndarray]] = None,
    lag_for_bootstrap: int = 10,
    picker_mode: str = "closest_to_centroid",
    # endpoint auto-detection cascade inputs (reference state_detection.py:81)
    fes=None,
    its: Optional[np.ndarray] = None,
    cvs: Optional[np.ndarray] = None,
    refine_endpoints: bool = False,
) -> ConformationSet:
    """Discover metastable and transition-state conformations via TPT
    (reference finder.py:222). ``fes``/``its``/``cvs`` feed the
    FES-minima -> timescale-gap -> population detection cascade when
    endpoints are not given; ``refine_endpoints`` widens the detected
    sets by committor thresholds."""
    T, pi = _validate_inputs(transition_matrix, stationary_dist)
    n = T.shape[0]

    # macrostate memberships (canonical population order)
    macro_labels, memberships = pcca_assignments(T, min(n_macrostates, n), pi)

    # endpoint detection
    if source is None or sink is None:
        detector = StateDetector()
        auto_src, auto_snk = detector.auto_detect(
            T, pi, fes=fes, its=its,
            dtrajs=dtrajs_for_bootstrap, cvs=cvs,
        )
        if refine_endpoints:
            auto_src, auto_snk = detector.refine_with_committors(
                T, auto_src, auto_snk
            )
        source = source if source is not None else auto_src
        sink = sink if sink is not None else auto_snk
    source = np.asarray(sorted(set(int(s) for s in source)))
    sink = np.asarray(sorted(set(int(s) for s in sink)))

    tpt = reactive_flux(T, source, sink, pi=pi, n_pathways=n_pathways)
    if tpt.pathway_convergence_warning:
        logger.warning(tpt.pathway_convergence_warning)

    kis = KineticImportanceScore().compute(T, pi)

    # classification (reference finder.py:387-416): transition states sit
    # near q+ = 0.5; metastable states are committed + populated
    q = tpt.forward_committor
    conformations: List[Conformation] = []
    for s in range(n):
        near_half = abs(q[s] - 0.5) <= committor_tolerance
        committed = q[s] <= committor_tolerance or q[s] >= 1 - committor_tolerance
        if near_half:
            kind = "transition"
        elif committed:
            kind = "metastable"
        else:
            continue
        conformations.append(Conformation(
            state=int(s),
            kind=kind,
            macrostate=int(macro_labels[s]),
            committor=float(q[s]),
            population=float(pi[s]),
            kis_score=float(kis.scores[s]),
        ))
    # order by kinetic importance
    conformations.sort(key=lambda c: -c.kis_score)

    # representative picking
    if features is not None and dtraj is not None and traj_lengths is not None:
        lookup = FrameIndexLookup.from_lengths(traj_lengths)
        picker = RepresentativePicker(mode=picker_mode)
        picks = picker.pick(
            features, dtraj, [c.state for c in conformations], lookup
        )
        enriched = []
        for c in conformations:
            rep = picks.get(c.state, [])
            rep0 = rep[0] if rep else None
            pdb_path = None
            if rep0 is not None and trajectories is not None and topology is not None \
               and output_dir is not None:
                from ..io.pdb import write_pdb

                coords = np.asarray(trajectories[rep0["traj"]])[rep0["frame"]]
                p = Path(output_dir) / f"conformation_{c.kind}_{c.state:04d}.pdb"
                write_pdb(
                    p, coords, topology.atom_names,
                    topology.residue_names, topology.residue_ids,
                )
                pdb_path = str(p)
            enriched.append(Conformation(
                state=c.state, kind=c.kind, macrostate=c.macrostate,
                committor=c.committor, population=c.population,
                kis_score=c.kis_score, representative=rep0, pdb_path=pdb_path,
            ))
        conformations = enriched

    uncertainty = None
    if bootstrap:
        if dtrajs_for_bootstrap is None:
            raise EstimationError("bootstrap=True requires dtrajs_for_bootstrap")
        uncertainty = UncertaintyQuantifier().bootstrap_tpt(
            dtrajs_for_bootstrap, lag_for_bootstrap, n,
            source.tolist(), sink.tolist(),
        )

    return ConformationSet(
        conformations=tuple(conformations),
        tpt=tpt,
        kis=kis,
        macrostate_assignments=macro_labels,
        uncertainty=uncertainty,
    )


__all__ = ["find_conformations"]
