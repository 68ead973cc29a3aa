"""Representative frame selection with global->(traj, frame) mapping.

Reference: src/pmarlo/conformations/representative_picker.py —
TrajectorySegment (:16), TrajectoryFrameLocator (:38), FrameIndexLookup
(:53), RepresentativePicker (:112) with modes closest_to_centroid / medoid
/ diverse.

Host copy of ``pmarlo_tpu/conformations/representative_picker.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrajectorySegment:
    """(reference :16)."""

    traj_index: int
    start: int      # global frame of this segment's first frame
    length: int


@dataclasses.dataclass
class FrameIndexLookup:
    """Global frame index -> (trajectory, local frame) (reference :53)."""

    segments: List[TrajectorySegment]

    @classmethod
    def from_lengths(cls, lengths: Sequence[int]) -> "FrameIndexLookup":
        segments, offset = [], 0
        for i, n in enumerate(lengths):
            segments.append(TrajectorySegment(i, offset, int(n)))
            offset += int(n)
        return cls(segments)

    @property
    def total_frames(self) -> int:
        return sum(s.length for s in self.segments)

    def locate(self, global_frame: int) -> Tuple[int, int]:
        if global_frame < 0:
            raise IndexError(global_frame)
        for seg in self.segments:
            if seg.start <= global_frame < seg.start + seg.length:
                return seg.traj_index, global_frame - seg.start
        raise IndexError(
            f"global frame {global_frame} out of range ({self.total_frames})"
        )


@dataclasses.dataclass
class RepresentativePicker:
    """Pick representative frames per state (reference :112).

    Modes: ``closest_to_centroid`` (min distance to the state's feature
    mean), ``medoid`` (min summed pairwise distance, subsampled), and
    ``diverse`` (greedy max-min farthest-point set).
    """

    mode: str = "closest_to_centroid"
    max_medoid_samples: int = 512

    def __post_init__(self):
        if self.mode not in ("closest_to_centroid", "medoid", "diverse"):
            raise ValueError(f"unknown mode {self.mode!r}")

    def pick(
        self,
        features: np.ndarray,          # (T_total, K) pooled
        dtraj: np.ndarray,             # (T_total,) pooled labels
        states: Sequence[int],
        lookup: FrameIndexLookup,
        n_per_state: int = 1,
        seed: int = 0,
    ) -> Dict[int, List[Dict]]:
        """{state: [{"traj": i, "frame": j, "global_frame": g}, ...]}"""
        features = np.asarray(features)
        dtraj = np.asarray(dtraj)
        rng = np.random.default_rng(seed)
        out: Dict[int, List[Dict]] = {}
        for s in states:
            idx = np.where(dtraj == s)[0]
            if idx.size == 0:
                out[int(s)] = []
                continue
            X = features[idx]
            if self.mode == "closest_to_centroid":
                center = X.mean(axis=0)
                order = np.argsort(np.linalg.norm(X - center, axis=1))
                chosen = idx[order[:n_per_state]]
            elif self.mode == "medoid":
                sub = idx
                if idx.size > self.max_medoid_samples:
                    sub = rng.choice(idx, self.max_medoid_samples, replace=False)
                Xs = features[sub]
                d = np.linalg.norm(Xs[:, None] - Xs[None, :], axis=-1)
                order = np.argsort(d.sum(axis=1))
                chosen = sub[order[:n_per_state]]
            else:  # diverse: greedy farthest-point
                chosen_list = [idx[int(rng.integers(idx.size))]]
                while len(chosen_list) < min(n_per_state, idx.size):
                    d = np.min(
                        np.linalg.norm(
                            features[idx][:, None]
                            - features[np.asarray(chosen_list)][None, :],
                            axis=-1,
                        ),
                        axis=1,
                    )
                    chosen_list.append(idx[int(np.argmax(d))])
                chosen = np.asarray(chosen_list)
            picks = []
            for g in chosen:
                traj_i, local = lookup.locate(int(g))
                picks.append({"traj": traj_i, "frame": local, "global_frame": int(g)})
            out[int(s)] = picks
        return out


__all__ = ["TrajectorySegment", "FrameIndexLookup", "RepresentativePicker"]
