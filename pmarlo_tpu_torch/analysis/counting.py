"""Expected lagged-pair accounting (reference: src/pmarlo/analysis/counting.py:10).

Host copy of ``pmarlo_tpu/analysis/counting.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, Sequence

from ..features.pairs import expected_pairs  # canonical implementation


def expected_pairs_by_split(
    segment_lengths: Dict[str, Sequence[int]], lag: int
) -> Dict[str, int]:
    """Per-split expected (t, t+lag) pair counts with stride-1 segments."""
    return {
        split: expected_pairs(lengths, lag)
        for split, lengths in segment_lengths.items()
    }


__all__ = ["expected_pairs", "expected_pairs_by_split"]
