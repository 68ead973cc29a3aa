"""Staged pipeline orchestration with timing banners and resume.

Rebuild of the removed ``pmarlo.transform.pipeline`` subsystem from its
documented contract (reference CHANGELOG.md:757: staged pipeline with
timing banners; :758 per-stage timing with throughput and peak-memory
summaries; :257-258 RunStatus enums for incomplete/failed runs).

Host copy of ``pmarlo_tpu/workflow/__init__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from .pipeline import Pipeline, RunStatus, Stage, StageResult

__all__ = ["Pipeline", "RunStatus", "Stage", "StageResult"]
