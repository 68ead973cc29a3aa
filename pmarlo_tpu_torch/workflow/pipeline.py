"""Staged pipeline: named stages over a shared context with timing,
tracemalloc peak-memory accounting, fail-fast status, and JSON checkpoints.

Reconstructed from the reference's CHANGELOG contract (CHANGELOG.md:757-758
— stage timing banners, throughput + tracemalloc peak-memory summaries;
:257-258 RunStatus). The checkpoint file makes a pipeline resumable: a
completed stage's recorded context updates are REPLAYED on re-run (skipping
the stage without restoring what it produced would hand downstream stages
an empty context); shard-level resume is the sampling loop's own mechanism
(io/shards.py). Context updates are persisted JSON-sanitized — numpy
arrays round-trip as lists; stages that must hand large arrays downstream
should write them to disk and pass paths (the reference's shard pattern).

Host copy of ``pmarlo_tpu/workflow/pipeline.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import numbers
import time
import traceback
import tracemalloc
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from ..utils.json_io import read_json, sanitize_for_json, write_json

logger = logging.getLogger("pmarlo_tpu")


class RunStatus(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    SKIPPED = "skipped"

    @property
    def counts_as_done(self) -> bool:
        """SKIPPED means 'completed in an earlier run' — both survive a
        resume (a resumed run re-writing completed stages as merely
        'skipped' must not degrade the checkpoint for the NEXT resume)."""
        return self in (RunStatus.COMPLETED, RunStatus.SKIPPED)


def _json_clean(obj: Any) -> bool:
    """True when ``obj`` round-trips through a JSON checkpoint without
    losing type fidelity (scalars/str/lists/dicts only — numpy arrays,
    Systems, models do not; tuples degrade to lists, which downstream
    indexing tolerates)."""
    if obj is None or isinstance(obj, (bool, str)):
        return True
    if isinstance(obj, numbers.Real):  # int/float incl. numpy scalars
        return True
    if isinstance(obj, (list, tuple)):
        return all(_json_clean(v) for v in obj)
    if isinstance(obj, dict):
        return all(
            isinstance(k, str) and _json_clean(v) for k, v in obj.items()
        )
    return False


@dataclasses.dataclass
class Stage:
    """One pipeline stage: fn(context) -> dict of context updates."""

    name: str
    fn: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]
    description: str = ""


@dataclasses.dataclass
class StageResult:
    name: str
    status: RunStatus
    wall_time_s: float = 0.0
    peak_memory_mb: Optional[float] = None
    error: Optional[str] = None
    updates: Optional[Dict[str, Any]] = None
    #: the stage's live outputs could NOT be faithfully JSON-recorded
    #: (arrays, Systems, models) — replaying the sanitized form would
    #: hand downstream stages str(obj) reprs, so resume re-runs instead
    updates_lossy: bool = False

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "status": self.status.value,
            "wall_time_s": round(self.wall_time_s, 3),
            "peak_memory_mb": self.peak_memory_mb,
            "error": self.error,
            "updates": self.updates,
            "updates_lossy": self.updates_lossy,
        }


class Pipeline:
    """Sequential stage runner with banners, timing, and resume.

    Usage::

        pipe = Pipeline("sampling", checkpoint=out / "pipeline.json")
        pipe.add("remd", run_remd_stage)
        pipe.add("features", featurize_stage)
        context = pipe.run({"pdb": "protein.pdb"})
    """

    def __init__(
        self,
        name: str,
        checkpoint: Optional["str | Path"] = None,
        track_memory: bool = False,
    ):
        self.name = name
        self.checkpoint = Path(checkpoint) if checkpoint else None
        self.track_memory = track_memory
        self.stages: List[Stage] = []
        self.results: List[StageResult] = []

    def add(self, name: str, fn: Callable, description: str = "") -> "Pipeline":
        if any(s.name == name for s in self.stages):
            raise ValueError(f"duplicate stage name {name!r}")
        self.stages.append(Stage(name=name, fn=fn, description=description))
        return self

    def _done_stages(self) -> Dict[str, Dict[str, Any]]:
        """{stage name: recorded context updates} for stages already done
        (completed in any earlier run, including ones a previous resume
        re-recorded as skipped). Stages whose outputs could not be
        faithfully JSON-recorded (updates_lossy) are deliberately NOT
        done: replaying str(obj)/list-ified reprs would silently corrupt
        downstream context, so resume re-runs them instead."""
        if self.checkpoint is None or not self.checkpoint.exists():
            return {}
        data = read_json(self.checkpoint)
        done = {}
        for r in data.get("stages", []):
            if not RunStatus(r.get("status", "pending")).counts_as_done:
                continue
            if r.get("updates_lossy"):
                logger.warning(
                    "[%s] stage %s will RE-RUN on resume: its outputs "
                    "(live objects/arrays) cannot round-trip through the "
                    "JSON checkpoint — stages that must skip on resume "
                    "should write artifacts to disk and pass paths",
                    self.name, r["name"],
                )
                continue
            done[r["name"]] = r.get("updates") or {}
        return done

    def _write_checkpoint(self, status: RunStatus):
        if self.checkpoint is None:
            return
        write_json(self.checkpoint, {
            "pipeline": self.name,
            "status": status.value,
            "stages": [r.to_dict() for r in self.results],
        })

    def run(
        self, context: Optional[Dict[str, Any]] = None, resume: bool = True
    ) -> Dict[str, Any]:
        """Execute all stages; raises after recording a FAILED status."""
        context = dict(context or {})
        done = self._done_stages() if resume else {}
        self.results = []
        total_start = time.perf_counter()
        for stage in self.stages:
            if stage.name in done:
                logger.info("[%s] stage %-20s SKIPPED (checkpoint)", self.name, stage.name)
                # replay the stage's recorded outputs so downstream
                # stages see the same context as in the original run
                context.update(done[stage.name])
                self.results.append(StageResult(
                    stage.name, RunStatus.SKIPPED,
                    updates=done[stage.name] or None,
                ))
                continue
            banner = f"[{self.name}] stage {stage.name:<20s} RUNNING"
            logger.info(banner)
            if self.track_memory:
                tracemalloc.start()
            t0 = time.perf_counter()
            try:
                updates = stage.fn(context)
                wall = time.perf_counter() - t0
                peak = None
                if self.track_memory:
                    _, peak_bytes = tracemalloc.get_traced_memory()
                    tracemalloc.stop()
                    peak = round(peak_bytes / 1e6, 2)
                if updates:
                    context.update(updates)
                self.results.append(StageResult(
                    stage.name, RunStatus.COMPLETED, wall, peak,
                    updates=sanitize_for_json(updates) if updates else None,
                    updates_lossy=bool(updates) and not _json_clean(updates),
                ))
                logger.info(
                    "[%s] stage %-20s COMPLETED in %.2fs%s",
                    self.name, stage.name, wall,
                    f" (peak {peak} MB)" if peak else "",
                )
                self._write_checkpoint(RunStatus.RUNNING)
            except Exception as exc:
                wall = time.perf_counter() - t0
                if self.track_memory and tracemalloc.is_tracing():
                    tracemalloc.stop()
                self.results.append(StageResult(
                    stage.name, RunStatus.FAILED, wall,
                    error=f"{type(exc).__name__}: {exc}",
                ))
                self._write_checkpoint(RunStatus.FAILED)
                logger.error(
                    "[%s] stage %s FAILED after %.2fs\n%s",
                    self.name, stage.name, wall, traceback.format_exc(),
                )
                raise
        total = time.perf_counter() - total_start
        logger.info("[%s] pipeline completed in %.2fs", self.name, total)
        self._write_checkpoint(RunStatus.COMPLETED)
        context["__pipeline_results__"] = [r.to_dict() for r in self.results]
        return context


__all__ = ["Pipeline", "RunStatus", "Stage", "StageResult"]
