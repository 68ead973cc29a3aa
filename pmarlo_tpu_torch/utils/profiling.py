"""Profiling and per-stage device-time accounting.

Port of ``pmarlo_tpu/utils/profiling.py`` onto ``torch.profiler``, with its
three names:

- ``trace(log_dir)`` records CPU activity, and CUDA activity when the
  process has a card, and writes a Chrome trace (``trace.json``, viewable in
  Perfetto or ``chrome://tracing``) into ``log_dir``;
- ``StageTimer.stage`` synchronises the device of every tensor the caller
  puts in the box before it stops the clock, so a stage's time is the
  device's, not the dispatch's (JAX's version blocks on its arrays);
  values that are not tensors are skipped, and a failed synchronisation
  propagates;
- ``device_memory_stats()`` reports each CUDA card's
  ``torch.cuda.memory_stats`` (bytes in use, peak, limit) under JAX's keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: "str | Path" = "pmarlo_tpu_torch_trace"):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (Chrome trace format). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield str(log_dir)
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def _synchronize(value) -> None:
    """Wait for the device of ``value`` when it is a tensor on a card."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


@dataclasses.dataclass
class StageTimer:
    """Wall/device-time accounting per named stage.

    Usage::

        timer = StageTimer()
        with timer.stage("remd") as box:
            box["x"] = run(...)         # the timer waits for box's tensors
        print(timer.summary())
    """

    records: List[Dict] = dataclasses.field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, n_items: Optional[int] = None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            # wait for the devices of the tensors the caller stashed in the box
            for value in box.values():
                _synchronize(value)
            wall = time.perf_counter() - t0
            record = {"stage": name, "wall_s": wall}
            if n_items:
                record["throughput_per_s"] = n_items / wall
            self.records.append(record)

    def summary(self) -> List[Dict]:
        return [
            {**r, "wall_s": round(r["wall_s"], 4)} for r in self.records
        ]

    def total(self) -> float:
        return sum(r["wall_s"] for r in self.records)


def device_memory_stats() -> Dict:
    """Live/peak device memory and the card's total (bytes) per CUDA card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


__all__ = ["trace", "StageTimer", "device_memory_stats"]
