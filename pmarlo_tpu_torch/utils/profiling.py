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

The program's own spans and counters (``Recorder``, one per process:
``RECORDER``) are kept in memory, off by default: off, a span site costs
one flag check and records nothing. ``recording()`` (or
``RECORDER.start()``) turns them on; ``trace()`` turns them on for its
block and writes them into its ``trace.json`` as a host track. A span
holds its name, its start and end, its parent and the segment it belongs
to (a root span opened with ``segment=True`` starts a new one, and every
span below it carries its id), and a few attributes; a counter is a name
and a value recorded inside the innermost open span. Times are
``time.time_ns()``: the clock of the host events of ``torch.profiler``'s
Chrome trace (the realtime clock; the file subtracts
``baseTimeNanoseconds``), so spans and the device trace share one time
line. Spans are meant for one thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

TRACE_FILE = "trace.json"
#: the thread id of the program's span track in an exported trace
SPAN_TID = 1_000_000

#: the clock of spans: the one ``torch.profiler`` puts its host events on
clock_ns = time.time_ns


@dataclasses.dataclass
class Span:
    """One span: ``[start_ns, end_ns)`` on ``clock_ns`` (``end_ns`` 0 while
    it is open), the index of its parent in ``Recorder.spans`` (-1 for a
    root), its segment id (None outside every segment) and its attributes."""

    name: str
    start_ns: int
    end_ns: int = 0
    parent: int = -1
    segment: Optional[int] = None
    attrs: Dict = dataclasses.field(default_factory=dict)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class Count:
    """One counter reading: ``value`` (a number, or a 0-d tensor that is
    read when the counter is), the segment and the span it was recorded in
    (-1: outside every span)."""

    name: str
    value: object
    segment: Optional[int]
    span: int


class _Open:
    """The context of one span while the recorder is on."""

    __slots__ = ("rec", "name", "segment", "attrs", "index")

    def __init__(self, rec: "Recorder", name: str, segment: bool, attrs: Dict):
        self.rec, self.name, self.segment, self.attrs = rec, name, segment, attrs

    def __enter__(self) -> Span:
        rec = self.rec
        parent = rec._open[-1] if rec._open else -1
        if self.segment:
            seg = rec._segments
            rec._segments += 1
        else:
            seg = rec.spans[parent].segment if parent >= 0 else None
        self.index = len(rec.spans)
        span = Span(self.name, clock_ns(), 0, parent, seg, self.attrs)
        rec.spans.append(span)
        rec._open.append(self.index)
        return span

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.spans[self.index].end_ns = clock_ns()
        if rec._open and rec._open[-1] == self.index:
            rec._open.pop()
        elif self.index in rec._open:
            rec._open.remove(self.index)


_OFF = contextlib.nullcontext()


class Recorder:
    """The program's spans and counters, in memory (module docstring)."""

    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.counts: List[Count] = []
        self._open: List[int] = []
        self._segments = 0

    def start(self) -> None:
        self.on = True

    def stop(self) -> None:
        self.on = False

    def clear(self) -> None:
        """Forget every span, counter and segment id (open spans too)."""
        self.spans, self.counts, self._open, self._segments = [], [], [], 0

    def span(self, name: str, segment: bool = False, **attrs):
        """A context manager that records the block as span ``name`` and
        yields its ``Span`` (attributes may be added to ``attrs`` inside);
        off, a shared no-op context that yields None. ``segment=True``
        starts a new segment id."""
        if not self.on:
            return _OFF
        return _Open(self, name, segment, attrs)

    def count(self, name: str, value) -> None:
        """Records ``value`` under ``name`` in the innermost open span."""
        if not self.on:
            return
        k = self._open[-1] if self._open else -1
        self.counts.append(Count(name, value, self.spans[k].segment if k >= 0 else None, k))

    # --- reading ---

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, index: int) -> List[int]:
        return [k for k, s in enumerate(self.spans) if s.parent == index]

    def self_ns(self, index: int) -> int:
        """Span ``index``'s time less its children's."""
        return self.spans[index].ns - sum(self.spans[k].ns for k in self.children(index))

    def total(self, name: str, segment: Optional[int] = None) -> float:
        """The sum of counter ``name`` (over one segment, or all)."""
        return sum(float(c.value) for c in self.counts
                   if c.name == name and (segment is None or c.segment == segment))

    @property
    def segments(self) -> int:
        """Segment ids handed out since the last ``clear``."""
        return self._segments


#: the process's recorder
RECORDER = Recorder()


def span(name: str, segment: bool = False, **attrs):
    """``RECORDER.span``."""
    return RECORDER.span(name, segment, **attrs)


def count(name: str, value) -> None:
    """``RECORDER.count``."""
    RECORDER.count(name, value)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Empties ``RECORDER``, turns it on for the block and yields it; leaves
    it on or off as it was found."""
    was = RECORDER.on
    RECORDER.clear()
    RECORDER.start()
    try:
        yield RECORDER
    finally:
        RECORDER.on = was


def _span_events(rec: Recorder, first: int, base_ns: int) -> List[Dict]:
    """Chrome trace events (a host track of this process) of the spans from
    index ``first`` on, with the counters recorded in each as arguments."""
    pid = os.getpid()
    events: List[Dict] = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
                           "args": {"name": "pmarlo_tpu_torch spans"}}]
    counters: Dict[int, Dict[str, float]] = {}
    for c in rec.counts:
        if c.span >= first:
            d = counters.setdefault(c.span, {})
            d[c.name] = d.get(c.name, 0.0) + float(c.value)
    for k in range(first, len(rec.spans)):
        s = rec.spans[k]
        if not s.end_ns:
            continue
        args = {"segment": s.segment,
                "parent": rec.spans[s.parent].name if s.parent >= 0 else None,
                **{a: v if isinstance(v, (bool, int, float, str)) else str(v)
                   for a, v in s.attrs.items()},
                **counters.get(k, {})}
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": SPAN_TID, "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": s.ns / 1e3, "args": args})
    return events


@contextlib.contextmanager
def trace(log_dir: "str | Path" = "pmarlo_tpu_torch_trace"):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (Chrome trace format), with the program's spans
    of the block (``RECORDER``, on for the block) as a track of their own on
    the trace's clock. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    was = RECORDER.on
    first = len(RECORDER.spans)
    RECORDER.start()
    prof.start()
    try:
        yield str(log_dir)
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        RECORDER.on = was
        path = log_dir / TRACE_FILE
        prof.export_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        doc["traceEvents"].extend(
            _span_events(RECORDER, first, int(doc.get("baseTimeNanoseconds", 0))))
        path.write_text(json.dumps(doc))


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


__all__ = ["trace", "StageTimer", "device_memory_stats", "Recorder", "RECORDER", "Span",
           "Count", "span", "count", "recording", "clock_ns"]
