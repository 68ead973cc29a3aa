#!/usr/bin/env python3
"""A run of one cell with the program's span recorder on from before set-up.

    python3 portbench/program_trace.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run is the harness's own (``harness.run_cell``: set-up, the window, with
``--trace 1`` the device trace and the per-layer metrics, the check), with
``pmarlo_tpu_torch.utils.profiling.RECORDER`` turned on first, so that
set-up and every segment record their spans and counters and the whole-run
kernel runs its stamped build. It prints the harness's result line, then one
JSON line ``{"program": {...}, "checks": {...}}``.

``program`` holds ``split``'s readings (``READINGS``), each a pure function
of the recorder and, with ``--trace 1``, of the step kernels in the device
trace:

- ``runner_prepare_ms.segment`` / ``runner_finish_ms.segment``: the time
  inside ``remd.prepare`` / ``remd.finish`` in which no step kernel ran, a
  segment of the window on average. The kernels are placed on the host's
  clock (``place_kernels``): the trace's device timestamps stray from its
  host timestamps by up to milliseconds on an H100;
- ``runner_host_syncs.segment``: blocking device-to-host copies a segment;
- ``md_step_us.<phase>``: the phase's share of the sampled steps' cycles
  times the average step's device time (the step kernels' time in the trace
  over the window's steps); ``md_step_us.other`` the average step less the
  four named phases;
- ``setup_minimize_s``: the ``remd.minimize`` span of set-up.

``checks`` holds what tests those readings: ``identity`` (prepare + finish +
the window's time outside every ``remd.run_fused`` span, where no placed
kernel ran, against (window - the step kernels' device time) / segments)
and ``clock`` (each step kernel matched by correlation id to its launch
call and to the ``remd.launch`` span that holds that call). ``--trace 0``
times the window with the recorder on (its cost against a run of
``run.py``). No metric of ``BENCHMARK.json`` reads this yet: the harness
does not turn the recorder on.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
Interval = Tuple[float, float]
STEP_PHASES = ("pairs", "folds", "barriers", "bias")
READINGS = ("runner_prepare_ms.segment", "runner_finish_ms.segment",
            "runner_host_syncs.segment", *(f"md_step_us.{p}" for p in STEP_PHASES),
            "md_step_us.other", "setup_minimize_s")


def _union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def uncovered(a: float, b: float, busy: Sequence[Interval]) -> float:
    """The part of ``[a, b)`` outside the sorted disjoint ``busy`` intervals."""
    covered = sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy if s < b and e > a)
    return max(b - a, 0.0) - covered


# --- the trace ----------------------------------------------------------------------------------

class _Saved:
    """A profiler whose Chrome trace was exported already (a trace is saved
    once): ``export_chrome_trace`` copies that file."""

    def __init__(self, path: str):
        self.path = path

    def export_chrome_trace(self, dest: str) -> None:
        shutil.copyfile(self.path, dest)


def summarize_with_events(prof, window_s: float, summarize) -> Tuple[Dict, int, List[dict]]:
    """``summarize(prof, window_s)`` (``portbench.trace.summarize``) with the
    trace's ``baseTimeNanoseconds`` and events: the trace is exported once."""
    fd, path = tempfile.mkstemp(prefix="portbench_program_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
        summary = summarize(_Saved(path), window_s)
    finally:
        os.unlink(path)
    return summary, int(doc.get("baseTimeNanoseconds", 0)), doc["traceEvents"]


def step_kernels(base_ns: int, events: List[dict]) -> Dict:
    """From a Chrome trace: the step kernels' device intervals (ns on the
    recorder's clock) and the interval of the runtime call that launched each
    (by correlation id; None where the trace has none)."""
    from portbench.trace import MD_KERNEL

    def ns(ev):
        s = base_ns + float(ev["ts"]) * 1e3
        return s, s + float(ev["dur"]) * 1e3

    def corr(ev):
        return ev.get("args", {}).get("correlation")

    calls = {corr(e): e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr(e) is not None}
    kernels = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
                      and MD_KERNEL.search(e.get("name", ""))), key=lambda e: float(e["ts"]))
    return {"kernels": [ns(k) for k in kernels],
            "calls": [ns(calls[corr(k)]) if corr(k) in calls else None for k in kernels]}


def place_kernels(kernels: Sequence[Interval],
                  calls: Sequence[Optional[Interval]]) -> List[Interval]:
    """Each step kernel's run on the host's clock: from the end of the runtime
    call that launched it, for its device duration. The trace's device
    timestamps stray from its host timestamps by up to milliseconds on an
    H100, while a duration is the difference of two device timestamps close
    together; a kernel with no launch call keeps its device interval."""
    return [kv if c is None else (c[1], c[1] + kv[1] - kv[0]) for kv, c in zip(kernels, calls)]


# --- the readings -------------------------------------------------------------------------------

def segments(rec, window_ns: Optional[Interval] = None) -> List[int]:
    """The indices of the finished ``remd.run_fused`` spans (one a segment),
    those inside ``window_ns`` where it is given."""
    return [k for k, s in enumerate(rec.spans) if s.name == "remd.run_fused" and s.end_ns
            and (window_ns is None or window_ns[0] <= s.start_ns and s.end_ns <= window_ns[1])]


def _child(rec, k: int, name: str):
    return next((s for s in rec.spans if s.parent == k and s.name == name), None)


def setup_minimize_s(rec) -> Optional[float]:
    """The first finished ``remd.minimize`` span outside every segment (s)."""
    spans = [s for s in rec.named("remd.minimize") if s.segment is None and s.end_ns]
    return spans[0].ns * 1e-9 if spans else None


def runner_host_syncs(rec, roots: Sequence[int]) -> Optional[float]:
    """``remd.host_syncs`` a segment of ``roots``."""
    if not roots:
        return None
    segs = {rec.spans[k].segment for k in roots}
    return sum(float(c.value) for c in rec.counts
               if c.name == "remd.host_syncs" and c.segment in segs) / len(roots)


def md_step_us(rec, roots: Sequence[int], md_kernel_s: Optional[float],
               steps: Optional[int]) -> Dict[str, float]:
    """``md_step_us.<phase>`` from the segments' stamp counters and the
    average step's device time; empty where either is missing."""
    segs = {rec.spans[k].segment for k in roots}
    cyc = {p: sum(float(c.value) for c in rec.counts
                  if c.name == f"md_step.cycles.{p}" and c.segment in segs)
           for p in (*STEP_PHASES, "other")}
    total = sum(cyc.values())
    if total <= 0 or not md_kernel_s or not steps:
        return {}
    step_us = md_kernel_s / steps * 1e6
    out = {f"md_step_us.{p}": cyc[p] / total * step_us for p in STEP_PHASES}
    out["md_step_us.other"] = step_us - sum(out.values())
    return out


def runner_ms(rec, roots: Sequence[int], placed: Sequence[Interval]) -> Dict[str, float]:
    """``runner_prepare_ms.segment`` / ``runner_finish_ms.segment``: the time
    of ``remd.prepare`` / ``remd.finish`` outside the ``placed`` kernels."""
    busy = _union(placed)
    out = {}
    for name, key in (("remd.prepare", "runner_prepare_ms.segment"),
                      ("remd.finish", "runner_finish_ms.segment")):
        spans = [_child(rec, k, name) for k in roots]
        out[key] = sum(uncovered(s.start_ns, s.end_ns, busy)
                       for s in spans if s is not None) / len(roots) * 1e-6
    return out


def split(rec, window_ns: Optional[Interval] = None, trace: Optional[Dict] = None,
          steps: Optional[int] = None) -> Dict[str, float]:
    """The readings (``READINGS``) of a run from the recorder ``rec`` and,
    where given, the window on its clock, ``trace`` (``step_kernels``' keys
    and ``md_kernel_s``, the step kernels' device seconds) and the window's
    steps. A reading with nothing to read is left out; with the recorder off
    (no spans) the result is empty."""
    out: Dict[str, float] = {}
    minimize = setup_minimize_s(rec)
    if minimize is not None:
        out["setup_minimize_s"] = minimize
    roots = segments(rec, window_ns)
    if not roots:
        return out
    out["runner_host_syncs.segment"] = runner_host_syncs(rec, roots)
    if trace is None or window_ns is None:
        return out
    out.update(md_step_us(rec, roots, trace.get("md_kernel_s"), steps))
    out.update(runner_ms(rec, roots, place_kernels(trace["kernels"], trace["calls"])))
    return out


# --- what tests the readings --------------------------------------------------------------------

def identity(rec, window_ns: Interval, window_s: float, trace: Dict) -> Optional[Dict]:
    """prepare + finish + the window's time outside every segment's span in
    which no placed kernel ran, a segment, against (window - the step
    kernels' device time) / segments: the two sides meet where the placed
    kernels, ``remd.prepare`` and ``remd.finish`` leave no time of a
    segment's span unaccounted for."""
    roots = segments(rec, window_ns)
    if not roots:
        return None
    placed = place_kernels(trace["kernels"], trace["calls"])
    parts = runner_ms(rec, roots, placed)
    busy = _union(placed)
    outside = uncovered(window_ns[0], window_ns[1], busy) - sum(
        uncovered(rec.spans[k].start_ns, rec.spans[k].end_ns, busy) for k in roots)
    n = len(roots)
    lhs = sum(parts.values()) + outside / n * 1e-6
    rhs = (window_s - trace["md_kernel_s"]) / n * 1e3
    return {"segments": n, "outside_spans_ms.segment": outside / n * 1e-6,
            "spans_ms.segment": lhs, "window_less_kernels_ms.segment": rhs,
            "gap": (lhs - rhs) / rhs if rhs else None}


def clock(rec, window_ns: Interval, trace: Dict) -> Dict:
    """Each step kernel of the window, matched by correlation id to the
    runtime call that launched it and to the ``remd.launch`` span that holds
    that call: how many calls a span holds (the host clocks agree), how many
    kernels the trace starts before their span, and how many of those it
    starts before their own launch call (the trace's device clock astray,
    which the recorder cannot cause); the least and median device start
    less the call's start (us)."""
    launches = sorted((s.start_ns, s.end_ns) for s in rec.named("remd.launch") if s.end_ns)
    held = early = acausal = 0
    lead = []
    for kv, c in zip(trace["kernels"], trace["calls"]):
        if c is None or not window_ns[0] <= c[0] <= window_ns[1]:
            continue
        sp = next((s for s in launches if s[0] <= c[0] and c[1] <= s[1]), None)
        lead.append(kv[0] - c[0])
        if sp is None:
            continue
        held += 1
        if kv[0] < sp[0]:
            early += 1
            acausal += kv[0] < c[0]
    return {"kernels": len(lead), "calls_held_by_a_launch_span": held,
            "kernels_before_their_span": early, "of_which_before_their_own_call": acausal,
            "kernel_start_less_call_start_us": [min(lead) * 1e-3, statistics.median(lead) * 1e-3]
            if lead else None}


# --- the run ------------------------------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, traced: bool, t0: float,
        recorder: bool = True, device: str = "cuda", err=sys.stderr) -> Tuple[int, str, Dict, Dict]:
    """The harness's run of the cell with the recorder on (``recorder``);
    returns its exit code, its result line, ``split``'s readings and the
    checks. The harness's profiler, summary and context are caught by
    wrapping ``trace.profile``, ``trace.summarize`` and
    ``harness.metric_reader`` for the run."""
    from pmarlo_tpu_torch.utils import profiling

    from portbench import harness
    from portbench import trace as trace_mod

    seen: Dict = {}
    profile, summarize, reader = trace_mod.profile, trace_mod.summarize, harness.metric_reader

    class Window:
        """The harness's profiler, with the window's edges on the recorder's clock."""

        def __init__(self):
            self.prof = profile()

        def __enter__(self):
            entered = self.prof.__enter__()
            seen["start_ns"] = profiling.clock_ns()
            return entered

        def __exit__(self, *exc):
            seen["end_ns"] = profiling.clock_ns()
            return self.prof.__exit__(*exc)

    def keep_summary(prof, window_s):
        summary, base, events = summarize_with_events(prof.prof, window_s, summarize)
        seen["trace"] = {**step_kernels(base, events), "md_kernel_s": summary["md_kernel_s"]}
        seen["window_s"] = summary["window_s"]
        return summary

    def keep_ctx(name):
        read = reader(name)

        def wrapped(ctx):
            seen["steps"] = ctx.get("steps")
            return read(ctx)

        return wrapped

    trace_mod.profile, trace_mod.summarize, harness.metric_reader = Window, keep_summary, keep_ctx
    profiling.RECORDER.clear()
    if recorder:
        profiling.RECORDER.start()
    out = io.StringIO()
    try:
        rc = harness.run_cell(workload, seed, seconds, traced, t0, device=device, out=out,
                              err=err)
    finally:
        profiling.RECORDER.stop()
        trace_mod.profile, trace_mod.summarize, harness.metric_reader = profile, summarize, reader
    text = out.getvalue().strip()
    line = text.splitlines()[-1] if text else ""
    rec = profiling.RECORDER
    window = (seen["start_ns"], seen["end_ns"]) if "start_ns" in seen else None
    readings = split(rec, window, seen.get("trace"), seen.get("steps"))
    checks: Dict = {}
    if window is not None and "trace" in seen and rec.spans:
        checks = {"identity": identity(rec, window, seen["window_s"], seen["trace"]),
                  "clock": clock(rec, window, seen["trace"])}
    return rc, line, readings, checks


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--recorder", type=int, choices=(0, 1), default=1,
                   help="0: the recorder stays off (the run is run.py's)")
    a = p.parse_args(argv)
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    rc, line, readings, checks = run(a.workload, a.seed, a.seconds, bool(a.trace), t0,
                                     recorder=bool(a.recorder))
    if line:
        print(line)
    print(json.dumps({"program": readings, "checks": checks}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
