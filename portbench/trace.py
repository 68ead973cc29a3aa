"""Reading the device trace of a traced run.

``torch.profiler`` records the device alone (``ProfilerActivity.CUDA``:
CUPTI's kernels, copies and fills, and the CUDA runtime calls the host
made), started just before the window opens and stopped when it closes.
Recording the host's operators as well (``ProfilerActivity.CPU``) slowed
a segment of the windowed cell by 37-59% on an H100 against 11-14% for the
device alone, so the host side is read from the runtime calls. From the
Chrome trace (exported under ``TMPDIR``): the device's busy time (the union
of kernel, copy and fill intervals), each kernel's time, and the idle gaps,
each named by the runtime call the host was in when it began. Nothing here
falls back to the CPU: a trace without device records is an error.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
#: the step kernels of csrc/fused_md.cu (the chunk, biased chunk and whole-run REMD builds)
MD_KERNEL = re.compile(r"\bfused_(md|remd)_\w*kernel\b")


def profile():
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _short(name: str) -> str:
    m = re.search(r"(\w+)\s*(<|\()", name)
    return m.group(1) if m else name[:64]


def summarize(prof, window_s: float) -> Dict:
    """Busy seconds, seconds of the step kernels, the top device operations
    and the idle gaps of a window of ``window_s`` host seconds."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    host, device = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        iv = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev.get("name", ""))
        if ev.get("cat") in DEVICE_CATS:
            device.append(iv)
        elif ev.get("cat") in HOST_CATS:
            host.append(iv)
    if not device:
        raise RuntimeError("the trace holds no device operation")
    busy = _union([(s, e) for s, e, _ in device])
    busy_us = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    md_us = 0.0
    for s, e, n in device:
        by_name[_short(n)] = by_name.get(_short(n), 0.0) + (e - s)
        if MD_KERNEL.search(n):
            md_us += e - s
    host.sort()
    starts = [h[0] for h in host]

    def label(t: float) -> str:
        # the last runtime call the host began before t, if it still runs
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t < host[k][1]:
            return host[k][2]
        return "host outside CUDA calls"

    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy[:-1], busy[1:]):
        key = label(e0)
        gaps[key] = gaps.get(key, 0.0) + (s1 - e0) * 1e-6
    span_s = (busy[-1][1] - busy[0][0]) * 1e-6
    gaps["window edges (host before the first and after the last device operation)"] = \
        max(window_s - span_s, 0.0)
    return {
        "window_s": float(window_s),
        "busy_s": busy_us * 1e-6,
        "md_kernel_s": md_us * 1e-6,
        "device_ops": sorted(([n, v * 1e-6] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:10],
    }
