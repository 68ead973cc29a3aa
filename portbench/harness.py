"""One run of one cell: set-up, the measured window, the reading of the
trace, the judgement of the outputs, and the result line.

Everything that belongs to one configuration, mix or per-layer metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<mix>.json``, ``limits/<cell>.json``
(the limits of the numbers the check compares) and ``metrics/<metric>.py``
(a ``read(ctx)`` that returns the metric, or None where it finds nothing
to read).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "pmarlo_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _host(state: dict) -> dict:
    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else v) for k, v in state.items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", out=sys.stdout, err=sys.stderr) -> int:
    """Run the cell; print the result line on ``out``. Returns the exit code."""
    import torch

    from . import check, generator

    bench = manifest()
    cell = cell_of(bench, workload)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=err)
            return 2
        torch.cuda.reset_peak_memory_stats()
    config = config_of(bench, cell["config"])
    mix = generator.load_json("traffic", cell["traffic"])
    limits = generator.load_json("limits", workload)

    t_setup = time.perf_counter()
    session = generator.Session(config, mix, seed, device=device)
    session.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    print("setup stages: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                       [("before the cell", t_setup - t0), *session.stages]),
          file=err)
    starts, results = [], []
    prof = None
    if trace:
        from . import trace as trace_mod

        prof = trace_mod.profile()
        prof.__enter__()
    # the window: segments back to back, each returned (so synchronised)
    # before the next is asked for, until the deadline has passed
    t_window = time.perf_counter()
    setup_s = t_window - t0
    deadline = t_window + float(seconds)
    while True:
        starts.append(session.state())
        results.append(session.segment())
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t_window
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=err)
        return 3
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    if prof is not None:
        summary = trace_mod.summarize(prof, window_s)
        prof = None

    n_seg = len(results)
    steps = n_seg * session.steps
    ctx = {"session": session, "cell": cell, "trace": summary, "segments": n_seg,
           "steps": steps, "frames": steps // session.report, "window_s": window_s}
    metrics: Dict[str, dict] = {}
    if trace:
        for m in bench["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        ns = session.R * steps * session.dt * 1e-3
        metrics["ns_per_day"] = {"value": ns * 86400.0 / window_s, "unit": "ns/day"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # judge: the program's state is freed first, the reference runs after
    sampled = set(check.sample(n_seg, seed))
    starts = [_host(s) if i in sampled else {"attempt": s["attempt"]}
              for i, s in enumerate(starts)]
    session.close()
    n_failed = sum(check.failed(r, session.R) for r in results)
    t_judge = time.perf_counter()
    numbers = check.judge(session, starts, results, limits, device=device)
    print(f"judged {n_seg} segments in {time.perf_counter() - t_judge:.3f} s", file=err)
    correct = n_failed == 0 and check.passes(numbers)
    for k, d in numbers.items():
        print(f"check {k} {d['value']!r} limit {d['limit']!r}", file=err)
    result = {"correct": bool(correct), "attempted": n_seg, "failed": int(n_failed),
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device, "kind": kind,
                         "count": int(cell["chips"]), "memory_peak_bytes": peak}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = numbers
    if forbidden_modules():
        print(f"portbench: the process loaded {forbidden_modules()}", file=err)
        return 3
    print(json.dumps(result), file=out, flush=True)
    return 0
