"""Time the neighbor-listed GB path (``md/nblist.py``) on the card.

    python scripts/time_nblist.py

On the 3,726-atom chignolin assembly of ``chip_smoke.py`` (27 copies,
GBn2, the System with its dense neck tables, positions as built) and a
list at 2.0 + 0.2 nm with ``run_md_nb``'s default capacity (1,277 slots a
row). Prints the card's name and power limit, then one line:
``nblist`` and a JSON object.

- ``listed_pairs``, ``slots``: valid slots of the list and all of them;
- ``gather_ab``: for each of four rounds, advanced indexing, ``index_select``,
  ``index_select``, advanced indexing (the module's ``_take`` swapped in
  and out; the backward of ``t[idx]`` is an ``index_put_`` with
  accumulation, that of ``index_select`` an ``index_add_``): ``eval_ms``,
  one evaluation of the energy and its autograd forces (CUDA events, 10
  calls, warm), and ``step_ms``, 100 ``run_md_nb`` steps at 2 fs, 1/ps,
  300 K, a rebuild every 20 steps, from Maxwell-Boltzmann velocities
  (host wall over the steps, the card synchronised at both ends);
- ``profile``: ``torch.profiler`` over 10 evaluations: device
  milliseconds an evaluation, kernel launches an evaluation, and the ten
  operators with the most device time (ms an evaluation).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import pmarlo_tpu_torch  # noqa: E402,F401  (pins float32 matmuls)
from pmarlo_tpu_torch.data.chignolin import chignolin_assembly  # noqa: E402
from pmarlo_tpu_torch.md import nblist as NB  # noqa: E402
from pmarlo_tpu_torch.md.forcefield import build_system  # noqa: E402
from pmarlo_tpu_torch.md.integrate import thermalize  # noqa: E402

COPIES = (3, 3, 3)
CUTOFF, SKIN = 2.0, 0.2


def _cuda_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn, reps: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    top = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        "device_ms_an_evaluation": sum(e.self_device_time_total for e in kernels) / reps / 1e3,
        "launches_an_evaluation": sum(e.count for e in kernels) / reps,
        "top_ops_ms_an_evaluation": {e.key: e.self_device_time_total / reps / 1e3 for e in top},
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_nblist.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    system, pos = build_system(chignolin_assembly(COPIES), gb_model="gbn2", device="cuda",
                               dense_scales=True)
    x = pos.float()
    tables = NB.make_exclusion_tables(system)
    nl = NB.build_neighbor_list(x, CUTOFF + SKIN, NB._default_capacity(system.n_atoms, CUTOFF,
                                                                       SKIN))
    scales = NB._pair_scales(nl, tables)

    def evaluate():
        return NB._energy_and_forces(system, x, nl, scales, None)

    out = {"atoms": system.n_atoms, "listed_pairs": int(nl.mask.sum()),
           "slots": nl.idx.numel(), "gather_ab": []}
    take = NB._take
    variants = {"advanced_indexing": lambda t, idx: t[idx], "index_select": take}
    try:
        for name in ("advanced_indexing", "index_select", "index_select", "advanced_indexing"):
            NB._take = variants[name]
            eval_ms = _cuda_ms(evaluate, 10)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(5)
            state = thermalize(system, x, gen, 300.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            NB.run_md_nb(system, state, n_steps=100, dt=0.002, friction=1.0, temperature_K=300.0,
                         report_interval=100, cutoff=CUTOFF, skin=SKIN, rebuild_interval=20)
            torch.cuda.synchronize()
            out["gather_ab"].append({"gather": name, "eval_ms": eval_ms,
                                     "step_ms": (time.perf_counter() - t0) / 100 * 1e3})
    finally:
        NB._take = take
    out["profile"] = _profile(evaluate)
    print(f"nblist {json.dumps(out)}", flush=True)


if __name__ == "__main__":
    main()
