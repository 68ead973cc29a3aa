#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pmarlo_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number the correctness check compared, with its
limit) and the same numbers as the last lines of standard error. Exits
with another code than 0, and prints no result, without the CUDA devices
the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # the checkout's root in place of this folder: the harness's modules are
    # imported as ``portbench.*`` and shadow no other module
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness import run_cell

    return run_cell(a.workload, a.seed, a.seconds, bool(a.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
