"""Alternative lazy facade + console entry point
(reference: src/pmarlo/main.py:26-44, console script pyproject.toml:72-73).

Port of ``pmarlo_tpu/main.py``: the same facade over the port's modules and
the same subcommands, arguments and JSON output, as ``pmarlo-tpu-torch``
(``python -m pmarlo_tpu_torch.main``). ``run-segment`` and ``remd`` run on
the card when there is one (the entry points' ``device=None``); ``info``
names the backend and the cards PyTorch sees. ``dashboard`` imports
``.webapp``, which the port does not have yet: it raises
``ModuleNotFoundError``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Any

_EXPORTS = {
    "Protein": ("pmarlo_tpu_torch.protein.protein", "Protein"),
    "run_segment": ("pmarlo_tpu_torch.md.simulation", "run_segment"),
    "run_replica_exchange": ("pmarlo_tpu_torch.remd.remd", "run_replica_exchange"),
    "run_complete_msm_analysis": ("pmarlo_tpu_torch.msm.enhanced", "run_complete_msm_analysis"),
    "set_global_seed": ("pmarlo_tpu_torch.utils.seed", "set_global_seed"),
}


def __getattr__(name: str) -> Any:
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'pmarlo_tpu_torch.main' has no attribute {name!r}")
    return getattr(importlib.import_module(module_name), attr)


def get_version() -> str:
    import pmarlo_tpu_torch

    return pmarlo_tpu_torch.__version__


def get_info() -> dict:
    import pmarlo_tpu_torch

    return pmarlo_tpu_torch.get_info()


def main(argv=None) -> int:
    """Console entry: info / run-segment / remd / analyze subcommands."""
    parser = argparse.ArgumentParser(prog="pmarlo-tpu-torch")
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("info", help="print backend/device info")

    seg = sub.add_parser("run-segment", help="run one MD segment")
    seg.add_argument("pdb")
    seg.add_argument("--steps", type=int, default=10_000)
    seg.add_argument("--report-interval", type=int, default=100)
    seg.add_argument("--temperature", type=float, default=300.0)
    seg.add_argument("--output", default="segment.npz")
    seg.add_argument("--dt", type=float, default=0.002,
                     help="timestep in ps (0.004 with --constraints hbonds)")
    seg.add_argument("--constraints", choices=["none", "hbonds"],
                     default=None,
                     help="X-H SHAKE on the implicit path (OpenMM HBonds)")

    remd = sub.add_parser("remd", help="run replica exchange")
    remd.add_argument("pdb")
    remd.add_argument("--steps", type=int, default=10_000)
    remd.add_argument("--replicas", type=int, default=8)
    remd.add_argument("--tmin", type=float, default=300.0)
    remd.add_argument("--tmax", type=float, default=450.0)
    remd.add_argument("--dt", type=float, default=0.002,
                      help="timestep in ps (0.004 with --constraints hbonds)")
    remd.add_argument("--constraints", choices=["none", "hbonds"],
                      default=None,
                      help="X-H SHAKE on the implicit path (OpenMM HBonds)")

    dash = sub.add_parser(
        "dashboard", help="serve the analysis dashboard for a run directory"
    )
    dash.add_argument("run_dir")
    dash.add_argument("--port", type=int, default=8501)
    dash.add_argument("--export", metavar="OUT_HTML",
                      help="write static HTML instead of serving")

    args = parser.parse_args(argv)
    if args.command == "info" or args.command is None:
        print(json.dumps(get_info(), indent=2))
        return 0
    if args.command == "run-segment":
        from .md.simulation import run_segment

        result = run_segment(
            args.pdb, n_steps=args.steps,
            report_interval=args.report_interval,
            temperature_K=args.temperature,
            output_file=args.output,
            dt_ps=args.dt, constraints=args.constraints,
        )
        print(json.dumps({
            "frames": list(result["positions"].shape),
            "output": str(result.get("output_file")),
            "final_temperature_K": float(result["temperature"][-1]),
        }))
        return 0
    if args.command == "remd":
        from .remd.remd import RemdConfig, run_replica_exchange

        cfg = RemdConfig(n_replicas=args.replicas, t_min=args.tmin,
                         t_max=args.tmax, dt_ps=args.dt)
        result, _ = run_replica_exchange(
            args.pdb, n_steps=args.steps, config=cfg,
            constraints=args.constraints,
        )
        print(json.dumps({
            "frames": list(result.positions.shape),
            "mean_acceptance": result.mean_acceptance,
        }))
        return 0
    if args.command == "dashboard":
        from .webapp import export_static, serve

        if args.export:
            print(f"wrote {export_static(args.run_dir, args.export)}")
        else:
            serve(args.run_dir, port=args.port)
        return 0
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
