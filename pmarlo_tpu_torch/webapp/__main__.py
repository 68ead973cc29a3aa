"""CLI: python -m pmarlo_tpu_torch.webapp RUN_DIR [--port N | --export out.html]

Host copy of ``pmarlo_tpu/webapp/__main__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

import argparse

from .app import export_static, serve


def main():
    ap = argparse.ArgumentParser(description="pmarlo_tpu analysis dashboard")
    ap.add_argument("run_dir", help="directory written by save_analysis_results")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--export", metavar="OUT_HTML",
                    help="write a static HTML page instead of serving")
    args = ap.parse_args()
    if args.export:
        path = export_static(args.run_dir, args.export)
        print(f"wrote {path}")
    else:
        serve(args.run_dir, port=args.port)


if __name__ == "__main__":
    main()
