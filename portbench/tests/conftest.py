"""Shared set-up of the harness's tests: a copy of the benchmark in a
temporary checkout with one small configuration added as files (alanine
dipeptide under OBC2 at 4 replicas and 300-step segments), so that a whole
run fits a test on the CPU; the program's package is linked in beside it."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = "tiny"


def make_checkout(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json``, ``portbench/`` and a link to the
    port; adds the configuration ``tiny`` and its cells ``tiny.fused`` /
    ``tiny.cvbias`` as new files and entries only."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    (dest / "pmarlo_tpu_torch").symlink_to(REPO / "pmarlo_tpu_torch")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = json.loads((dest / "portbench/configs/alanine-obc2.json").read_text())
    cfg.update(name=TINY)
    cfg["remd"]["n_replicas"] = 4
    cfg["md"]["steps_per_segment"] = 300
    (dest / f"portbench/configs/{TINY}.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": TINY, "source": "test", "reduced": [], "why": "test",
                             "file": f"portbench/configs/{TINY}.json"})
    limits = (dest / "portbench/limits/chignolin-obc2.fused.json").read_text()
    for mix in ("fused", "cvbias"):
        bench["workloads"].append({"name": f"{TINY}.{mix}", "config": TINY, "traffic": mix,
                                   "chips": 1, "why": "test"})
        (dest / f"portbench/limits/{TINY}.{mix}.json").write_text(limits)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    """The temporary checkout, importable as ``portbench`` for the session
    (the repository's own ``portbench`` is not on the path here)."""
    root = make_checkout(tmp_path_factory.mktemp("checkout"))
    for name in [m for m in sys.modules if m == "portbench" or m.startswith("portbench.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    yield root
    sys.path.remove(str(root))


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
