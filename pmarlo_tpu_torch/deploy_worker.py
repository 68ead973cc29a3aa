"""Indexed-job experiment worker (reference: the k8s fan-out pattern,
deploy/k8s/job-algo-tests.yaml — 3 experiment modes x 2 variants, one per
completion index, outputs on a shared volume).

Port of ``pmarlo_tpu/deploy_worker.py``: the same modes, each through the
port's modules, which run on the card when there is one (their
``device=None``): REMD of alanine dipeptide (two modes, whose ``bias``
parameter is recorded in the result, as in JAX, not applied) and of
chignolin where a chignolin PDB is found, the 35-shard MSM build, DeepTICA
training and TPT conformations.

    python -m pmarlo_tpu_torch.deploy_worker --mode-index 2 --output outputs
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

MODES = [
    ("remd_alanine", {"bias": False, "n_steps": 50_000}),
    ("remd_alanine_biased", {"bias": True, "n_steps": 50_000}),
    ("msm_35_shards", {"n_shards": 35}),
    ("remd_chignolin", {"bias": False, "n_steps": 20_000}),
    ("deeptica_train", {"epochs": 50}),
    ("tpt_conformations", {}),
]


def run_mode(index: int, output_dir: Path) -> dict:
    name, params = MODES[index % len(MODES)]
    output_dir.mkdir(parents=True, exist_ok=True)
    result = {"mode": name, "params": params, "status": "completed"}
    if name.startswith("remd_alanine"):
        from .data import alanine_dipeptide_structure
        from .md.forcefield import build_system
        from .remd.remd import RemdConfig, ReplicaExchange

        system, pos = build_system(alanine_dipeptide_structure())
        remd = ReplicaExchange(
            system, pos, RemdConfig(n_replicas=8, exchange_frequency=100)
        )
        res = remd.run(n_steps=params["n_steps"])
        result["mean_acceptance"] = res.mean_acceptance
    elif name == "msm_35_shards":
        import numpy as np

        from .analysis.discretize import discretize_dataset

        rng = np.random.default_rng(index)
        shards = [
            {"features": rng.normal(size=(370, 4)).astype("float32")}
            for _ in range(params["n_shards"])
        ]
        r = discretize_dataset(shards, n_states=50, lag=10)
        result["counted_pairs"] = r.counted_pairs
    elif name == "remd_chignolin":
        from .data import chignolin_path

        path = chignolin_path()
        if path is None:
            result["status"] = "skipped"
            result["reason"] = "no chignolin PDB"
        else:
            from .md.forcefield import build_system
            from .io.pdb import read_pdb
            from .remd.remd import RemdConfig, ReplicaExchange

            system, pos = build_system(read_pdb(path))
            remd = ReplicaExchange(
                system, pos, RemdConfig(n_replicas=4, exchange_frequency=100)
            )
            res = remd.run(n_steps=params["n_steps"])
            result["mean_acceptance"] = res.mean_acceptance
    elif name == "deeptica_train":
        import numpy as np

        from .ml.deeptica import DeepTICAConfig, train_deeptica

        rng = np.random.default_rng(index)
        slow = np.tanh(np.cumsum(rng.normal(size=4000)) * 0.01)
        X = np.stack([slow + 0.1 * rng.normal(size=4000) for _ in range(3)], 1)
        model = train_deeptica(
            X.astype("float32"),
            DeepTICAConfig(lag=5, n_out=1, hidden=(16,), max_epochs=params["epochs"]),
        )
        result["best_vamp2"] = model.training_history["best"]["val_vamp2"]
    elif name == "tpt_conformations":
        import numpy as np

        from .conformations.finder import find_conformations

        T = np.array([
            [0.95, 0.05, 0.00],
            [0.10, 0.80, 0.10],
            [0.00, 0.05, 0.95],
        ])
        cs = find_conformations(T, source=[0], sink=[2])
        result["n_conformations"] = len(cs.conformations)
    (output_dir / f"mode_{index}.json").write_text(json.dumps(result, default=str))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode-index", type=int, required=True)
    parser.add_argument("--output", default="outputs")
    args = parser.parse_args(argv)
    result = run_mode(args.mode_index, Path(args.output))
    print(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
