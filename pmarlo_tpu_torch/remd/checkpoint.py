"""REMD checkpoint/resume: replica states, PRNG streams and hills in one file.

Port of ``pmarlo_tpu/remd/checkpoint.py``. A checkpoint is an ``.npz`` with
the sampler's arrays and a JSON ``metadata`` entry; the layout, ``_FORMAT``,
the field names and the physics-mode check are JAX's, so that either
package reads the other's positions, velocities, ``replica_ids``,
``ladder``, ``step`` and hills.

**PRNG fields.** The JAX package keeps PRNG keys (``keys``, ``swap_key``);
the port keeps Philox seeds, one a replica, the swap stream's seed in the
config and its attempt counter. A key is not a seed, so neither is read as
the other: the port writes its streams as ``seeds`` and ``swap_attempts``
and records ``"prng": "philox4x32-10"`` in the metadata. It also writes
``keys`` = PRNGKey(seed) of each replica's seed and ``swap_key`` =
PRNGKey(config seed) (the words ``[0, seed]``), so that the JAX package's
loader opens the file and starts streams keyed by the same numbers.
``load_checkpoint`` continues a Philox checkpoint's streams as they were
(``seed=`` re-keys them, ``md.simulation.fold_seed``); a checkpoint of
another stream (the JAX package's, which records no ``prng``) raises
unless ``seed=`` starts new streams.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..bias.metadynamics import MetaDState, metad_state_from_numpy
from ..md.integrate import MDState
from .remd import RemdConfig, ReplicaExchange

_FORMAT = "pmarlo_tpu.remd_checkpoint.v1"
#: the ``prng`` metadata entry of the port's checkpoints
PHILOX = "philox4x32-10"


def _prng_key(seed) -> np.ndarray:
    """The raw words of JAX's ``PRNGKey(seed)`` for 32-bit seeds."""
    seed = np.asarray(seed, np.int64) & 0xFFFFFFFF
    return np.stack([np.zeros_like(seed), seed], axis=-1).astype(np.uint32)


def save_checkpoint(
    remd: ReplicaExchange,
    path: "str | Path",
    *,
    hills: Optional[MetaDState] = None,
    extra: Optional[dict] = None,
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    seeds = remd.state.seeds.cpu().numpy()
    arrays = {
        "positions": remd.state.positions.cpu().numpy(),
        "velocities": remd.state.velocities.cpu().numpy(),
        "keys": _prng_key(seeds),
        "step": np.full(remd.n_replicas, remd.state.step, np.int32),
        "replica_ids": remd.replica_ids.cpu().numpy(),
        "swap_key": _prng_key(remd.config.seed),
        "ladder": remd.ladder.cpu().numpy(),
        "seeds": seeds,
        "swap_attempts": np.asarray(remd._attempts_done, np.int64),
    }
    if hills is not None:
        arrays["hills_centers"] = hills.centers.cpu().numpy()
        arrays["hills_heights"] = hills.heights.cpu().numpy()
        arrays["hills_n"] = hills.n_hills.cpu().numpy()
    meta = {
        "format": _FORMAT,
        "prng": PHILOX,
        "config": {
            "temperatures": list(map(float, remd.config.ladder())),
            "exchange_frequency": remd.config.exchange_frequency,
            "dt_ps": remd.config.dt_ps,
            "friction_per_ps": remd.config.friction_per_ps,
            "report_interval": remd.config.report_interval,
            "seed": remd.config.seed,
        },
        # which physics the run used: a resume must supply the same modes
        # (JAX's names; use_pallas / has_pallas_bias are the fused kernel
        # and its in-kernel bias)
        "modes": {
            "has_force_fn_override": remd._force_fn_is_override,
            "has_constraints": remd._constraints is not None,
            "has_bias_fn": remd.bias_fn is not None,
            "use_pallas": bool(remd.use_kernel),
            "has_pallas_bias": remd._kernel_bias is not None,
        },
        "extra": extra or {},
    }
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, metadata=json.dumps(meta), **arrays)
    tmp.replace(path)
    return path


def load_checkpoint(
    path: "str | Path",
    system,
    *,
    bias_fn=None,
    mesh=None,
    force_fn=None,
    constraints=None,
    use_kernel: bool = False,
    kernel_bias=None,
    seed: Optional[int] = None,
    device=None,
) -> Tuple[ReplicaExchange, Optional[MetaDState], dict]:
    """Reconstruct a ``ReplicaExchange`` (and the hills ledger) from a
    checkpoint, on ``device`` (``None``: the system's).

    The caller must supply the physics modes the run used (force function
    override, constraints, bias, fused kernel and its bias); a mismatch
    raises. ``seed`` re-keys a Philox checkpoint's streams, and is needed to
    start new streams from a checkpoint of another PRNG (the JAX
    package's keys); ``mesh`` is ROADMAP queue A13 and raises."""
    if mesh is not None:
        raise NotImplementedError("mesh: multi-device REMD is ROADMAP queue A13")
    path = Path(path)
    with np.load(path) as data:
        meta = json.loads(str(data["metadata"]))
        if meta.get("format") != _FORMAT:
            raise ValueError(f"{path} is not a REMD checkpoint ({meta.get('format')})")
        modes = meta.get("modes", {})
        supplied = {
            "has_force_fn_override": force_fn is not None,
            "has_constraints": constraints is not None,
            "has_bias_fn": bias_fn is not None,
            "use_pallas": bool(use_kernel),
            "has_pallas_bias": kernel_bias is not None,
        }
        mismatched = {
            k: (modes[k], supplied[k])
            for k in supplied
            if k in modes and bool(modes[k]) != supplied[k]
        }
        if mismatched:
            raise ValueError(
                f"checkpoint {path.name} was written with different physics "
                f"modes than supplied (saved vs supplied): {mismatched} — "
                "pass the same force_fn/constraints/bias/kernel options the "
                "original run used"
            )
        stream = meta.get("prng", "jax")
        if stream != PHILOX and seed is None:
            raise ValueError(
                f"checkpoint {path.name} carries {stream!r} PRNG keys, which "
                "cannot continue the port's Philox streams: pass seed= to "
                "resume it with new noise and swap streams")
        cfg_d = meta["config"]
        config = RemdConfig(
            temperatures=tuple(cfg_d["temperatures"]),
            exchange_frequency=int(cfg_d["exchange_frequency"]),
            dt_ps=float(cfg_d["dt_ps"]),
            friction_per_ps=float(cfg_d["friction_per_ps"]),
            report_interval=int(cfg_d["report_interval"]),
            seed=int(cfg_d["seed"]) if stream == PHILOX else int(seed),
        )
        positions = torch.as_tensor(np.asarray(data["positions"], np.float32))
        remd = ReplicaExchange(
            system, positions[0], config, device=device, use_kernel=use_kernel,
            minimize=False, force_fn=force_fn, constraints=constraints,
            bias_fn=bias_fn, kernel_bias=kernel_bias,
        )
        dev = remd.device
        if stream == PHILOX:
            seeds = torch.as_tensor(np.asarray(data["seeds"], np.int32), device=dev)
            if seed is not None:
                from ..md.simulation import fold_seed

                seeds = fold_seed(seeds, seed)
            remd._attempts_done = int(data["swap_attempts"])
        else:
            # new streams, drawn as a fresh ReplicaExchange draws them
            seeds = remd.state.seeds
        remd.state = MDState(
            positions=positions.to(dev),
            velocities=torch.as_tensor(np.asarray(data["velocities"], np.float32),
                                       device=dev),
            seeds=seeds,
            step=int(np.asarray(data["step"]).reshape(-1)[0]),
        )
        remd.replica_ids = torch.as_tensor(np.asarray(data["replica_ids"], np.int32),
                                           device=dev)
        hills = None
        if "hills_centers" in data:
            hills = metad_state_from_numpy(data["hills_centers"], data["hills_heights"],
                                           data["hills_n"], device=dev)
        return remd, hills, meta.get("extra", {})


__all__ = ["PHILOX", "load_checkpoint", "save_checkpoint"]
