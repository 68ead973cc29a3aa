"""DeepTICA: MLP collective variables trained on the VAMP-2 objective.

Port of ``pmarlo_tpu/ml/deeptica.py``. The network is an ``nn.Module``
whose weights are stored ``(in, out)``, the JAX layout (``h @ w + b``), so
a model's arrays pass between the two packages unchanged and
``DeepTICAModel.save``/``load`` use the JAX file format (``.json`` config,
``.weights.npz`` with ``w0, b0, ...``, ``.history.json``): a model saved by
either package loads in the other. Training is ``torch.optim.AdamW`` with
optax's warm-up + cosine schedule evaluated per step, global-norm clipping
before the step, the tau curriculum with a fixed validation tau, and the
best-validation-score parameters restored. ``lax.scan`` over an epoch's
batches is a plain loop here; batches are drawn with
``numpy.random.default_rng(config.seed)`` exactly as in JAX, so the two
trainers see the same batches.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .._device import default_device
from ..features.pairs import segment_lagged_pairs
from ..utils.seed import set_global_seed
from .losses import vamp2_loss, vamp2_score_features
from .whitening import estimate_whitening


@dataclasses.dataclass(frozen=True)
class DeepTICAConfig:
    """(reference _full.py:166; defaults follow constants.py:81-121)."""

    lag: int = 10
    n_out: int = 2
    hidden: Tuple[int, ...] = (64, 64)
    activation: str = "tanh"             # tanh | gelu | relu | elu
    layernorm: bool = False
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 1024
    max_epochs: int = 200
    early_stopping_patience: int = 20
    tau_schedule: Tuple[int, ...] = ()   # curriculum; empty -> (lag,)
    val_tau: Optional[int] = None        # fixed validation tau (default: lag)
    val_fraction: float = 0.2
    vamp_ridge: float = 1e-4
    vamp_alpha: float = 0.05
    grad_clip: float = 10.0
    warmup_epochs: int = 5
    seed: int = 2024
    whitening_shrinkage: float = 0.1

    def __post_init__(self):
        if self.lag < 1:
            raise ValueError("lag must be >= 1")
        if self.n_out < 1:
            raise ValueError("n_out must be >= 1")
        if not (0.0 < self.val_fraction < 0.9):
            raise ValueError("val_fraction must be in (0, 0.9)")
        if self.activation not in ("tanh", "gelu", "relu", "elu"):
            raise ValueError(f"unknown activation {self.activation!r}")

    def schedule(self) -> Tuple[int, ...]:
        return self.tau_schedule if self.tau_schedule else (self.lag,)

    @classmethod
    def small_data(cls, lag: int = 5, **kw) -> "DeepTICAConfig":
        """Preset for small datasets (reference _full.py:214)."""
        defaults = dict(
            lag=lag, hidden=(32, 32), batch_size=256, max_epochs=100,
            vamp_alpha=0.1, learning_rate=5e-4,
        )
        defaults.update(kw)
        return cls(**defaults)


# --- MLP ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: nn.functional.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "elu": nn.functional.elu,
}


def init_mlp_params(
    generator: torch.Generator, n_in: int, hidden: Sequence[int], n_out: int
) -> List[Dict[str, torch.Tensor]]:
    """``sqrt(2 / (a + b)) N(0, 1)`` weights ``(a, b)`` and zero biases."""
    sizes = [n_in, *hidden, n_out]
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        scale = math.sqrt(2.0 / (a + b))
        w = torch.randn((a, b), generator=generator, dtype=torch.float32,
                        device=generator.device)
        params.append({"w": scale * w,
                       "b": torch.zeros(b, dtype=torch.float32, device=generator.device)})
    return params


def mlp_apply(
    params: List[Dict[str, torch.Tensor]],
    x: torch.Tensor,
    activation: str = "tanh",
    layernorm: bool = False,
) -> torch.Tensor:
    act = _ACTIVATIONS[activation]
    h = x
    for layer in params[:-1]:
        h = h @ layer["w"] + layer["b"]
        if layernorm:
            mu = h.mean(dim=-1, keepdim=True)
            sd = torch.sqrt(h.var(dim=-1, keepdim=True, unbiased=False) + 1e-6)
            h = (h - mu) / sd
        h = act(h)
    last = params[-1]
    return h @ last["w"] + last["b"]


class MLP(nn.Module):
    """The DeepTICA network; ``w{i}`` is ``(in, out)`` and ``b{i}`` is
    ``(out,)``, so ``params()`` is the JAX parameter list."""

    def __init__(self, params: List[Dict[str, torch.Tensor]], activation: str = "tanh",
                 layernorm: bool = False):
        super().__init__()
        self.activation = activation
        self.layernorm = layernorm
        self.w = nn.ParameterList(
            [nn.Parameter(layer["w"].detach().clone()) for layer in params])
        self.b = nn.ParameterList(
            [nn.Parameter(layer["b"].detach().clone()) for layer in params])

    def params(self) -> List[Dict[str, torch.Tensor]]:
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params(), x, self.activation, self.layernorm)


# --- model wrapper -------------------------------------------------------------------

def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


@dataclasses.dataclass
class DeepTICAModel:
    """Scaler -> MLP -> output whitening (reference _full.py:283).

    ``params`` is the JAX list ``[{"w": (in, out), "b": (out,)}, ...]`` of
    tensors. ``transform`` maps host arrays; ``as_function`` returns the
    CV as a function of tensors for bias composition."""

    config: DeepTICAConfig
    params: List[Dict[str, torch.Tensor]]
    scaler_mean: np.ndarray
    scaler_scale: np.ndarray
    whitening: Optional[Dict] = None
    training_history: Optional[Dict] = None

    @property
    def device(self) -> torch.device:
        return self.params[0]["w"].device

    def as_function(self, device=None) -> Callable[[torch.Tensor], torch.Tensor]:
        """CV function x (.., K) -> cv (.., n_out) on ``device`` (the
        parameters' device by default), differentiable in x."""
        dev = torch.device(device) if device is not None else self.device
        mean = _to_tensor(self.scaler_mean, dev)
        scale = _to_tensor(self.scaler_scale, dev)
        cfg = self.config
        params = [{k: _to_tensor(v, dev) for k, v in layer.items()}
                  for layer in self.params]
        if self.whitening is not None:
            w_mean = _to_tensor(self.whitening["mean"], dev)
            w_t = _to_tensor(self.whitening["transform"], dev)
        else:
            w_mean = w_t = None

        def fn(x):
            z = (x - mean) / scale
            y = mlp_apply(params, z, cfg.activation, cfg.layernorm)
            if w_t is not None:
                y = (y - w_mean) @ w_t
            return y

        return fn

    def transform(self, X) -> np.ndarray:
        fn = self.as_function()
        x = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            return fn(x).cpu().numpy()

    __call__ = transform

    # --- persistence: the JAX package's file format ---------------------------------

    def save(self, prefix: "str | Path") -> Path:
        prefix = Path(prefix)
        prefix.parent.mkdir(parents=True, exist_ok=True)
        cfg = dataclasses.asdict(self.config)
        cfg["hidden"] = list(cfg["hidden"])
        cfg["tau_schedule"] = list(cfg["tau_schedule"])
        (prefix.with_suffix(".json")).write_text(json.dumps(cfg, indent=2))
        arrays = {"scaler_mean": np.asarray(self.scaler_mean),
                  "scaler_scale": np.asarray(self.scaler_scale)}
        for i, layer in enumerate(self.params):
            arrays[f"w{i}"] = layer["w"].detach().cpu().numpy()
            arrays[f"b{i}"] = layer["b"].detach().cpu().numpy()
        if self.whitening is not None:
            arrays["whitening_mean"] = np.asarray(self.whitening["mean"])
            arrays["whitening_transform"] = np.asarray(self.whitening["transform"])
        np.savez(prefix.with_suffix(".weights.npz"), **arrays)
        if self.training_history is not None:
            from ..utils.json_io import write_json

            write_json(prefix.with_suffix(".history.json"), self.training_history)
        return prefix

    @classmethod
    def load(cls, prefix: "str | Path", device=None) -> "DeepTICAModel":
        """The model saved at ``prefix``, on ``device`` (``device=None``:
        ``_device.default_device()``)."""
        prefix = Path(prefix)
        cfg_d = json.loads(prefix.with_suffix(".json").read_text())
        with np.load(prefix.with_suffix(".weights.npz")) as data:
            params = []
            i = 0
            while f"w{i}" in data:
                params.append({"w": data[f"w{i}"], "b": data[f"b{i}"]})
                i += 1
            whitening = None
            if "whitening_mean" in data:
                whitening = {"mean": data["whitening_mean"],
                             "transform": data["whitening_transform"]}
            scaler_mean = np.asarray(data["scaler_mean"])
            scaler_scale = np.asarray(data["scaler_scale"])
        history = None
        hist_path = prefix.with_suffix(".history.json")
        if hist_path.exists():
            history = json.loads(hist_path.read_text())
        model = deeptica_from_numpy(cfg_d, params, scaler_mean, scaler_scale,
                                    whitening, device=device)
        model.training_history = history
        return model


def deeptica_from_numpy(config, params, scaler_mean, scaler_scale, whitening=None,
                        device=None) -> DeepTICAModel:
    """A ``DeepTICAModel`` from host arrays, e.g. the fields of a model the
    JAX package trained: ``config`` a ``DeepTICAConfig`` or its dict,
    ``params`` the list ``[{"w": (in, out), "b": (out,)}, ...]``,
    ``whitening`` a dict with ``mean`` and ``transform`` or None. The
    weights go to ``device`` (``None``: ``_device.default_device()``)."""
    device = torch.device(device) if device is not None else default_device()
    if not isinstance(config, DeepTICAConfig):
        cfg_d = dict(config)
        cfg_d["hidden"] = tuple(cfg_d["hidden"])
        cfg_d["tau_schedule"] = tuple(cfg_d["tau_schedule"])
        config = DeepTICAConfig(**cfg_d)
    if whitening is not None:
        whitening = {
            "mean": np.asarray(whitening["mean"]),
            "transform": np.asarray(whitening["transform"]),
            "applied": True,
        }
    return DeepTICAModel(
        config=config,
        params=[{"w": _to_tensor(layer["w"], device), "b": _to_tensor(layer["b"], device)}
                for layer in params],
        scaler_mean=np.asarray(scaler_mean),
        scaler_scale=np.asarray(scaler_scale),
        whitening=whitening,
    )


# --- training --------------------------------------------------------------------------

def _fit_scaler(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mean = X.mean(axis=0)
    scale = X.std(axis=0)
    scale[scale < 1e-8] = 1.0
    return mean, scale


def warmup_cosine_lr(step: int, *, init_value: float, peak_value: float,
                     warmup_steps: int, decay_steps: int, end_value: float) -> float:
    """``optax.warmup_cosine_decay_schedule`` at ``step``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    from ``peak_value`` to ``end_value`` that ends at ``decay_steps``
    counted from step 0 (the warm-up is inside ``decay_steps``)."""
    if step < warmup_steps:
        frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
        return (init_value - peak_value) * frac + peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    count = min(step - warmup_steps, span)
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / span))
    alpha = end_value / peak_value
    return peak_value * ((1.0 - alpha) * cosine + alpha)


def train_deeptica(
    X_list: "np.ndarray | Sequence[np.ndarray]",
    config: Optional[DeepTICAConfig] = None,
    *,
    weights: Optional[Sequence[np.ndarray]] = None,
    progress_dir: Optional["str | Path"] = None,
    device=None,
) -> DeepTICAModel:
    """Train DeepTICA on one or more feature trajectories, on ``device``
    (``None``: the card when there is one).

    Pipeline: seed -> scaler -> net init -> tau-curriculum training with a
    fixed validation tau on a time-ordered split -> best-state restore ->
    output whitening -> history with VAMP-2 before/after. ``weights`` is
    accepted and unused, as in the JAX trainer."""
    config = config or DeepTICAConfig()
    dev = torch.device(device) if device is not None else default_device()
    if isinstance(X_list, torch.Tensor):
        X_list = [X_list.detach().cpu().numpy()]
    elif isinstance(X_list, np.ndarray) or hasattr(X_list, "shape"):
        X_list = [np.asarray(X_list)]
    X_list = [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                         dtype=np.float32) for x in X_list]
    if any(x.ndim != 2 for x in X_list):
        raise ValueError("each trajectory must be (T, K)")
    gen = set_global_seed(config.seed, device=dev)

    X_all = np.concatenate(X_list, axis=0)
    mean, scale = _fit_scaler(X_all)
    Z_list = [(x - mean) / scale for x in X_list]

    # time-ordered train/val split per trajectory (reference trainer.py:1103)
    train_seqs, val_seqs = [], []
    for z in Z_list:
        cut = max(int(len(z) * (1.0 - config.val_fraction)), 2)
        train_seqs.append(z[:cut])
        val_seqs.append(z[cut:])
    val_tau = config.val_tau or config.lag

    n_in = X_all.shape[1]
    cfg = config
    net = MLP(init_mlp_params(gen, n_in, config.hidden, config.n_out),
              cfg.activation, cfg.layernorm).to(dev)

    # optimizer: AdamW + warmup+cosine (reference trainer.py:960) + clip
    steps_per_epoch = max(
        sum(max(len(z) - min(config.schedule()), 0) for z in train_seqs)
        // config.batch_size, 1,
    )
    total_steps = steps_per_epoch * config.max_epochs * len(config.schedule())
    warmup_steps = config.warmup_epochs * steps_per_epoch
    schedule = dict(
        init_value=config.learning_rate * 0.01, peak_value=config.learning_rate,
        warmup_steps=warmup_steps, decay_steps=max(total_steps, warmup_steps + 1),
        end_value=config.learning_rate * 0.01,
    )
    # optax.adamw: eps 1e-8, decay on every parameter, lr from the schedule
    opt = torch.optim.AdamW(net.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=config.weight_decay)
    opt_step = 0

    def set_lr(step: int) -> None:
        lr = warmup_cosine_lr(step, **schedule)
        for group in opt.param_groups:
            group["lr"] = lr

    def batch_loss(z0, zt):
        return vamp2_loss(net(z0), net(zt), ridge=cfg.vamp_ridge, alpha=cfg.vamp_alpha)

    def eval_score(z0, zt) -> float:
        with torch.no_grad():
            return float(batch_loss(z0, zt)[1]["vamp2"])

    def gather_pairs(seqs, tau):
        lengths = [len(s) for s in seqs]
        i, j = segment_lagged_pairs(lengths, tau)
        Z = np.concatenate(seqs, axis=0) if seqs else np.zeros((0, n_in))
        return Z[i], Z[j]

    def on_device(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    # baseline VAMP-2 on raw scaled features (reference trainer_api vamp2_proxy)
    z0_b, zt_b = gather_pairs(train_seqs, config.lag)
    vamp2_before = (
        vamp2_score_features(z0_b[:8192], zt_b[:8192], device=dev)
        if len(z0_b) > 10 else float("nan")
    )

    val_z0, val_zt = gather_pairs(val_seqs, val_tau)
    has_val = len(val_z0) > config.n_out + 2
    if has_val:
        val_z0, val_zt = on_device(val_z0), on_device(val_zt)

    history: Dict = {
        "epochs": [], "tau_schedule": list(config.schedule()),
        "val_tau": val_tau, "vamp2_before": vamp2_before,
    }

    def snapshot():
        return [{k: v.detach().clone() for k, v in layer.items()} for layer in net.params()]

    best = {"score": -np.inf, "params": snapshot(), "epoch": -1, "tau": None}
    rng = np.random.default_rng(config.seed)
    t_start = time.time()
    progress_path = Path(progress_dir) / "training_progress.json" if progress_dir else None

    for tau in config.schedule():
        z0_all, zt_all = gather_pairs(train_seqs, tau)
        if len(z0_all) < config.batch_size // 4:
            raise ValueError(
                f"too few training pairs ({len(z0_all)}) at tau={tau}"
            )
        patience_left = config.early_stopping_patience
        bs = min(config.batch_size, len(z0_all))
        n_batches = max(len(z0_all) // bs, 1)
        z0_dev, zt_dev = on_device(z0_all), on_device(zt_all)
        for epoch in range(config.max_epochs):
            perm = torch.as_tensor(
                rng.permutation(len(z0_all))[: n_batches * bs], device=dev)
            z0_b = z0_dev[perm].reshape(n_batches, bs, -1)
            zt_b = zt_dev[perm].reshape(n_batches, bs, -1)
            losses = []
            for b in range(n_batches):
                set_lr(opt_step)
                opt.zero_grad(set_to_none=True)
                loss, metrics = batch_loss(z0_b[b], zt_b[b])
                loss.backward()
                # clip first, then the AdamW step (optax.chain order)
                gnorm = nn.utils.clip_grad_norm_(net.parameters(), config.grad_clip)
                opt.step()
                opt_step += 1
                losses.append(loss.detach())
            mean_loss = float(torch.stack(losses).mean())
            if has_val:
                val_score = eval_score(val_z0, val_zt)
            else:
                val_score = -mean_loss
            record = {
                "tau": int(tau), "epoch": int(epoch),
                "train_loss": mean_loss,
                "val_vamp2": val_score,
                "cond_C00": float(metrics["cond_C00"]),
                "grad_norm": float(gnorm),
                "wall_time_s": time.time() - t_start,
            }
            history["epochs"].append(record)
            if progress_path is not None:
                from ..utils.json_io import write_json

                write_json(progress_path, {"status": "training", **record})
            if val_score > best["score"]:
                best = {"score": val_score, "params": snapshot(),
                        "epoch": epoch, "tau": int(tau)}
                patience_left = config.early_stopping_patience
            else:
                patience_left -= 1
                if patience_left <= 0:
                    break

    params = best["params"]
    history["best"] = {"val_vamp2": best["score"], "epoch": best["epoch"], "tau": best["tau"]}

    # output whitening from full-data outputs (reference core/model.py:152)
    model = DeepTICAModel(
        config=config, params=params, scaler_mean=mean, scaler_scale=scale,
    )
    Y = model.transform(X_all)
    model.whitening = estimate_whitening(Y, shrinkage=config.whitening_shrinkage)

    # VAMP-2 after training (on whitened outputs at the training lag)
    y_list = [model.transform(x) for x in X_list]
    y0, yt = gather_pairs([y.astype(np.float32) for y in y_list], config.lag)
    vamp2_after = (
        vamp2_score_features(y0[:8192], yt[:8192], device=dev)
        if len(y0) > 10 else float("nan")
    )
    history["vamp2_after"] = vamp2_after
    history["wall_time_s"] = time.time() - t_start
    model.training_history = history
    if progress_path is not None:
        from ..utils.json_io import write_json

        write_json(progress_path, {"status": "completed", **history["best"]})
    return model


__all__ = [
    "DeepTICAConfig",
    "DeepTICAModel",
    "MLP",
    "deeptica_from_numpy",
    "train_deeptica",
    "init_mlp_params",
    "mlp_apply",
    "warmup_cosine_lr",
]
