"""PLUMED interop: export a trained DeepTICA CV for external engines.

Port of ``pmarlo_tpu/ml/plumed.py``. A user who carries a trained CV to an
external engine (GROMACS or OpenMM with PLUMED) needs it as TorchScript
and a PLUMED input that loads it. Here the CV already is PyTorch: the
export is the model's own network (``ml.deeptica.MLP``) between the input
scaler and the output whitening, traced on the CPU in float32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from .deeptica import MLP


class DeepTICAModule(nn.Module):
    """Scaler -> MLP -> optional output whitening, as ``DeepTICAModel``
    evaluates it, with every weight on the CPU."""

    def __init__(self, model):
        super().__init__()

        def cpu(a):
            if isinstance(a, torch.Tensor):
                return a.detach().to("cpu", torch.float32)
            return torch.as_tensor(np.asarray(a, np.float32))

        cfg = model.config
        self.register_buffer("mean", cpu(model.scaler_mean))
        self.register_buffer("scale", cpu(model.scaler_scale))
        self.mlp = MLP([{k: cpu(v) for k, v in layer.items()} for layer in model.params],
                       cfg.activation, cfg.layernorm)
        self.whiten = model.whitening is not None
        if self.whiten:
            self.register_buffer("w_mean", cpu(model.whitening["mean"]))
            self.register_buffer("w_t", cpu(model.whitening["transform"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp((x - self.mean) / self.scale)
        if self.whiten:
            y = (y - self.w_mean) @ self.w_t
        return y


def to_torchscript(model, path: "str | Path") -> Path:
    """Trace the CV to TorchScript at ``path`` with the suffix ``.ts``;
    returns that path."""
    mod = DeepTICAModule(model).eval()
    example = torch.zeros(1, int(np.asarray(model.scaler_mean).shape[0]), dtype=torch.float32)
    with torch.no_grad():
        ts = torch.jit.trace(mod, example)
    out = Path(path).with_suffix(".ts")
    out.parent.mkdir(parents=True, exist_ok=True)
    ts.save(str(out))
    return out


def plumed_snippet(model, model_path: "str | Path") -> str:
    """PLUMED input lines that load the TorchScript export: a
    ``PYTORCH_MODEL`` line and one CV a network output."""
    ts = Path(model_path).with_suffix(".ts").name
    lines = [f"PYTORCH_MODEL FILE={ts} LABEL=mlcv"]
    for i in range(int(model.config.n_out)):
        lines.append(f"CV VALUE=mlcv.node-{i}")
    return "\n".join(lines) + "\n"


__all__ = ["DeepTICAModule", "plumed_snippet", "to_torchscript"]
