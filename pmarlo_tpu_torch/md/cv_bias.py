"""The DeepTICA CV bias the fused kernels evaluate, as plain PyTorch.

Counterpart of ``pmarlo_tpu/md/pallas_md.py`` ``_bias_consts``,
``_cv_forward`` and ``_bias_planes``: positions -> M dihedrals (cos/sin,
no arctangent) -> standardise -> tanh MLP -> optional whitening -> CVs,
then ``E = k sum cv^2`` (harmonic expansion) or the sum over a hills
ledger (metadynamics), with the gradient written out by hand: back through
the whitening and the layers, ``dE/dphi = -sin g_cos + cos g_sin``, and
the four per-atom dihedral gradients. ``CVBias`` also packs the tables the
CUDA kernel reads (``csrc/fused_md.cu``): the parameter blob and a per-atom
CSR list of (role, dihedral) pairs, which lets every atom sum its own bias
force without atomics. The TPU kernel's one-hot selector matrices have no
counterpart here: atoms are gathered and scattered by index.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

_EPS = 1e-12

#: limits of the kernel's bias work space (``csrc/fused_md.cu``)
MAX_LAYERS = 6
MAX_CV = 8


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class CVBias:
    """Kernel constants and plain twin of the in-kernel CV bias.

    ``model`` is a ``DeepTICAModel`` (tanh MLP on cos/sin dihedral
    features, no layernorm), ``quads`` the ``(M, 4)`` dihedral atom
    indices in feature order. ``kind`` is ``"harmonic"`` (``strength``) or
    ``"metadynamics"`` (``mtd_sigma`` per-CV widths; the ledger is a call
    argument)."""

    def __init__(self, model, quads, *, n_atoms: int, strength: float = 1.0,
                 kind: str = "harmonic", mtd_sigma=None, device="cpu"):
        cfg = model.config
        if cfg.activation != "tanh":
            raise ValueError(
                f"in-kernel bias supports tanh MLPs, got {cfg.activation!r}")
        if cfg.layernorm:
            raise ValueError("in-kernel bias does not support layernorm")
        if kind not in ("harmonic", "metadynamics"):
            raise ValueError(f"bias_kind must be harmonic|metadynamics, got {kind!r}")
        quads = np.asarray(_np(quads), dtype=np.int64).reshape(-1, 4)
        if quads.shape[0] == 0:
            raise ValueError("the CV bias needs at least one dihedral")
        if quads.min() < 0 or quads.max() >= n_atoms:
            raise ValueError(f"dihedral atom indices must lie in [0, {n_atoms})")
        self.kind = kind
        self.strength = float(strength)
        self.n_atoms = int(n_atoms)
        self.n_dihedrals = int(quads.shape[0])
        self.device = torch.device(device)

        def t(a):
            return torch.as_tensor(np.asarray(_np(a), np.float32), device=self.device)

        self.quads = torch.as_tensor(quads, device=self.device)
        self.mu = t(model.scaler_mean)
        self.inv_sigma = t(1.0 / np.asarray(_np(model.scaler_scale), np.float32))
        self.weights: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (t(layer["w"]), t(layer["b"])) for layer in model.params
        ]
        self.widths = [2 * self.n_dihedrals] + [int(w.shape[1]) for w, _ in self.weights]
        if int(self.weights[0][0].shape[0]) != self.widths[0]:
            raise ValueError(
                f"the model takes {int(self.weights[0][0].shape[0])} features, "
                f"{self.n_dihedrals} dihedrals give {self.widths[0]}")
        self.n_cv = self.widths[-1]
        if len(self.weights) > MAX_LAYERS or self.n_cv > MAX_CV:
            raise ValueError(
                f"the kernel takes at most {MAX_LAYERS} layers and {MAX_CV} CVs")
        self.wmean = self.wmat = None
        if model.whitening is not None:
            self.wmean = t(model.whitening["mean"])
            self.wmat = t(model.whitening["transform"])
        self.mtd_inv_sigma = None
        if kind == "metadynamics":
            if mtd_sigma is None:
                raise ValueError("metadynamics bias requires mtd_sigma (per-CV widths)")
            inv = 1.0 / np.asarray(mtd_sigma, np.float64)
            if inv.shape != (self.n_cv,):
                raise ValueError(f"mtd_sigma must hold {self.n_cv} widths")
            self.mtd_inv_sigma = t(inv)

    # --- forward -----------------------------------------------------------------

    def _geometry(self, x: torch.Tensor) -> dict:
        q = self.quads
        p1, p2, p3, p4 = (x[..., q[:, k], :] for k in range(4))
        b1, b2, b3 = p2 - p1, p3 - p2, p4 - p3
        m = torch.cross(b1, b2, dim=-1)
        n = torch.cross(b2, b3, dim=-1)
        lb2 = torch.sqrt((b2 * b2).sum(-1) + _EPS)
        yy = (torch.cross(m, n, dim=-1) * b2).sum(-1) / lb2      # IUPAC sign
        xx = (m * n).sum(-1)
        norm = torch.sqrt(xx * xx + yy * yy + _EPS)
        return {"b1": b1, "b2": b2, "b3": b3, "m": m, "n": n, "lb2": lb2,
                "cos": xx / norm, "sin": yy / norm}

    def _mlp(self, z: torch.Tensor):
        """Raw outputs and the activations of every layer's input."""
        hs = [z]
        h = z
        for w, b in self.weights[:-1]:
            h = torch.tanh(h @ w + b)
            hs.append(h)
        w, b = self.weights[-1]
        return h @ w + b, hs

    def cv(self, x: torch.Tensor) -> torch.Tensor:
        """Positions ``(..., N, 3)`` -> CVs ``(..., n_cv)``."""
        g = self._geometry(x)
        z = (torch.cat([g["cos"], g["sin"]], -1) - self.mu) * self.inv_sigma
        y, _ = self._mlp(z)
        if self.wmat is not None:
            y = (y - self.wmean) @ self.wmat
        return y

    def hills_energy_and_grad(self, y: torch.Tensor, hills):
        """Ledger energy ``(...)`` and its CV gradient ``(..., n_cv)``."""
        inv = self.mtd_inv_sigma
        d = (y[..., None, :] - hills.centers) * inv                  # (..., H, n_cv)
        gauss = torch.exp(-0.5 * (d * d).sum(-1))
        mask = (torch.arange(hills.heights.shape[0], device=y.device)
                < hills.n_hills).to(y.dtype)
        wg = hills.heights * mask * gauss                             # (..., H)
        return wg.sum(-1), -(wg[..., None] * d).sum(-2) * inv

    # --- energy and hand-written forces --------------------------------------------

    def energy_and_forces(self, x: torch.Tensor, hills=None):
        """Bias energies ``(...)`` and forces ``(..., N, 3)`` at ``x``."""
        M = self.n_dihedrals
        g = self._geometry(x)
        cph, sph = g["cos"], g["sin"]
        z = (torch.cat([cph, sph], -1) - self.mu) * self.inv_sigma
        y, hs = self._mlp(z)
        if self.wmat is not None:
            y = (y - self.wmean) @ self.wmat
        if self.kind == "metadynamics":
            if hills is None:
                raise ValueError("the metadynamics bias needs the hills ledger")
            e, grad = self.hills_energy_and_grad(y, hills)
        else:
            e = self.strength * (y * y).sum(-1)
            grad = 2.0 * self.strength * y
        if self.wmat is not None:
            grad = grad @ self.wmat.T
        grad = grad @ self.weights[-1][0].T
        for li in range(len(self.weights) - 2, -1, -1):
            grad = grad * (1.0 - hs[li + 1] * hs[li + 1])
            grad = grad @ self.weights[li][0].T
        grad = grad * self.inv_sigma
        dphi = -sph * grad[..., :M] + cph * grad[..., M:]               # dE/dphi

        b1, b2, b3, m, n, lb2 = (g[k] for k in ("b1", "b2", "b3", "m", "n", "lb2"))
        m2 = (m * m).sum(-1) + _EPS
        n2 = (n * n).sum(-1) + _EPS
        d1 = -(lb2 / m2)[..., None] * m
        d4 = (lb2 / n2)[..., None] * n
        s12 = ((b1 * b2).sum(-1) / (lb2 * lb2))[..., None]
        s32 = ((b3 * b2).sum(-1) / (lb2 * lb2))[..., None]
        d2 = -(1.0 + s12) * d1 + s32 * d4
        d3 = s12 * d1 - (1.0 + s32) * d4
        f = torch.zeros_like(x)
        for k, dk in enumerate((d1, d2, d3, d4)):
            f.index_add_(-2, self.quads[:, k], -dphi[..., None] * dk)
        return e, f

    # --- kernel tables -----------------------------------------------------------------

    def blob(self) -> torch.Tensor:
        """mu, inv_sigma, every layer's ``w (in, out)`` then ``b``, the
        whitening mean and matrix (zeros and identity without whitening)."""
        parts = [self.mu, self.inv_sigma]
        for w, b in self.weights:
            parts += [w.reshape(-1), b]
        if self.wmat is not None:
            parts += [self.wmean, self.wmat.reshape(-1)]
        else:
            parts += [torch.zeros(self.n_cv, device=self.device),
                      torch.eye(self.n_cv, device=self.device).reshape(-1)]
        return torch.cat([p.to(torch.float32) for p in parts]).contiguous()

    def work_floats(self) -> int:
        """Floats of shared memory the kernel's bias work space takes."""
        return (int(self.blob().numel()) + sum(self.widths) + MAX_CV
                + 2 * max(self.widths) + 3 * self.n_dihedrals + 32)

    def dihedral_csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-atom incidence lists: ``ptr (N+1,)`` and ``entries (K, 2)``
        of ``(role, dihedral)``, role = the atom's position in the quad."""
        per_atom = [[] for _ in range(self.n_atoms)]
        for d, atoms in enumerate(self.quads.cpu().numpy()):
            for role, atom in enumerate(atoms):
                per_atom[int(atom)].append((role, d))
        ptr = np.zeros(self.n_atoms + 1, dtype=np.int32)
        ptr[1:] = np.cumsum([len(e) for e in per_atom])
        ent = np.asarray([e for lst in per_atom for e in lst], dtype=np.int32)
        return ptr, ent.reshape(-1, 2)


__all__ = ["CVBias", "MAX_CV", "MAX_LAYERS"]
