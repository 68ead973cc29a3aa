"""Virtual interaction sites: massless particles on parent-defined positions.

Port of ``pmarlo_tpu/md/vsites.py``. A site's position is a function of
three parent atoms:

* kind 0, the three-particle average (TIP4P-Ew's M):
  ``r = w0 r_p0 + w1 r_p1 + w2 r_p2``, linear;
* kind 1, out of plane (TIP5P's lone pairs L1 / L2, OpenMM semantics):
  with ``d12 = r_p1 - r_p0`` and ``d13 = r_p2 - r_p0``,
  ``r = r_p0 + w0 d12 + w1 d13 + w2 (d12 x d13)``.

A force evaluation expands the sites from their parents before the sweep
and spreads each site's force onto its parents after it (``spread``, the
exact transpose of the expansion's Jacobian, in closed form: for kind 1,
``w2 (d13 x f)`` to parent 1 and ``w2 (f x d12)`` to parent 2 on top of the
linear weights ``(1 - w0 - w1, w0, w1)``). Sites carry charge (and no LJ)
in the nonbonded sweeps like any atom, and zero mass: the integrator gives
them no kick, no noise and no kinetic degree of freedom, and re-derives
them after every position update.

Everything is tensor operations on the positions' device (gathers, one
``index_add`` and one ``index_fill``): nothing is read back to the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class VirtualSites:
    """The sites of one system, with their index and weight tensors kept on
    the device: ``idx (V, 4)`` [site, p0, p1, p2], ``w (V, 3)`` and ``kind
    (V,)`` or None (all kind 0)."""

    def __init__(self, idx: torch.Tensor, w: torch.Tensor, kind: Optional[torch.Tensor] = None):
        idx = idx.long()
        self.site = idx[:, 0].contiguous()
        self.parents = idx[:, 1:4].contiguous()
        self.flat_parents = self.parents.reshape(-1)
        self.w = w
        oop = None if kind is None else (kind == 1)
        self.oop = oop
        # the spread's per-parent coefficients (V, 3) and the cross term's
        # weight (V,): kind 0 (w0, w1, w2) and 0; kind 1 (1 - w0 - w1, w0, w1)
        # and w2
        if oop is None:
            self.coef, self.wcross = w, None
        else:
            lin = torch.stack([1.0 - w[:, 0] - w[:, 1], w[:, 0], w[:, 1]], -1)
            self.coef = torch.where(oop[:, None], lin, w)
            self.wcross = torch.where(oop, w[:, 2], torch.zeros_like(w[:, 2]))

    @classmethod
    def from_system(cls, system) -> "Optional[VirtualSites]":
        """The system's sites, or None when it has none."""
        idx = getattr(system, "vsite_idx", None)
        if idx is None or idx.shape[0] == 0:
            return None
        return cls(idx, system.vsite_weights, getattr(system, "vsite_kind", None))

    @property
    def n_sites(self) -> int:
        return int(self.site.shape[0])

    def _parents(self, x: torch.Tensor):
        p = x.index_select(-2, self.flat_parents).unflatten(-2, (self.n_sites, 3))
        return p[..., 0, :], p[..., 1, :], p[..., 2, :]

    def positions(self, x: torch.Tensor) -> torch.Tensor:
        """The site rows ``(..., V, 3)`` derived from the parents in ``x``."""
        w = self.w.to(x.dtype)
        p0, p1, p2 = self._parents(x)
        r = w[:, 0:1] * p0 + w[:, 1:2] * p1 + w[:, 2:3] * p2
        if self.oop is not None:
            d12 = p1 - p0
            d13 = p2 - p0
            r_oop = (p0 + w[:, 0:1] * d12 + w[:, 1:2] * d13
                     + w[:, 2:3] * torch.linalg.cross(d12, d13))
            r = torch.where(self.oop[:, None], r_oop, r)
        return r

    def expand(self, x: torch.Tensor) -> torch.Tensor:
        """``x (..., N, 3)`` with every site row overwritten by its
        parent-defined position (differentiable: autograd through it is the
        spread)."""
        return x.index_copy(-2, self.site, self.positions(x))

    def spread(self, f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Forces ``f (..., N, 3)`` with each site's force moved onto its
        parents (the transpose of ``expand``'s Jacobian at the expanded
        positions ``x``) and the site rows zeroed."""
        fs = f.index_select(-2, self.site)                       # (..., V, 3)
        coef = self.coef.to(f.dtype)
        add = coef[:, :, None] * fs[..., :, None, :]             # (..., V, 3, 3)
        if self.wcross is not None:
            p0, p1, p2 = self._parents(x)
            wc = self.wcross.to(f.dtype)[:, None]
            t1 = wc * torch.linalg.cross(p2 - p0, fs)            # to parent 1
            t2 = wc * torch.linalg.cross(fs, p1 - p0)            # to parent 2
            add = add + torch.stack([-(t1 + t2), t1, t2], -2)
        out = f.index_fill(-2, self.site, 0.0)
        return out.index_add(-2, self.flat_parents, add.flatten(-3, -2))


def vsite_positions(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                    kind: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` with the site rows overwritten by their parent-defined
    positions. ``idx (V, 4)`` int [site, p0, p1, p2], ``w (V, 3)``, ``kind
    (V,)`` int (0 average, 1 out of plane) or None (all average). Leading
    dimensions of ``x`` batch."""
    return VirtualSites(idx, w, kind).expand(x)


def vsite_spread(f: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 kind: Optional[torch.Tensor] = None,
                 x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Site forces moved onto their parents (``vsite_positions``' Jacobian
    transposed) and the site rows zeroed. Out-of-plane sites need ``x``,
    the positions the forces were evaluated at (their Jacobian depends on
    them)."""
    if kind is not None and x is None:
        raise ValueError(
            "vsite_spread with out-of-plane sites needs the positions the forces "
            "were evaluated at (the Jacobian is position-dependent)")
    return VirtualSites(idx, w, kind).spread(f, x)


def expanded_energy_and_forces(system, x: torch.Tensor, bias_fn: Optional[Callable] = None):
    """``(energy, forces)`` of ``potential_energy(system, expand(x),
    bias_fn)`` by autograd (detached): the expansion composed into the
    energy, so the forces on the parents hold the spread and the site rows
    get none. Without sites it is ``energy_and_forces_autograd``."""
    from .forces import potential_energy

    vs = VirtualSites.from_system(system)
    with torch.enable_grad():
        y = x.detach().requires_grad_(True)
        e = potential_energy(system, y if vs is None else vs.expand(y), bias_fn)
        (g,) = torch.autograd.grad(e.sum(), y)
    return e.detach(), -g


#: attributes of a force function that a wrapper carries over untouched
_METADATA = ("pme_mesh_shape", "pme_order", "grid", "electrostatics", "phys", "mesh")


def wrap_force_fn(fn: Callable, system) -> Callable:
    """``fn`` made site-correct: the sites re-derived from their parents
    before each evaluation and their forces spread onto the parents after
    it, on every entry point ``fn`` has (``__call__``, ``init_state`` /
    ``apply``, the batched and the ``dynamic`` entries of a cell force).
    Returns ``fn`` itself when the system has no sites, or when ``fn``
    handles them already (the periodic and cell forces do,
    ``expands_vsites``)."""
    vs = VirtualSites.from_system(system)
    if vs is None or getattr(fn, "expands_vsites", False):
        return fn

    def wrapped(x):
        xf = vs.expand(x)
        e, f = fn(xf)
        return e, vs.spread(f, xf)

    def stateful(apply):
        def _apply(x, st, *box):
            xf = vs.expand(x)
            e, f, st = apply(xf, st, *box)
            return e, vs.spread(f, xf), st
        return _apply

    def binning(init):
        return lambda x, *box: init(vs.expand(x), *box)

    for init, apply in (("init_state", "apply"), ("init_state_batched", "apply_batched"),
                        ("init_state_dynamic", "apply_dynamic")):
        if hasattr(fn, init):
            setattr(wrapped, init, binning(getattr(fn, init)))
            setattr(wrapped, apply, stateful(getattr(fn, apply)))
    if hasattr(fn, "dynamic"):
        def _dynamic(x, box):
            xf = vs.expand(x)
            e, f = fn.dynamic(xf, box)
            return e, vs.spread(f, xf)

        wrapped.dynamic = _dynamic
    for attr in _METADATA:
        if hasattr(fn, attr):
            setattr(wrapped, attr, getattr(fn, attr))
    wrapped.expands_vsites = True
    return wrapped


def n_vsites(system) -> int:
    idx = getattr(system, "vsite_idx", None)
    return 0 if idx is None else int(idx.shape[0])


__all__ = ["VirtualSites", "expanded_energy_and_forces", "n_vsites", "vsite_positions",
           "vsite_spread", "wrap_force_fn"]
