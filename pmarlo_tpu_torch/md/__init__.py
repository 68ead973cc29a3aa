"""Molecular dynamics: system, force field, forces, integrator, fused kernel."""


def build_pair_force_fn(*args, **kwargs):
    """Lazy re-export of ``md.pair_force.build_pair_force_fn`` (the
    protein-scale pair-kernel force path), as the JAX package's
    ``md.build_pair_force_fn``."""
    from .pair_force import build_pair_force_fn as _fn

    return _fn(*args, **kwargs)


def load_amber_files(*args, **kwargs):
    """Lazy re-export of ``md.amber_params.load_amber_files`` (register
    user-supplied frcmod / parm.dat / OFF .lib parameter files), as the JAX
    package's ``md.load_amber_files``."""
    from .amber_params import load_amber_files as _fn

    return _fn(*args, **kwargs)


__all__ = ["build_pair_force_fn", "load_amber_files"]
