"""Molecular dynamics: system, force field, forces, integrator, fused kernel."""
