"""Visualization: matplotlib statics + first-party interactive HTML
(reference: src/pmarlo/visualization/, markov_state_model/_plots.py
incl. its plotly interactive mode, _tpt_viz.py,
conformations/visualizations.py).

Host copy of ``pmarlo_tpu/visualization/__init__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from .interactive import fes_html, its_html, lines_html
from .plots import (
    plot_fes,
    plot_its,
    plot_ck,
    plot_ramachandran,
    plot_committors,
    plot_flux_network,
    plot_acceptance_matrix,
    plot_sampling_validation,
    plot_frames_per_shard,
)

__all__ = [
    "fes_html",
    "its_html",
    "lines_html",
    "plot_fes",
    "plot_its",
    "plot_ck",
    "plot_ramachandran",
    "plot_committors",
    "plot_flux_network",
    "plot_acceptance_matrix",
    "plot_sampling_validation",
    "plot_frames_per_shard",
]
