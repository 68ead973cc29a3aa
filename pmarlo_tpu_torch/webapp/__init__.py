"""Analysis dashboard (the reference's Streamlit ``pmarlo_webapp``).

The reference shipped a Streamlit app with sampling / training / MSM-FES
tabs over a run directory (CHANGELOG.md: ``pmarlo_webapp/app/tabs/
msm_fes.py``, ``app/backend/{sampling,training,analysis}.py``). Streamlit
is not a baked-in dependency here, so the rebuild is dependency-free:
artifacts saved by ``EnhancedMSM.save_analysis_results`` render to a
single self-contained HTML page (plots embedded as base64 PNGs), served
by a stdlib ``http.server`` or exported statically.

Usage::

    python -m pmarlo_tpu_torch.webapp RUN_DIR               # serve on :8501
    python -m pmarlo_tpu_torch.webapp RUN_DIR --export out.html

Host copy of ``pmarlo_tpu/webapp/__init__.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from .app import RunArtifacts, export_static, render_html, serve

__all__ = ["RunArtifacts", "export_static", "render_html", "serve"]
