"""md_roofline (%): the least time of the traced window's steps
(``portbench/roofline.py``: each unordered pair of every step's force
evaluation once, the CV bias where the cell has it, state and frames in and
out once) over the device time of the window's step kernels
(``csrc/fused_md.cu``'s ``fused_md*`` / ``fused_remd*``, from the trace)."""

from portbench.roofline import md_bound


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["md_kernel_s"] <= 0.0:
        return None
    s = ctx["session"]
    kw = {}
    if s.bias is not None:
        kw = {"n_dih": len(s.bias["quads"]), "widths": s.bias["widths"]}
    b = md_bound(s.R, s.N, ctx["steps"], frames=ctx["frames"], **kw)
    return 100.0 * b["bound_ms"] * 1e-3 / tr["md_kernel_s"]
