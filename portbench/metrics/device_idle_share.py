"""device_idle_share (%): 1 - the union of the kernel, copy and fill
intervals on the device over the traced window, from the trace."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
