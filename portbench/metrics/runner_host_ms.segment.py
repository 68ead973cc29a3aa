"""runner_host_ms.segment (ms): the traced window's time in which the device
ran nothing, over the segments run, where each segment is one launch
(``ReplicaExchange.run_fused``): its argument checks, the result to host
numpy, the ``RemdResult``."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or ctx["segments"] < 1:
        return None
    return 1e3 * (tr["window_s"] - tr["busy_s"]) / ctx["segments"]
