"""Device: share of the traced window in which no kernel, copy or set
ran (the union of the profiler's device records), in %."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"]:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
