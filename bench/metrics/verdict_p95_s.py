"""95th percentile of the seconds from an LLM call's submission to the
serving tier to the round that finished it (``ServingStats.ttv_s``),
over every call of the window (nearest rank)."""
import math


def read(run):
    ttv = sorted(run["ttv_s"])
    if not ttv:
        return None
    return ttv[math.ceil(0.95 * len(ttv)) - 1]
