"""Serving tier: mean ms of a ``SlotScheduler._admit`` call that
admitted, between CUDA events."""


def read(run):
    t = run["trace"] and run["trace"]["admit_ms"]
    return sum(t) / len(t) if t else None
