"""Serving tier: mean ms of a decode round (``SlotScheduler._round``
with live slots), between CUDA events."""


def read(run):
    t = run["trace"] and run["trace"]["round_ms"]
    return sum(t) / len(t) if t else None
