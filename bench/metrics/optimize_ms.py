"""Planner: mean host ms of ``optimize`` (catalog included) a query."""


def read(run):
    t = run["optimize_s"]
    return 1e3 * sum(t) / len(t) if t else None
