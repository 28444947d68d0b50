"""Semantic tier: backend calls (``ModelBackend.calls``) a query."""


def read(run):
    return run["backend_calls"] / run["queries"] if run["queries"] else None
