"""Seconds an analyst waits for a semantic SQL query: the window's wall
time over the queries it completed (whole passes only), each from
``optimize`` to materialized rows."""


def read(run):
    return run["window_s"] / run["queries"] if run["queries"] else None
