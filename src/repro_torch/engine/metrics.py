"""Result-quality metrics: per-query F1 of result record sets (paper §6.1).

Records are compared as multisets of hashable (column, value) tuples over
the *common* columns of reference and candidate outputs, with floats
rounded — mirroring how the paper scores each system's rows against the
DuckDB + Cache reference output.
"""
from __future__ import annotations

from collections import Counter
from typing import Sequence


def _canon(rec: dict, cols: Sequence[str]) -> tuple:
    out = []
    for c in sorted(cols):
        v = rec.get(c)
        if isinstance(v, float):
            v = round(v, 4)
        out.append((c, v))
    return tuple(out)


def result_f1(reference: list[dict], candidate: list[dict]) -> float:
    if not reference and not candidate:
        return 1.0
    if not reference or not candidate:
        return 0.0
    cols = set(reference[0].keys()) & set(candidate[0].keys())
    if not cols:
        return 0.0
    ref = Counter(_canon(r, cols) for r in reference)
    cand = Counter(_canon(r, cols) for r in candidate)
    tp = sum((ref & cand).values())
    if tp == 0:
        return 0.0
    precision = tp / sum(cand.values())
    recall = tp / sum(ref.values())
    return 2 * precision * recall / (precision + recall)
