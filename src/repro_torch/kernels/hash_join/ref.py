"""Reference implementations for the join family that this port
serves: the sort-merge probe oracle over an already-sorted build side.

The open-addressing hash join (``src/repro/kernels/hash_join/ref.py``:
``hash_join_np``, the jnp build/probe loops and the radix-rank kernel
K6) is not ported yet; see ``ops.py``.
"""
from __future__ import annotations

import numpy as np


def sorted_probe_match_np(probe_keys: np.ndarray, build_keys: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Sort-merge probe oracle: ``build_keys`` MUST already be sorted
    ascending. Matches are the ``[searchsorted-left,
    searchsorted-right)`` runs, whose positions ARE ascending build row
    indices."""
    pk = np.asarray(probe_keys)
    bk = np.asarray(build_keys)
    lo = np.searchsorted(bk, pk, side="left")
    hi = np.searchsorted(bk, pk, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    out_l = np.repeat(np.arange(pk.shape[0], dtype=np.int64), cnt)
    ends = np.cumsum(cnt)
    base = lo - (ends - cnt)
    out_r = np.repeat(base, cnt) + np.arange(total, dtype=np.int64)
    return out_l, out_r
