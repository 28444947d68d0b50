"""Append-only micro-batch ingestion for base tables.

``append_rows`` is the streaming analogue of ``Database.add_table``:
it encodes a micro-batch of host records into the base table's EXISTING
column dtypes and concatenates on device — residency is never
invalidated (no device→host round trip, zero syncs), the hidden
``row_id`` column keeps indexing the (extended) payload list, and the
cached ``num_valid`` extends arithmetically because appended rows are
all live.

Append contract:

* base tables only — every column is device-resident by
  ``add_table`` construction (text lives in payloads); a host column
  is a contract violation and raises;
* each record must carry every non-latent, non-text column of the
  table (missing keys raise ``KeyError`` — schema drift fails loud);
  latent ``_``-prefixed fields and text columns ride along in the
  payload exactly as at load time;
* appended rows are valid; ``sorted_by`` metadata is dropped (an
  append can break any order guarantee);
* the snapshot after ``k`` appends is indistinguishable from
  ``add_table`` over the concatenated records (tests/test_streaming.py
  pins this for the reference, tests/test_torch_streaming.py holds the
  port to it).

``StreamContext`` owns the per-(table, key) ``StreamJoinBuild``
structures and folds each append into them, so registered standing
queries re-join against live incremental state instead of rebuilding
hash tables from scratch every micro-batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.plan import Join, Scan
from ..engine.table import Table, as_column
from ..kernels.util import is_device_array as is_device
from ..kernels.util import np_dtype, resolve_impl
from .state import StreamJoinBuild


def _encode_column_host(vals: list, dtype: np.dtype) -> np.ndarray:
    """Host-side encode of one record field list at the base column's
    dtype. ``None`` becomes NaN for float columns; integer columns
    require integral values (add_table would have chosen float32 for a
    column that ever held None/floats, so a None here is schema drift
    and raises like any other bad value)."""
    if dtype.kind == "f":
        return np.asarray(
            [np.nan if v is None else v for v in vals], dtype=dtype)
    return np.asarray(vals, dtype=dtype)


def append_rows(db, name: str, records: list[dict]) -> Table:
    """Append a micro-batch of host records to base table ``name``.

    Returns the new ``Table`` (also installed in ``db.tables``); an
    empty batch returns the current table unchanged. Costs zero
    device→host syncs — encoding is host→device only."""
    base = db.tables[name]
    k = len(records)
    if k == 0:
        return base
    n0 = base.capacity
    dev = db.device
    cols: dict[str, torch.Tensor] = {}
    for q, old in base.columns.items():
        if not is_device(old):
            raise ValueError(
                f"append target {q} is not device-resident: "
                "streaming appends only to base tables")
        cname = q.split(".", 1)[1]
        if q == f"{name}.row_id":
            new = torch.arange(n0, n0 + k, dtype=torch.int32, device=dev)
        else:
            vals = [r[cname] for r in records]  # KeyError = schema drift
            new = as_column(_encode_column_host(vals, np_dtype(old)), dev)
        cols[q] = torch.cat([old, new])
    valid = torch.cat([base.valid,
                       torch.ones(k, dtype=torch.bool, device=dev)])
    nv = None if base._num_valid is None else base._num_valid + k
    out = Table(columns=cols, valid=valid, _num_valid=nv)
    db.tables[name] = out
    db.payloads[name].extend(records)
    return out


class StreamContext:
    """Incremental maintenance state shared by the standing queries of
    one database: per-(table, key) ``StreamJoinBuild`` structures plus
    the append entry point that keeps them live.

    An ``Executor`` with ``ex.stream = ctx`` consults ``build_for``
    inside its hash-join branch; the identity check on ``table_ref``
    guarantees a structure can only serve the exact snapshot it
    covers."""

    def __init__(self, db, kernel_impl: str = "auto",
                 min_cap: int = 1024):
        self.db = db
        self.kernel_impl = kernel_impl
        self.min_cap = min_cap
        self.builds: dict[tuple[str, str], StreamJoinBuild] = {}
        self.batches = 0

    def register_join_build(self, table: str,
                            key: str) -> StreamJoinBuild | None:
        """Maintain an incremental build table over ``table.key``
        (idempotent). Returns ``None`` for keys the device hash family
        cannot code (missing, host-side, or non-int32/bool)."""
        got = self.builds.get((table, key))
        if got is not None:
            return got
        base = self.db.tables.get(table)
        if base is None or key not in base.columns:
            return None
        col = base.columns[key]
        if not is_device(col) or np_dtype(col).kind not in "ib":
            return None
        b = StreamJoinBuild(table, key, base, impl=self.kernel_impl,
                            min_cap=self.min_cap)
        self.builds[(table, key)] = b
        return b

    def register_plan(self, plan) -> None:
        """Register incremental build structures for every equi-join in
        ``plan`` whose build (right) side is a base-table scan — the
        shape the executor's stream interception can serve."""
        for node in plan.walk():
            if (isinstance(node, Join) and len(node.children) == 2
                    and isinstance(node.children[1], Scan)):
                self.register_join_build(node.children[1].table,
                                         node.right_key)

    def append(self, table: str, records: list[dict]) -> Table:
        """Ingest one micro-batch: append to the base table, then fold
        the delta into every registered structure over it."""
        new_t = append_rows(self.db, table, records)
        for (tname, _key), b in self.builds.items():
            if tname == table and b.table_ref is not new_t:
                b.extend(new_t)
        self.batches += 1
        return new_t

    def build_for(self, table_obj, key: str,
                  impl: str = "auto") -> StreamJoinBuild | None:
        """The live structure covering EXACTLY ``table_obj`` on
        ``key``, or ``None`` (unregistered, stale, or host impl
        requested — identity, not name, is the staleness proof)."""
        if resolve_impl(impl, "host", self.db.device) == "host":
            return None
        for b in self.builds.values():
            if b.key == key and b.table_ref is table_obj:
                return b
        return None
