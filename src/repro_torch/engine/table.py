"""Columnar tables for the PyTorch relational engine.

Tables are dicts of fixed-length 1-D tensors plus a validity mask, on
the ``Database``'s device. Filters only update the mask; joins and
aggregations materialise compacted outputs. Text lives in the host
payload (columns never hold strings): every base table carries a hidden
``<table>.row_id`` column (int32 index into its row payload) used by
semantic operators to render prompts and by function caching to key
distinct inputs.

Width rule: numerics of at most 32 bits live on the device; strings and
64-bit values stay host-side numpy. Compaction is device-resident on
device impls: ``Table.compact()`` builds its gather index with the
``kernels/compact`` op and gathers every device column in one pass,
while host columns become ``LazyColumn``s densified on first host
access. Every device→host fetch the reference counts is ticked on
``kernels.sync.HOST_SYNCS`` under the same site.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..kernels.compact.ops import compact_index, device_gather
from ..kernels.sync import HOST_SYNCS
from ..kernels.util import is_device_array as is_device
from ..kernels.util import np_dtype, resolve_impl, to_numpy

NULL_HANDLE = -1


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device on a machine
    without CUDA raises: the port never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def as_column(values, device) -> "np.ndarray | torch.Tensor":
    """Column-ify ``values``: narrow numerics become a tensor on
    ``device``; strings and 64-bit numerics stay host-side numpy."""
    arr = np.asarray(values)
    if arr.dtype.kind in "iufb" and arr.dtype.itemsize <= 4:
        return torch.as_tensor(np.ascontiguousarray(arr), device=device)
    return arr


def fetch(arr, site: str) -> np.ndarray:
    """Host copy with sync accounting: materialising a tensor ticks
    ``HOST_SYNCS`` under ``site``; host arrays (numpy, lazy columns)
    are free."""
    if is_device(arr):
        HOST_SYNCS.tick(site=site)
    return to_numpy(arr)


class HostIndex:
    """A gather index shared by every host-side column of one operator
    output, fetched to the host AT MOST once — and not at all when no
    host column is ever read."""

    __slots__ = ("_idx", "_np", "_len")

    def __init__(self, idx):
        self._len = int(np.shape(idx)[0])
        if isinstance(idx, np.ndarray):
            self._idx, self._np = None, idx
        else:
            self._idx, self._np = idx, None

    def __len__(self) -> int:
        return self._len

    def get(self) -> np.ndarray:
        if self._np is None:
            self._np = to_numpy(self._idx)
            self._idx = None  # release the device buffer
            HOST_SYNCS.tick(site="compact_host_cols")
        return self._np


class LazyColumn:
    """Column whose gather is deferred until something reads it.

    Wraps the source column plus a shared ``HostIndex``; the dense copy
    materialises on first host access (``np.asarray`` / ``__array__``)
    and is cached, releasing the source. Materialising over a tensor
    base is a real device→host sync, ticked under ``site``."""

    __slots__ = ("_base", "_index", "_dense", "_len", "_site")

    def __init__(self, base, index: HostIndex,
                 site: str = "compact_host_cols"):
        self._base = base
        self._index = index
        self._dense = None
        self._len = len(index)
        self._site = site

    @property
    def dtype(self) -> np.dtype:
        if self._dense is not None:
            return self._dense.dtype
        return np_dtype(self._base)

    @property
    def shape(self) -> tuple:
        return (self._len,)

    def __len__(self) -> int:
        return self._len

    def _materialize(self) -> np.ndarray:
        if self._dense is None:
            if is_device(self._base):
                HOST_SYNCS.tick(site=self._site)
            self._dense = to_numpy(self._base)[self._index.get()]
            self._base = self._index = None  # release upstream buffers
        return self._dense

    def __array__(self, dtype=None, copy=None):
        arr = self._materialize()
        if dtype is not None and arr.dtype != dtype:
            return arr.astype(dtype)
        return arr

    def __getitem__(self, key):
        return self._materialize()[key]


class TextStore:
    """Append-only host-side string arena; columns store int32 handles."""

    def __init__(self):
        self._strings: list[str] = []
        self._index: dict[str, int] = {}

    def put(self, s: Optional[str]) -> int:
        if s is None:
            return NULL_HANDLE
        h = self._index.get(s)
        if h is None:
            h = len(self._strings)
            self._strings.append(s)
            self._index[s] = h
        return h

    def get(self, handle: int) -> Optional[str]:
        if handle == NULL_HANDLE:
            return None
        return self._strings[int(handle)]

    def __len__(self) -> int:
        return len(self._strings)


@dataclass
class Table:
    """Fixed-capacity columnar relation. ``columns`` maps qualified names
    ("table.col") to 1-D columns of equal length; ``valid`` (a bool
    tensor) masks live rows and fixes the table's device.
    ``_num_valid`` caches the live-row count so executor stats and
    compaction share one device→host sync per operator output.

    ``sorted_by`` is order metadata for physical join selection: the
    qualified column this table's live rows are known to ascend by.
    Order-preserving operators carry it; arbitrary-order gathers drop
    it."""

    columns: dict[str, torch.Tensor]
    valid: torch.Tensor  # bool[capacity]
    _num_valid: Optional[int] = None
    sorted_by: Optional[str] = None

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def num_valid(self) -> int:
        if self._num_valid is None:
            # device reduction + scalar fetch
            self._num_valid = int(self.valid.sum())
            HOST_SYNCS.tick(site="num_valid")
        return self._num_valid

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def with_mask(self, mask: torch.Tensor) -> "Table":
        return Table(columns=self.columns, valid=self.valid & mask,
                     sorted_by=self.sorted_by)

    def compact(self, impl: str = "auto") -> "Table":
        """Materialise only valid rows. Device impls build the gather
        index with the ``kernels/compact`` op (no index fetch: the
        cached ``num_valid`` gives the count) and gather device columns
        in one pass, deferring host columns. ``"host"`` (and "auto" off
        the card) is the exact ``np.nonzero`` oracle, materialising
        everything at once. A fully-valid table returns itself."""
        if self._num_valid == self.capacity:
            return self
        impl = resolve_impl(impl, "host", self.device)
        if impl == "host":
            # an unticked fetch, as the reference's bare np.asarray
            idx, count = compact_index(to_numpy(self.valid), impl="host")
            self._num_valid = count
            if count == self.capacity:
                return self
            cols = {k: as_column(to_numpy(v)[idx], self.device)
                    for k, v in self.columns.items()}
            return Table(columns=cols,
                         valid=torch.ones(count, dtype=torch.bool,
                                          device=self.device),
                         _num_valid=count, sorted_by=self.sorted_by)
        count = self.num_valid  # one scalar sync, cached (stats reuse it)
        if count == self.capacity:
            return self
        idx, _ = compact_index(self.valid, count=count, impl=impl)
        out = self.take_rows(idx)
        out.sorted_by = self.sorted_by  # compaction preserves row order
        return out

    def take_rows(self, idx) -> "Table":
        """Device-mode row gather: device columns go through one fused
        gather (no host round-trip), host columns defer their
        densification behind a shared lazily-fetched ``HostIndex``."""
        n_out = int(np.shape(idx)[0])
        dev = {k: v for k, v in self.columns.items() if is_device(v)}
        gathered = iter(device_gather(list(dev.values()), idx))
        src = HostIndex(idx) if len(dev) < len(self.columns) else None
        cols = {k: next(gathered) if k in dev else LazyColumn(v, src)
                for k, v in self.columns.items()}
        return Table(columns=cols,
                     valid=torch.ones(n_out, dtype=torch.bool,
                                      device=self.device),
                     _num_valid=n_out)

    def gather(self, idx: np.ndarray, impl: str = "auto") -> "Table":
        """Materialise the rows selected by ``idx`` (in ``idx`` order).
        Device impls keep device columns on the device (``take_rows``);
        the host path gathers everything through numpy at once."""
        impl = resolve_impl(impl, "host", self.device)
        if impl != "host":
            return self.take_rows(idx)
        cols = {k: as_column(to_numpy(v)[idx], self.device)
                for k, v in self.columns.items()}
        return Table(columns=cols,
                     valid=torch.ones(len(idx), dtype=torch.bool,
                                      device=self.device),
                     _num_valid=len(idx))

    def select(self, names: Sequence[str]) -> "Table":
        keep = {}
        for n in names:
            keep[n] = self.columns[n]
        # always retain hidden row_id columns of tables still referenced
        for k in self.columns:
            if k.endswith(".row_id") and k.split(".")[0] in {
                n.split(".")[0] for n in names
            }:
                keep.setdefault(k, self.columns[k])
        return Table(columns=keep, valid=self.valid,
                     _num_valid=self._num_valid,
                     sorted_by=self.sorted_by if self.sorted_by in keep
                     else None)


class ColumnarRows:
    """Row payload of a table built from columns
    (``database_from_numpy``): behaves as the list of record dicts
    ``add_table`` keeps, building each dict on access, so a table of
    millions of rows needs no million Python dicts."""

    def __init__(self, columns: Mapping[str, Sequence], n: int):
        self.columns = dict(columns)
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> dict:
        if not -self._n <= i < self._n:
            raise IndexError(i)
        out = {}
        for k, col in self.columns.items():
            v = col[i]
            out[k] = v.item() if isinstance(v, np.generic) else v
        return out

    def __iter__(self):
        return (self[i] for i in range(self._n))

    def extend(self, records: Sequence[dict]) -> None:
        """Append record dicts (a stream's micro-batch) as ``list.extend``
        does for ``add_table``'s payload: numeric columns keep their
        dtype (``None`` becomes NaN in a float column), other columns
        grow as lists. The caller's arrays are not modified."""
        if not records:
            return
        for k, col in self.columns.items():
            vals = [r[k] for r in records]
            if isinstance(col, np.ndarray):
                if col.dtype.kind == "f":
                    vals = [np.nan if v is None else v for v in vals]
                self.columns[k] = np.concatenate(
                    [col, np.asarray(vals, dtype=col.dtype)])
            else:
                self.columns[k] = list(col) + vals
        self._n += len(records)

    def catalog_stats(self) -> tuple[list[str], dict[str, int]]:
        """Column names and the distinct counts of integer columns, as
        ``Database.catalog`` computes them from records."""
        names = [c for c in self.columns if not c.startswith("_")]
        ndv = {}
        if self._n:
            for c in names:
                col = self.columns[c]
                if isinstance(col, np.ndarray) and col.dtype.kind in "iub":
                    ndv[c] = int(len(np.unique(col)))
        return names, ndv


@dataclass
class Database:
    """A set of base tables + host payload for prompt rendering, with
    every device column on ``device`` (default ``"cuda"``; a machine
    without CUDA raises unless ``device="cpu"`` is passed)."""

    tables: dict[str, Table] = field(default_factory=dict)
    payloads: dict[str, list[dict]] = field(default_factory=dict)  # raw rows
    text_cols: set[str] = field(default_factory=set)  # qualified text columns
    # ground-truth semantic evaluators: phi template -> callable(*rows)->value
    truths: dict[str, object] = field(default_factory=dict)
    device: torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def add_table(self, name: str, records: list[dict],
                  text_columns: Iterable[str] = ()):
        """Build a columnar table from host records. Numeric columns
        become int32/float32 tensors; text columns are reached through
        the row payload at prompt-render time."""
        text_columns = set(text_columns)
        n = len(records)
        cols: dict[str, torch.Tensor] = {}
        keys = list(records[0].keys()) if records else []
        for k in keys:
            if k.startswith("_"):
                continue  # latent ground-truth field: payload-only
            q = f"{name}.{k}"
            if k in text_columns:
                self.text_cols.add(q)
                continue  # text accessed via payload[row_id]
            vals = [r[k] for r in records]
            if all(isinstance(v, (int, np.integer, bool)) for v in vals):
                arr = np.asarray(vals, dtype=np.int32)
            else:
                arr = np.asarray(vals, dtype=np.float32)
            cols[q] = torch.as_tensor(arr, device=self.device)
        cols[f"{name}.row_id"] = torch.arange(n, dtype=torch.int32,
                                              device=self.device)
        self.tables[name] = Table(
            columns=cols,
            valid=torch.ones(n, dtype=torch.bool, device=self.device))
        self.payloads[name] = records

    def payload_value(self, table: str, row_id: int, col: str):
        if row_id < 0:
            return None
        return self.payloads[table][row_id].get(col)

    def materialize(self, table: Table, cols: Optional[Sequence[str]] = None
                    ) -> list[dict]:
        """Host materialisation of a result table. Text columns
        (payload-only) are reconstructed through ``<t>.row_id``."""
        t = table.compact()
        n = t.capacity
        np_cols = {k: fetch(v, "materialize") for k, v in t.columns.items()}
        want = list(cols) if cols else None
        out = []
        for i in range(n):
            rec = {}
            for k, v in np_cols.items():
                if k.endswith(".row_id"):
                    continue
                if want is not None and k not in want:
                    continue
                rec[k] = v[i].item()
            if want is not None:
                for k in want:
                    if k in rec:
                        continue
                    tname, c = k.split(".", 1)
                    rid_col = f"{tname}.row_id"
                    if rid_col in np_cols and tname in self.payloads:
                        rec[k] = self.payload_value(
                            tname, int(np_cols[rid_col][i]), c)
            out.append(rec)
        return out

    def catalog(self):
        from ..core.plan import Catalog

        cat = Catalog()
        for name, tbl in self.tables.items():
            recs = self.payloads[name]
            if isinstance(recs, ColumnarRows):
                colnames, ndv = recs.catalog_stats()
            else:
                colnames = [c for c in (recs[0].keys() if recs else [])
                            if not c.startswith("_")]
                ndv = {}
                for c in colnames:
                    vals = [r[c] for r in recs]
                    if vals and isinstance(vals[0], (int, np.integer)):
                        ndv[c] = len(set(vals))
            cat.add_table(name, colnames + ["row_id"], len(recs), ndv=ndv)
        return cat


def database_from_numpy(tables: Mapping[str, Mapping[str, Sequence]],
                        texts: Mapping[str, Iterable[str]] | None = None,
                        truths: Mapping[str, object] | None = None,
                        device="cuda") -> Database:
    """Build a ``Database`` from per-table columns, exactly as
    ``add_table`` would from the records ``{col: column[i]}``.

    ``tables[name]`` maps every payload column, in record order, to a
    numpy array (numeric columns and ``_``-prefixed latent fields) or a
    sequence of strings (text payload); ``texts[name]`` names the text
    columns. Integer and bool columns become int32 device columns,
    floats float32, as ``add_table`` types Python ints and floats; the
    rows stay columnar (``ColumnarRows``), building each record dict
    only when a prompt or truth reads it.
    """
    db = Database(device=device)
    texts = texts or {}
    for name, columns in tables.items():
        text_columns = set(texts.get(name, ()))
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"{name}: columns differ in length {lengths}")
        n = lengths.pop() if lengths else 0
        cols: dict[str, torch.Tensor] = {}
        rows: dict[str, Sequence] = {}
        for k, v in columns.items():
            rows[k] = v
            if k.startswith("_"):
                continue
            q = f"{name}.{k}"
            if k in text_columns:
                db.text_cols.add(q)
                continue
            arr = np.asarray(v)
            if arr.dtype.kind not in "iubf":
                raise TypeError(f"{q}: numeric column expected, got "
                                f"{arr.dtype}")
            rows[k] = arr
            arr = arr.astype(np.int32 if arr.dtype.kind in "iub"
                             else np.float32)
            cols[q] = torch.as_tensor(arr, device=db.device)
        cols[f"{name}.row_id"] = torch.arange(n, dtype=torch.int32,
                                              device=db.device)
        db.tables[name] = Table(
            columns=cols,
            valid=torch.ones(n, dtype=torch.bool, device=db.device))
        db.payloads[name] = ColumnarRows(rows, n)
    db.truths.update(truths or {})
    return db
