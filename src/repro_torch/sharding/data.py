"""Key-partitioned data tier over a 1-D ``data`` mesh of devices.

The relational operators scale past one device by hash-partitioning a
``Table``'s rows on their key columns: every row is routed to the shard
its FNV-1a key-row hash names (Fibonacci top bits — the
``kernels/partition`` family, whose routing composes with the
``VerdictTable``'s low-bits slot), the shards exchange rows in ONE
all-to-all, and each shard sorts its received rows by key so groups —
and a join's build runs — are shard-local and contiguous.

The program is single-controller, as the reference's: one host process
holds the mesh (``DataMesh``, an ordered tuple of P devices), runs each
shard-local step as a loop over the shards on each shard's device (the
counterpart of ``shard_map``), and sees every shard's results. A device
may repeat: ``make_data_mesh(4, devices=[card] * 4)`` puts four shards
on one card, as the reference's CI forces four host devices onto one
CPU. The exchange (``exchange``) is one permute-copy where the shards
share a device and P² peer copies across distinct cards.

Layout contract (what makes the partitioned operators bit-identical to
the single-device executor):

* the transport matrix is cut into P contiguous source blocks, so after
  the fixed-stride bucket exchange each shard's received rows flatten
  in ascending *global source row* order;
* the local sort is stable (keys last-to-first, then valid-first), so
  within one key group rows keep original row order — float64
  accumulation order in ``segmented_aggregate`` matches the
  single-device plan exactly;
* each distinct key row lives on exactly one shard, so merged group
  boundaries are collision-free and the host merge
  (``_merge_groups_np``) only lexsorts the G group representatives —
  never N rows — to reproduce ``np.unique(axis=0)`` group order.

Every cross-device exchange is accounted: the exchange behind a
partition ticks ``HOST_SYNCS.collective`` under its operator's
``exchange_*`` site, and the small merge fetches tick the ordinary sync
sites (``shard_merge`` / ``shard_join_probe`` / ``shard_reduce``), one
tick per fetch of a global (all-shard) array, as the reference counts.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.table import Table
from ..kernels.hash_dedup.ops import hash_rows
from ..kernels.partition.ops import is_partitionable, shard_rank
from ..kernels.partition.ref import shard_bits, shard_of_torch
from ..kernels.segmented_reduce.ops import SegmentPlan, segment_reduce
from ..kernels.sync import HOST_SYNCS
from ..kernels.util import as_device, pow2_bucket, resolve_impl, to_numpy

__all__ = ["DATA_AXIS", "DataMesh", "make_data_mesh", "mesh_shards",
           "exchange", "ShardedTable", "partition_columns",
           "partition_table", "merge_partitions", "PartitionCache",
           "sharded_segment_reduce", "sharded_join_match",
           "is_partitionable"]

DATA_AXIS = "data"

# minimum per-source block length: partitions of small tables share a
# bounded set of shapes
_BLOCK_FLOOR = 256

# int32 device index lists (and the transport matrix itself) cap the
# exchanged/expanded row domain, same bound as the device join probe
_MAX_DEVICE_TOTAL = 2**30

_INT32_MAX = 2**31 - 1

# default-mesh shard ceiling (real hosts carry 4-8 cards)
_MAX_DEFAULT_SHARDS = 8


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ``data`` mesh: shard p's work runs on ``devices[p]``. The
    same device may hold several shards."""

    devices: tuple

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        shard_bits(len(devs))  # a power of two
        object.__setattr__(self, "devices", devs)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def shared(self) -> bool:
        """True when every shard lies on one device."""
        return len(set(self.devices)) == 1


def make_data_mesh(n_shards: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> DataMesh:
    """A 1-D ``data`` mesh over the largest power-of-two count of
    ``devices`` (by default the visible CUDA cards), capped at
    ``_MAX_DEFAULT_SHARDS`` — or exactly ``n_shards`` of them when given
    (the cap is a default, not a limit). A device may repeat in
    ``devices``. Without a visible card and without ``devices`` it
    raises: a mesh never falls to the CPU on its own (tests pass
    ``devices=["cpu"] * P``)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_data_mesh: no CUDA device is visible; pass devices= "
                "to build a mesh elsewhere (e.g. devices=['cpu'] * 4)")
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("make_data_mesh: devices is empty")
    if n_shards is None:
        n_shards = min(1 << (len(devs).bit_length() - 1),
                       _MAX_DEFAULT_SHARDS)
    if n_shards < 1 or n_shards & (n_shards - 1):
        raise ValueError(f"n_shards must be a power of two: {n_shards}")
    if n_shards > len(devs):
        raise ValueError(
            f"n_shards={n_shards} exceeds {len(devs)} devices")
    return DataMesh(tuple(devs[:n_shards]))


def mesh_shards(mesh: DataMesh) -> int:
    return mesh.n_shards


def _host(parts, site: str) -> list[np.ndarray]:
    """Host copies of every shard's part of one global array: ONE fetch,
    ticked once under ``site``."""
    HOST_SYNCS.tick(site=site)
    return [to_numpy(p) for p in parts]


# ----------------------------------------------------------- partition


def exchange(mesh: DataMesh, buckets, site: str) -> list[torch.Tensor]:
    """The all-to-all: source shard s's bucket d goes to shard d, which
    lays the received buckets out in source order —
    ``recv[d][:, s] = buckets[s][:, d]``. ``buckets`` is a
    ``(P_src, ctot, P_dst, blk)`` tensor where the shards share one
    device (one permute-copy), else a sequence of P ``(ctot, P_dst,
    blk)`` tensors, each on its source shard's device (P² peer copies).
    Returns the P ``(ctot, P_src, blk)`` received tensors; ticks ONE
    collective under ``site`` either way."""
    if isinstance(buckets, torch.Tensor):
        recv = list(buckets.permute(2, 1, 0, 3).contiguous())
    else:
        ctot, p, blk = buckets[0].shape
        recv = []
        for d, dev in enumerate(mesh.devices):
            r = torch.empty((ctot, p, blk), dtype=buckets[0].dtype,
                            device=dev)
            for s in range(p):
                r[:, s].copy_(buckets[s][:, d])
            recv.append(r)
    HOST_SYNCS.collective(site)
    return recv


def _local_sort(flat: torch.Tensor, n_keys: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's received (ctot, M) rows sorted stably — keys last to
    first, then valid rows first — and the group-boundary flags (first
    valid row of each key run)."""
    m = flat.shape[1]
    order = torch.arange(m, device=flat.device)
    for c in range(n_keys - 1, -1, -1):
        order = order[torch.argsort(flat[c][order], stable=True)]
    invalid = 1 - flat[n_keys + 1]
    order = order[torch.argsort(invalid[order], stable=True)]
    smat = flat[:, order]
    ks = smat[:n_keys]
    diff = torch.ones(m, dtype=torch.bool, device=flat.device)
    diff[1:] = (ks[:, 1:] != ks[:, :-1]).any(dim=0)
    return smat, (smat[n_keys + 1] == 1) & diff


def _layout(mesh: DataMesh, mat: torch.Tensor, n_keys: int, impl: str,
            site: str) -> tuple[list, list]:
    """The partition layout of an (n_keys + 2, N_pad) int32 transport
    matrix (key rows | source row | valid flag), shard by shard: route
    (K2 hash, Fibonacci top bits) → stable bucket rank (K10) → scatter
    into the zero-filled bucket-major (ctot, P·blk) block → one exchange
    → stable local sort → group-boundary flags."""
    n_shards = mesh.n_shards
    ctot, n_pad = mat.shape
    blk = n_pad // n_shards
    if mesh.shared:
        transport = torch.zeros((n_shards, ctot, n_pad), dtype=torch.int32,
                                device=mesh.devices[0])
    outs = []
    for s, dev in enumerate(mesh.devices):
        block = mat[:, s * blk:(s + 1) * blk].to(dev)
        h = hash_rows(block[:n_keys].T.contiguous(), impl=impl)
        dest = shard_of_torch(h, n_shards)
        base = torch.arange(n_shards, dtype=torch.int32, device=dev) * blk
        pos = shard_rank(dest, base, n_shards=n_shards, impl=impl)
        out = (transport[s] if mesh.shared else
               torch.zeros((ctot, n_pad), dtype=torch.int32, device=dev))
        out.index_copy_(1, pos.long(), block)
        outs.append(out.view(ctot, n_shards, blk))
    buckets = (transport.view(n_shards, ctot, n_shards, blk)
               if mesh.shared else outs)
    recv = exchange(mesh, buckets, site)
    del outs, buckets
    data, bnd = [], []
    for r in recv:
        smat, b = _local_sort(r.reshape(ctot, n_pad), n_keys)
        data.append(smat)
        bnd.append(b)
    return data, bnd


@dataclass
class ShardedTable:
    """A key-partitioned layout of one table's key columns.

    ``data`` holds the post-exchange transport matrix as P per-shard
    ``(n_keys + 2, shard_rows)`` int32 tensors (their concatenation
    along axis 1 is the reference's global array): per shard, valid
    rows first in stable (key, original row) order, then the invalid
    rows (empty bucket slots, pad sources). Row ``n_keys`` holds the
    original (compacted-table) row index, row ``n_keys + 1`` the valid
    flag; ``boundary`` marks each shard-local key group's first row.
    Grouping metadata (``group_plan``) merges lazily on first use and
    is cached — the layout itself is reusable across queries via
    ``PartitionCache``."""

    mesh: DataMesh
    key_names: tuple
    data: list
    boundary: list
    n_rows: int
    shard_rows: int
    _groups: Optional[tuple] = field(default=None, repr=False)
    _gid: Optional[list] = field(default=None, repr=False)

    @property
    def n_keys(self) -> int:
        return len(self.key_names)

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards

    def group_plan(self) -> tuple[SegmentPlan, np.ndarray]:
        """(SegmentPlan over original rows, group-representative rows)
        in ``np.unique(axis=0)`` lexicographic group order — ONE fetch
        of the layout and one of the boundaries, merged host-side over
        the G group representatives and cached for every later query."""
        if self._groups is None:
            data = np.concatenate(_host(self.data, "shard_merge"), axis=1)
            bnd = np.concatenate(_host(self.boundary, "shard_merge"))
            self._groups = _merge_groups_np(
                data, bnd, self.n_keys, self.n_rows,
                self.n_shards, self.shard_rows)
        plan, reps, _ = self._groups
        return plan, reps

    def gid_device(self) -> list:
        """Merged group id per layout position (per shard, a
        (shard_rows,) int32 tensor on the shard's device; pads carry
        ``num_groups`` — a dump segment the sharded reduce slices
        off), uploaded once."""
        if self._gid is None:
            self.group_plan()
            gid_np = self._groups[2]
            r = self.shard_rows
            self._gid = [torch.as_tensor(gid_np[s * r:(s + 1) * r],
                                         device=dev)
                         for s, dev in enumerate(self.mesh.devices)]
        return self._gid


def _merge_groups_np(data: np.ndarray, bnd: np.ndarray, n_keys: int,
                     n_rows: int, n_shards: int, shard_rows: int
                     ) -> tuple[SegmentPlan, np.ndarray, np.ndarray]:
    """Merge shard-local group boundaries into the global grouping:
    a ``SegmentPlan`` whose ``order`` sorts original rows by (group in
    ``np.unique`` lexicographic order, original row order) — the exact
    permutation the single-device plan applies — plus the group
    representatives' original rows and the per-layout-position merged
    group id. Host work is O(valid rows) + a G-sized lexsort; every
    distinct key lives on one shard, so boundary keys never collide."""
    w = n_shards * shard_rows
    valid = data[n_keys + 1] == 1
    src = data[n_keys]
    bndb = bnd.astype(bool)
    vpos = np.flatnonzero(valid)
    bpos = np.flatnonzero(bndb)
    g = len(bpos)
    gid_full = np.full(w, g, dtype=np.int32)
    if g == 0:
        plan = SegmentPlan(seg=np.zeros(n_rows, dtype=np.int64),
                           num_groups=0,
                           counts=np.zeros(0, dtype=np.int64),
                           order=np.zeros(0, dtype=np.int64),
                           starts=np.zeros(0, dtype=np.int64))
        return plan, np.zeros(0, dtype=np.int64), gid_full
    # group extents: next boundary in the same shard, else the shard's
    # valid-row prefix end (sort puts valid rows first per shard)
    nv = valid.reshape(n_shards, shard_rows).sum(axis=1)
    shard_end = np.arange(n_shards, dtype=np.int64) * shard_rows + nv
    sh = bpos // shard_rows
    nxt = np.empty(g, dtype=np.int64)
    nxt[:g - 1] = bpos[1:]
    nxt[g - 1] = shard_end[sh[g - 1]]
    same = np.zeros(g, dtype=bool)
    same[:g - 1] = sh[:g - 1] == sh[1:]
    counts = np.where(same, nxt, shard_end[sh]) - bpos
    # np.unique(axis=0) order == lexsort of the G distinct key rows
    keys_at_b = data[:n_keys][:, bpos]
    merged = np.lexsort(keys_at_b[::-1])
    rank = np.empty(g, dtype=np.int64)
    rank[merged] = np.arange(g)
    gid_seq = np.cumsum(bndb[vpos]) - 1  # boundary-order gid per row
    mg = rank[gid_seq]
    src_valid = src[vpos].astype(np.int64)
    order_global = src_valid[np.argsort(mg, kind="stable")]
    seg = np.empty(n_rows, dtype=np.int64)
    seg[src_valid] = mg
    counts_m = counts[merged].astype(np.int64)
    starts = np.zeros(g, dtype=np.int64)
    np.cumsum(counts_m[:-1], out=starts[1:])
    plan = SegmentPlan(seg=seg, num_groups=g, counts=counts_m,
                       order=order_global, starts=starts)
    reps = src[bpos][merged].astype(np.int64)
    gid_full[vpos] = mg.astype(np.int32)
    return plan, reps, gid_full


def partition_columns(key_cols: list, n_rows: int, mesh: DataMesh, *,
                      site: str, impl: str = "auto",
                      key_names: tuple = ()) -> ShardedTable:
    """Partition ``n_rows`` rows keyed by the given device int columns
    across ``mesh``: ONE collective exchange, ticked under ``site``."""
    if len(key_names) != len(key_cols):
        key_names = tuple(f"key{i}" for i in range(len(key_cols)))
    cols = [torch.as_tensor(c) for c in key_cols]
    dev = as_device(cols[0]) if cols else mesh.devices[0]
    impl = resolve_impl(impl, "ref", dev)
    if impl == "host":
        raise ValueError("partitioning is device-only (impl='host')")
    n_shards = mesh.n_shards
    blk = pow2_bucket(-(-n_rows // n_shards), _BLOCK_FLOOR)
    n_pad = blk * n_shards
    if n_pad * n_shards > _MAX_DEVICE_TOTAL:
        raise ValueError(f"table too large to partition: {n_rows} rows")
    mat = torch.zeros((len(cols) + 2, n_pad), dtype=torch.int32, device=dev)
    for i, c in enumerate(cols):
        mat[i, :n_rows] = c
    mat[len(cols)] = torch.arange(n_pad, dtype=torch.int32, device=dev)
    mat[len(cols) + 1, :n_rows] = 1
    data, bnd = _layout(mesh, mat, len(cols), impl, site)
    return ShardedTable(mesh=mesh, key_names=key_names, data=data,
                        boundary=bnd, n_rows=n_rows, shard_rows=n_pad)


def partition_table(table: Table, key_names: tuple, mesh: DataMesh, *,
                    site: str, impl: str = "auto") -> ShardedTable:
    """Partition a compacted ``Table`` on ``key_names`` (each column
    must satisfy ``is_partitionable``)."""
    cols = [table.col(k) for k in key_names]
    for k, c in zip(key_names, cols):
        if not is_partitionable(c):
            raise ValueError(f"column {k!r} is not partitionable")
    return partition_columns(cols, table.capacity, mesh, site=site,
                             impl=impl, key_names=tuple(key_names))


def merge_partitions(st: ShardedTable) -> np.ndarray:
    """Reassemble the partitioned key matrix in original row order —
    the (N, n_keys) inverse the ``merge(partition(t)) == t`` property
    pins (one fetch, site ``shard_merge``)."""
    data = np.concatenate(_host(st.data, "shard_merge"), axis=1)
    valid = data[st.n_keys + 1] == 1
    src = data[st.n_keys][valid]
    out = np.empty((st.n_rows, st.n_keys), dtype=np.int32)
    out[src] = data[:st.n_keys][:, valid].T
    return out


class PartitionCache:
    """LRU cache of partition layouts keyed by (table identity, key
    columns, impl). Entries hold a strong reference to the source table
    so the ``id()`` key stays pinned while the entry lives; re-running
    a query over an unchanged table reuses the layout — and its merged
    grouping — paying ZERO additional collectives."""

    def __init__(self, mesh: DataMesh, max_entries: int = 16):
        self.mesh = mesh
        self.max_entries = max_entries
        self._entries: OrderedDict = OrderedDict()

    def layout(self, table: Table, key_names: tuple, *, site: str,
               impl: str = "auto") -> ShardedTable:
        key = (id(table), tuple(key_names),
               resolve_impl(impl, "ref", table.device))
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            return hit[1]
        st = partition_table(table, tuple(key_names), self.mesh,
                             site=site, impl=impl)
        self._entries[key] = (table, st)
        if len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return st


# ------------------------------------------------------ sharded reduce


def sharded_segment_reduce(st: ShardedTable, values: torch.Tensor, op: str,
                           *, impl: str = "auto") -> np.ndarray:
    """Per-group min/max over a device int32/float32 column, computed
    shard-locally by K5 (each group lives wholly on its key's shard) and
    merged by identity-combining the (P, G) partials — ONE small fetch
    (site ``shard_reduce``). The value column is replicated to every
    shard's device (no copy where a device repeats; not a collective,
    as in the reference)."""
    plan, _ = st.group_plan()
    g = plan.num_groups
    ns = pow2_bucket(g + 1, 512)
    gids = st.gid_device()
    last = max(int(values.shape[0]) - 1, 0)
    parts = []
    for s, dev in enumerate(st.mesh.devices):
        v = values.to(dev)
        # clipped gather: pad rows (src >= N) land in the dump segment
        src = st.data[s][st.n_keys].long().clamp(max=last)
        parts.append(segment_reduce(v[src], gids[s], num_segments=ns,
                                    op=op, impl=impl))
    out = np.stack(_host(parts, "shard_reduce"))
    ufunc = np.minimum if op == "min" else np.maximum
    return ufunc.reduce(out, axis=0)[:g]


# -------------------------------------------------------- sharded join


def _probe_bounds(bmat: torch.Tensor, pmat: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-probe match range [lo, hi) in the build shard's sorted valid
    prefix. Pad build keys are overwritten with INT32_MAX so the key
    row stays ascending (a real INT32_MAX key still resolves first
    under searchsorted-left; the right bound clamps to the valid
    count); invalid probe rows contribute an empty range."""
    bvalid = bmat[2] == 1
    nvb = bvalid.sum()
    bkeys = torch.where(bvalid, bmat[0], _INT32_MAX).contiguous()
    pk = pmat[0].contiguous()
    lo = torch.searchsorted(bkeys, pk, side="left")
    hi = torch.minimum(torch.searchsorted(bkeys, pk, side="right"), nvb)
    return lo, torch.where(pmat[2] == 1, hi, lo)


def _probe_expand(bmat: torch.Tensor, pmat: torch.Tensor, lo: torch.Tensor,
                  cnt: torch.Tensor, cap: int) -> torch.Tensor:
    """One shard's matches as a (2, cap) int32 block of (probe source
    row, build source row) pairs, probe-major with build rows
    ascending; -1 past the shard's total."""
    mb, mp = bmat.shape[1], pmat.shape[1]
    c = torch.cumsum(cnt, 0)
    iota = torch.arange(cap, device=c.device)
    seg = torch.searchsorted(c, iota, side="right").clamp(max=mp - 1)
    within = iota - (c[seg] - cnt[seg])
    bpos = (lo[seg] + within).clamp(max=mb - 1)
    ok = iota < c[-1]
    psrc = torch.where(ok, pmat[1][seg], -1)
    bsrc = torch.where(ok, bmat[1][bpos], -1)
    return torch.stack([psrc, bsrc])


def _merge_matches_np(pairs: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Compact the padded per-shard pair blocks into the single-device
    match-list contract: probe-major, and within one probe row build
    matches ascend by original build row (each shard already emits
    them that way, so the lexsort only interleaves shards)."""
    mask = pairs[0] >= 0
    pl = pairs[0][mask].astype(np.int64)
    bl = pairs[1][mask].astype(np.int64)
    order = np.lexsort((bl, pl))
    return pl[order], bl[order]


def sharded_join_match(cache: PartitionCache, build_table: Table,
                       build_key: str, probe_col, *, impl: str = "auto"
                       ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Equi-join match lists via key-partitioned build and probe sides:
    the build layout comes from (or enters) ``cache`` (collective site
    ``exchange_join_build``), the probe side pays one exchange per call
    (``exchange_join_probe``), and matching is a shard-local
    searchsorted over each shard's sorted build run — both sides of a
    key meet on the shard its hash names. Two fetches (totals, then the
    expanded pair blocks) under site ``shard_join_probe``. Returns
    ``None`` when the match total overflows the device index domain
    (the caller falls back to the single-device join)."""
    mesh = cache.mesh
    st_b = cache.layout(build_table, (build_key,),
                        site="exchange_join_build", impl=impl)
    n_probe = int(probe_col.shape[0])
    st_p = partition_columns([probe_col], n_probe, mesh,
                             site="exchange_join_probe", impl=impl)
    bounds = [_probe_bounds(b, p) for b, p in zip(st_b.data, st_p.data)]
    cnts = [(hi - lo).clamp(min=0) for lo, hi in bounds]
    tot = np.asarray(_host([c.sum() for c in cnts], "shard_join_probe"),
                     dtype=np.int64)
    if int(tot.sum()) > _MAX_DEVICE_TOTAL:
        return None
    if int(tot.sum()) == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty
    cap = pow2_bucket(int(tot.max()), 1024)
    pairs = [_probe_expand(b, p, lo, cnt, cap)
             for b, p, (lo, _), cnt in zip(st_b.data, st_p.data, bounds,
                                           cnts)]
    return _merge_matches_np(
        np.concatenate(_host(pairs, "shard_join_probe"), axis=1))
