"""Incremental device structures for append-only streams.

``StreamJoinBuild`` maintains the SAME open-addressing hash table that
``kernels/hash_join`` builds from scratch — Fibonacci hashing, linear
probing with scatter-min slot claims, load factor <= 0.5 — but accepts
*appended* key batches in O(|delta|) device work instead of O(|table|)
per micro-batch. Because a slot holds exactly one distinct key, the
structure doubles as the incremental ``group_build``: occupied slots are
the groups, slot owners are the first-occurrence representatives, and
per-slot counts are the group sizes (``groups()``).

Incremental-update invariants (held by every ``extend``):

* ``owner[s]`` is the globally-first row inserted with slot ``s``'s key
  (appends never displace an existing owner — new duplicates adopt the
  owner's slot on key match, exactly like the batch build's rounds);
* ``rank[r]`` is row ``r``'s occurrence index among rows with an equal
  key, in row order. Ranks are assigned once at insert time and are
  invariant under rehashing, because a slot is one distinct key;
* probe chains never cross a hole to reach their key (we never delete,
  and an insert claims the first hole on its chain);
* capacity doubles before ``n`` reaches it, so ``H = 2**hbits >=
  2 * cap >= 2 * n`` keeps the family's load invariant without any
  per-ingest occupancy fetch — ingest costs ZERO ``HOST_SYNCS``.

The grouped build order is derived lazily ON DEVICE from the persistent
state (``order[starts[slot[r]] + rank[r]] = r``), reproducing the batch
build's stable sort by slot exactly, so ``probe()`` returns match lists
bit-identical to ``hash_join_match`` / ``hash_join_np``: probe-major,
build rows ascending per probe row, ONE device→host sync per probe (the
match total, site ``stream_probe``).

The insert's within-delta occurrence ranks come from a stable sort of
the delta by slot: the K6 radix passes on the kernel impl, a stable
argsort on ``ref``. The claim and probe loops test their exit on the
host (``hash_join.ref.LOOP_FETCHES``), as the batch join does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.hash_join.ops import _slot_lookup, _stable_order
from ..kernels.hash_join.ref import (
    EMPTY_SLOT,
    SPILL_SLOTS,
    claim_slots,
    table_bits,
)
from ..kernels.segmented_reduce.ops import _probe_expand_device
from ..kernels.sync import HOST_SYNCS
from ..kernels.util import check_int32_domain, resolve_impl

_EMPTY = int(EMPTY_SLOT)


def _capacity(n: int, floor: int) -> int:
    """Next power of two >= max(n, 1), floored at ``floor``: the
    reference's capacity-doubling policy, so rebuild counts match."""
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def _as_keys(keys, dev: torch.device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=dev, dtype=torch.int32).contiguous()
    return torch.as_tensor(np.asarray(keys, dtype=np.int32), device=dev)


def _insert_pass(owner, bk, counts, slot_all, rank_all, dkeys, start: int,
                 hbits: int, impl: str) -> torch.Tensor:
    """Insert a delta of build keys after row ``start`` of the live
    table, updating ``owner``/``bk``/``counts``/``slot_all``/``rank_all``
    in place. The delta rows run the batch build's claim/adopt rounds
    against the EXISTING ``owner`` table (global row ids keep the
    scatter-min tie-break identical), then per-row occurrence ranks
    extend from the pre-delta slot counts. Returns the distinct-key
    count as a 0-d device tensor."""
    m = dkeys.shape[0]
    h = 1 << hbits
    drows = torch.arange(start, start + m, dtype=torch.int32,
                         device=dkeys.device)
    # delta keys land in the global key column FIRST: a slot claimed by
    # one delta row must be key-checkable by its in-delta duplicates
    bk[start:start + m] = dkeys
    dslot = claim_slots(owner, bk, dkeys, drows, hbits,
                        loop="stream_insert")
    # within-delta occurrence index per slot: position in the stable
    # order by slot minus the start of its run
    ordd = _stable_order(dslot, hbits, impl).long()
    ss = dslot[ordd]
    pos = torch.arange(m, dtype=torch.int64, device=dkeys.device)
    newrun = torch.ones(m, dtype=torch.bool, device=dkeys.device)
    newrun[1:] = ss[1:] != ss[:-1]
    runstart = torch.cummax(torch.where(newrun, pos, 0), 0)[0]
    occ = torch.empty(m, dtype=torch.int32, device=dkeys.device)
    occ[ordd] = (pos - runstart).to(torch.int32)
    slot_all[start:start + m] = dslot
    rank_all[start:start + m] = torch.index_select(counts, 0, dslot) + occ
    counts.index_add_(0, dslot, torch.ones_like(dslot))
    return (owner[:h] != _EMPTY).sum()


def _order_pass(counts, slot_all, rank_all, n: int):
    """(starts, order) from the persistent state: scattering row ``r``
    to ``starts[slot[r]] + rank[r]`` reproduces the batch build's
    stable sort by slot (rank == the row's occurrence index == its
    stable-sort tie-break position)."""
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    pos = torch.index_select(starts, 0, slot_all[:n]) + rank_all[:n]
    order = torch.empty(n, dtype=torch.int32, device=counts.device)
    order[pos.long()] = torch.arange(n, dtype=torch.int32,
                                     device=counts.device)
    return starts, order


def _groups_pass(owner, slot_all, counts, n: int) -> torch.Tensor:
    """First-occurrence group view, packed into one int32 buffer for a
    single fetch: ``[num_groups, reps (H), counts (H), group_ids (n)]``.
    Occupied slots sorted by owner row give the representative order
    ``dedup_representatives`` produces; the inverse permutation gives
    dense per-row group ids."""
    h = owner.shape[0]
    occ = owner != _EMPTY
    order_slots = torch.argsort(owner, stable=True)
    gid_of_slot = torch.empty(h, dtype=torch.int32, device=owner.device)
    gid_of_slot[order_slots] = torch.arange(h, dtype=torch.int32,
                                            device=owner.device)
    gids = torch.index_select(gid_of_slot, 0, slot_all[:n])
    return torch.cat([occ.sum().to(torch.int32).view(1),
                      owner[order_slots], counts[order_slots], gids])


@dataclass
class GroupSnapshot:
    """Host snapshot of the incremental group structures: the exact
    shape ``dedup_representatives`` derives from a cold batch build.

    ``reps`` are first-occurrence row ids ascending (group order),
    ``counts`` the rows per group, ``group_ids`` the dense row → group
    map over the live rows."""

    num_groups: int
    reps: np.ndarray
    counts: np.ndarray
    group_ids: np.ndarray


class StreamJoinBuild:
    """Incrementally-maintained join build table over one int32 key
    column of an append-only base table, on that column's device.

    Construction inserts the current snapshot; ``extend(new_table)``
    inserts only the appended suffix (O(|delta|) device work, zero
    ``HOST_SYNCS``). ``probe(keys)`` serves an equi-join against the
    live build side with ONE sync (the match total), bit-identical to
    ``hash_join_match``; ``groups()`` snapshots the equivalent
    incremental ``group_build`` view. ``table_ref`` pins the exact
    ``Table`` object the state covers — the executor only consults a
    build whose ``table_ref`` IS its (compacted) build-side table, so a
    stale structure can never serve a join."""

    def __init__(self, table_name: str, key: str, table,
                 impl: str = "auto", min_cap: int = 1024):
        self.table_name = table_name
        self.key = key
        self.impl = impl
        self.min_cap = int(min_cap)
        self.inserts = 0
        self.rebuilds = 0
        self.probes = 0
        keys = table.col(key)
        self.device = (keys.device if isinstance(keys, torch.Tensor)
                       else torch.device("cpu"))
        resolve_impl(impl, "host", self.device)  # validate the token
        self._alloc(_capacity(int(np.shape(keys)[0]), self.min_cap))
        self._insert(keys)
        self.table_ref = table

    # ------------------------------------------------------------ state
    def _alloc(self, cap: int) -> None:
        """(Re)allocate the persistent device tensors at capacity
        ``cap`` (a power of two). ``hbits = table_bits(cap)`` keeps
        ``H >= 2 * cap``, so the load invariant holds for ANY number of
        distinct keys the capacity can hold. ``owner`` carries
        ``SPILL_SLOTS`` slots past ``H`` for the claim rounds."""
        self.cap = cap
        self.hbits = table_bits(cap)
        h = 1 << self.hbits
        dev = self.device
        self.n = 0
        self.bk = torch.zeros(cap, dtype=torch.int32, device=dev)
        self._owner = torch.full((h + SPILL_SLOTS,), _EMPTY,
                                 dtype=torch.int32, device=dev)
        self.owner = self._owner[:h]
        self.counts = torch.zeros(h, dtype=torch.int32, device=dev)
        self._slot = torch.zeros(cap, dtype=torch.int32, device=dev)
        self._rank = torch.zeros(cap, dtype=torch.int32, device=dev)
        self._starts = None
        self._order = None
        self._dirty = True
        self._distinct_dev = None
        self._distinct = 0

    def _impl(self, impl: str | None = None) -> str:
        return resolve_impl(impl if impl is not None else self.impl,
                            "host", self.device)

    def _insert(self, delta) -> None:
        """Insert an int32 key batch after the current rows. Grows
        (capacity doubling + full device rebuild — amortised O(log
        growth) rebuilds) when the delta would overflow."""
        m = int(np.shape(delta)[0])
        if m == 0:
            return
        dk = _as_keys(delta, self.device)
        if self.n + m > self.cap:
            all_keys = torch.cat([self.bk[:self.n], dk])
            self._alloc(_capacity(self.n + m, self.min_cap))
            self.rebuilds += 1
            self._insert(all_keys)
            return
        impl = self._impl()
        self._distinct_dev = _insert_pass(
            self._owner, self.bk, self.counts, self._slot, self._rank, dk,
            self.n, self.hbits, "ref" if impl == "host" else impl)
        self.n += m
        self.inserts += 1
        self._dirty = True
        self._distinct = None

    def extend(self, new_table) -> None:
        """Fold the rows appended since the last snapshot into the live
        structures (only the suffix beyond ``self.n`` is touched)."""
        keys = new_table.col(self.key)
        self._insert(keys[self.n:])
        self.table_ref = new_table

    def _refresh(self) -> None:
        if self._dirty:
            self._starts, self._order = _order_pass(
                self.counts, self._slot, self._rank, self.n)
            self._dirty = False

    # ------------------------------------------------------- observers
    @property
    def distinct(self) -> int:
        """Distinct keys in the live table — ONE cached scalar fetch
        (site ``stream_build``), refreshed lazily after inserts."""
        if self._distinct is None:
            self._distinct = int(self._distinct_dev)
            HOST_SYNCS.tick(site="stream_build")
        return self._distinct

    # --------------------------------------------------------- serving
    def probe(self, probe_keys, impl: str | None = None):
        """Match lists ``(out_probe, out_build)`` for an equi-join with
        this build side — same ordering contract, device int32 output
        and single-sync cost as ``hash_join_match``. Returns ``None``
        when the caller should fall back to the batch join (host impl
        requested, or on the CPU a skew total past the int32-addressable
        bound; on a CUDA device such a total raises)."""
        impl_r = self._impl(impl)
        if impl_r == "host":
            return None
        n_probe = int(np.shape(probe_keys)[0])
        if n_probe == 0 or self.n == 0:
            empty = torch.zeros(0, dtype=torch.int32, device=self.device)
            return empty, empty
        self._refresh()
        cnt, offs, total = _slot_lookup(
            _as_keys(probe_keys, self.device), self.bk, self.owner,
            self.counts, self._starts, self.hbits)
        total = int(total)
        HOST_SYNCS.tick(site="stream_probe")
        self.probes += 1
        check_int32_domain(total, self.device, "StreamJoinBuild.probe")
        if total > 2**30:
            return None  # pathological skew: int32 cannot address it
        if total == 0:
            empty = torch.zeros(0, dtype=torch.int32, device=self.device)
            return empty, empty
        return _probe_expand_device(cnt, offs, self._order, total, impl_r)

    def groups(self) -> GroupSnapshot:
        """Snapshot the incremental group view (ONE fetch, site
        ``stream_groups``): equivalent to running
        ``dedup_representatives`` / ``group_build`` cold over the
        concatenated key column."""
        if self.n == 0:
            z = np.zeros(0, np.int32)
            return GroupSnapshot(0, z, z.copy(), z.copy())
        h = self.counts.shape[0]
        buf = _groups_pass(self.owner, self._slot, self.counts,
                           self.n).cpu().numpy()
        HOST_SYNCS.tick(site="stream_groups")
        g = int(buf[0])
        reps, cnts, gids = buf[1:1 + h], buf[1 + h:1 + 2 * h], buf[1 + 2 * h:]
        return GroupSnapshot(g, reps[:g], cnts[:g], gids)
