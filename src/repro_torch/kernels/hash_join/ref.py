"""Reference implementations for the hash join family.

* ``hash_join_np`` — the exact numpy oracle: the same open-addressing
  table the device path builds, evaluated with host vectorized probing.
  It is the ``impl="host"`` serving and the baseline every device impl
  is held to;
* ``fib_hash_torch`` / ``hash_table_build_torch`` /
  ``hash_table_probe_torch`` — the torch build/probe loops shared by
  every device impl (``ref`` and ``kernel`` differ only in how they
  produce the grouped build order), and ``claim_slots``, the claim
  rounds that ``streaming.StreamJoinBuild`` also runs on its live table;
* ``sorted_probe_match_np`` — the sort-merge probe oracle over an
  already-sorted build side.

Table invariants (shared host/device): capacity ``H = 2**hbits`` with
``H >= 2 * n_build`` (load factor <= 0.5) and ``hbits >= 10``;
Fibonacci hashing ``(uint32(key) * 2654435769) >> (32 - hbits)``;
collisions resolve by linear probing with wraparound; a slot stores its
owner build row, the LOWEST row inserted with that key (a scatter-min
claim); duplicate keys share their owner's slot.

The loops run until every row has resolved. ``jax.lax.while_loop``
tests that on the device; here it is a host fetch of ``all()``, made
every ``LOOP_CHECK_EVERY`` rounds (a round after every row resolved
changes nothing) and counted in ``LOOP_FETCHES`` by loop — not in
``HOST_SYNCS``, where the reference counts no such fetch.
"""
from __future__ import annotations

import numpy as np
import torch

# open slot sentinel: no real build row index can reach INT32_MAX
EMPTY_SLOT = np.int32(2**31 - 1)
# Fibonacci multiplier: floor(2**32 / golden ratio), forced odd
FIB_MULT = np.uint32(2654435769)
MIN_BITS = 10
_EMPTY = int(EMPTY_SLOT)

# rows with nothing to claim in a round scatter into these slots past
# the table, spread by row so their atomics do not all meet on one word
SPILL_SLOTS = 1024
LOOP_CHECK_EVERY = 4
# loop -> host fetches of the loop's exit test since the last reset
LOOP_FETCHES = {"build": 0, "probe": 0, "stream_insert": 0}


def reset_loop_fetches() -> None:
    for k in LOOP_FETCHES:
        LOOP_FETCHES[k] = 0


def table_bits(n_build: int) -> int:
    """Smallest ``hbits`` with ``2**hbits >= max(2 * n_build, 2**10)``:
    the load-factor <= 0.5 invariant every impl shares."""
    return max(int(2 * n_build - 1).bit_length(), MIN_BITS)


def fib_hash_torch(keys: torch.Tensor, hbits: int) -> torch.Tensor:
    """(N,) int32 keys -> (N,) int32 initial slots in [0, 2**hbits):
    the uint32 product mod 2^32, computed in int64 from 16-bit halves
    so no intermediate leaves the int64 range."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    mult = int(FIB_MULT)
    prod = ((k & 0xFFFF) * mult
            + (((k >> 16) * mult) & 0xFFFF) * 65536) & 0xFFFFFFFF
    return (prod >> (32 - hbits)).to(torch.int32)


def _done(flags: torch.Tensor, loop: str, rounds: int) -> bool:
    if rounds % LOOP_CHECK_EVERY:
        return False
    LOOP_FETCHES[loop] += 1
    return bool(flags.all())


def claim_slots(owner: torch.Tensor, key_col: torch.Tensor,
                keys: torch.Tensor, rows: torch.Tensor, hbits: int,
                loop: str = "build") -> torch.Tensor:
    """Insert ``keys`` (global row ids ``rows`` into ``key_col``, which
    already holds them) into the table ``owner`` ((2**hbits +
    SPILL_SLOTS,) int32, updated in place; the slots past the table
    take the scatter of rows with nothing to claim). Each round every
    unresolved row scatter-min claims its current slot if open, then
    adopts the slot (its owner's key matches: duplicates join their
    owner here) or moves on by one. Returns each row's slot."""
    h = 1 << hbits
    mask = h - 1
    n = keys.shape[0]
    spill = h + (rows & (SPILL_SLOTS - 1))
    cur = fib_hash_torch(keys, hbits)
    resolved = torch.zeros(n, dtype=torch.bool, device=keys.device)
    slot = torch.zeros(n, dtype=torch.int32, device=keys.device)
    rounds = 0
    while n:
        own = torch.index_select(owner, 0, cur)
        target = torch.where(~resolved & (own == _EMPTY), cur, spill)
        owner.scatter_reduce_(0, target.long(), rows, reduce="amin")
        own = torch.index_select(owner, 0, cur)
        occupied = own != _EMPTY
        key_at = torch.index_select(key_col, 0,
                                    torch.where(occupied, own, 0))
        ok = ~resolved & occupied & (key_at == keys)
        slot = torch.where(ok, cur, slot)
        resolved = resolved | ok
        cur = torch.where(resolved, cur, (cur + 1) & mask)
        rounds += 1
        if _done(resolved, loop, rounds):
            break
    return slot


def hash_table_build_torch(bk: torch.Tensor, hbits: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Build the open-addressing table from (Nb,) int32 build keys.
    Returns ``(owner, slot_of)``: ``owner`` (H,) int32 maps slot ->
    owning build row (``EMPTY_SLOT`` = hole); ``slot_of`` (Nb,) int32
    maps each build row -> its key's slot."""
    h = 1 << hbits
    owner = torch.full((h + SPILL_SLOTS,), _EMPTY, dtype=torch.int32,
                       device=bk.device)
    rows = torch.arange(bk.shape[0], dtype=torch.int32, device=bk.device)
    slot_of = claim_slots(owner, bk, bk, rows, hbits)
    return owner[:h], slot_of


def hash_table_probe_torch(pk: torch.Tensor, key_col: torch.Tensor,
                           owner: torch.Tensor, hbits: int) -> torch.Tensor:
    """One-pass probe: (Np,) int32 slot per probe row, -1 = no match.
    A probe chain ends at its key's slot (hit) or at a hole (miss —
    guaranteed to exist by the load invariant)."""
    mask = (1 << hbits) - 1
    n = pk.shape[0]
    cur = fib_hash_torch(pk, hbits)
    done = torch.zeros(n, dtype=torch.bool, device=pk.device)
    pslot = torch.full((n,), -1, dtype=torch.int32, device=pk.device)
    rounds = 0
    while n:
        own = torch.index_select(owner, 0, cur)
        occupied = own != _EMPTY
        key_at = torch.index_select(key_col, 0,
                                    torch.where(occupied, own, 0))
        hit = ~done & occupied & (key_at == pk)
        pslot = torch.where(hit, cur, pslot)
        done = done | hit | ~occupied
        cur = torch.where(done, cur, (cur + 1) & mask)
        rounds += 1
        if _done(done, "probe", rounds):
            break
    return pslot


def hash_join_np(probe_keys: np.ndarray, build_keys: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Exact host oracle: open-addressing hash join on int32 keys.

    Same table shape and invariants as the device path (Fibonacci hash,
    linear probing, load <= 0.5); vectorized rounds retire whole
    cohorts of unresolved rows at once. Returns int64 ``(out_probe,
    out_build)`` match lists under the family's ordering contract."""
    pk = np.ascontiguousarray(probe_keys, dtype=np.int32)
    bk = np.ascontiguousarray(build_keys, dtype=np.int32)
    nb, npr = bk.shape[0], pk.shape[0]
    empty = np.zeros(0, dtype=np.int64)
    if nb == 0 or npr == 0:
        return empty, empty.copy()
    hbits = table_bits(nb)
    h = 1 << hbits
    mask = h - 1
    bku = bk.view(np.uint32)
    owner = np.full(h, -1, np.int32)
    rows = np.arange(nb, dtype=np.int32)
    cur = ((bku * FIB_MULT) >> np.uint32(32 - hbits)).astype(np.int32)
    slot_of = np.empty(nb, np.int32)
    unres = rows
    while unres.size:
        own = owner[cur]
        emp = own == -1
        if emp.any():
            # last-writer-wins claim; losers re-read and key-check below
            owner[cur[emp]] = unres[emp]
            own = owner[cur]
        ok = bk[own] == bk[unres]
        slot_of[unres] = cur  # rows resolved this round keep this slot
        unres = unres[~ok]
        cur = (cur[~ok] + 1) & mask
    # dense group ids in slot order + grouped build order. The packed
    # (gid << row_bits) | row keys are unique, so plain (unstable)
    # quicksort already yields the stable grouped order.
    occ = owner >= 0
    gid_of_slot = np.cumsum(occ, dtype=np.int32)
    gid = gid_of_slot[slot_of] - 1
    g = int(gid_of_slot[-1])
    row_bits = max(nb - 1, 1).bit_length()
    if row_bits + max(g - 1, 1).bit_length() <= 32:
        packed = ((gid.astype(np.uint32) << np.uint32(row_bits))
                  | rows.view(np.uint32))
        packed.sort()
        order = (packed & np.uint32((1 << row_bits) - 1)).astype(np.int64)
    else:
        packed = ((gid.astype(np.uint64) << np.uint64(row_bits))
                  | rows.astype(np.uint64))
        packed.sort()
        order = (packed & np.uint64((1 << row_bits) - 1)).astype(np.int64)
    counts = np.bincount(gid, minlength=g)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    # probe rounds: each key chases its chain to a hit or a hole
    pcur = ((pk.view(np.uint32) * FIB_MULT)
            >> np.uint32(32 - hbits)).astype(np.int32)
    pgid = np.full(npr, -1, np.int32)
    punres = np.arange(npr, dtype=np.int32)
    while punres.size:
        own = owner[pcur]
        hit = (own >= 0) & (bk[own] == pk[punres])
        pgid[punres[hit]] = gid_of_slot[pcur[hit]] - 1
        keep = ~(hit | (own == -1))
        punres = punres[keep]
        pcur = (pcur[keep] + 1) & mask
    # probe-major expansion (build rows ascend within each probe row)
    matched = pgid >= 0
    mrows = np.flatnonzero(matched)
    mgid = pgid[matched]
    cnt = counts[mgid]
    total = int(cnt.sum())
    out_l = np.repeat(mrows, cnt).astype(np.int64)
    ends = np.cumsum(cnt)
    base = starts[mgid] - (ends - cnt)
    out_r = order[np.repeat(base, cnt) + np.arange(total, dtype=np.int64)]
    return out_l, out_r


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
