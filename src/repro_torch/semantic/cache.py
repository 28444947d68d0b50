"""Function caching for semantic operators (paper §2.3, §5).

The cache is keyed on the *rendered prompt string* — predicate template φ
plus the input tuple's values — so different predicates never share entries
(§5). On a hit the backend call is skipped entirely. Scoped per query
execution by default (``clear()`` between queries), matching the paper.

Three levels:

* the prompt store (``lookup_batch``) — keyed on the rendered prompt
  string, the paper's semantics;
* the key-probe fast path (``probe_keys``/``bind_keys``) — keyed on the
  ``group_build`` (row hash, exact key row) identity of a
  representative, so repeat operators skip even the prompt render;
* the device-resident **verdict table** (``VerdictTable``) — an int8
  verdict column keyed by the row-hash slot, holding resolved
  semantic-FILTER verdicts (true/false/NULL). On the card a batch of
  representatives resolves in one device gather instead of one host
  dict probe per representative; misses (and every non-boolean
  operator) fall back to the exact host levels above, which remain the
  oracle. All levels share one scope: ``clear()`` empties them
  together.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Hashable, Iterable, Optional, Sequence

import numpy as np
import torch

from ..kernels.hash_dedup.ref import FNV_OFFSET, FNV_PRIME
from ..kernels.sync import HOST_SYNCS

# sentinel distinguishing "key never seen" from "key renders to NULL"
KEY_MISS = object()

# int8 verdict codes stored by the device table
# second-fingerprint FNV basis: an independent hash family over the same
# key rows (hash_rows_np(keys, basis=FP_BASIS)) guarding slot collisions
FP_BASIS = np.uint32(0x9747B28C)
VERDICT_MISS = np.int8(-1)
VERDICT_FALSE = np.int8(0)
VERDICT_TRUE = np.int8(1)
VERDICT_NULL = np.int8(2)


def _fnv1a_str(s: str) -> np.uint32:
    """Stable 32-bit FNV-1a over a string (the per-φ salt)."""
    h = FNV_OFFSET
    for b in s.encode("utf-8"):
        h = np.uint32((int(h) ^ b) * int(FNV_PRIME) & 0xFFFFFFFF)
    return h


class VerdictTable:
    """Device-resident value table for semantic-filter verdicts.

    A fixed pow2-capacity open hash table in device memory: ``tags``
    (the dedup row hash, salted per φ), ``fps`` (an independent FNV
    fingerprint of the exact key row) — both uint32 values held as
    int32 bits — and ``verdicts`` (int8 — FALSE/TRUE/NULL). ``bind``
    scatters a batch of resolved representatives in one device pass
    (first write wins); ``probe`` resolves a batch in one gather + ONE
    device→host fetch, returning ``VERDICT_MISS`` where the slot is
    empty or keyed by a different (tag, fingerprint) pair.

    The table is a *cache of the cache*: every miss falls back to the
    exact host path, which stays the oracle. ``impl="off"`` disables
    it; ``impl="on"`` forces it; ``impl="auto"`` enables it on a CUDA
    device (the host dict wins on the CPU). ``device=None`` leaves the
    table unplaced: the first ``Executor`` built over it places it on
    its database's device (``place``).

    ``mesh=`` (a ``sharding.DataMesh``) partitions the table across the
    mesh by the SAME key-hash routing as the partitioned data tier
    (Fibonacci top bits of the tag — ``kernels.partition.ref.
    shard_of_np``): a key's slot is ``owner * (capacity / P) + (tag &
    (capacity / P - 1))``, and the columns are held shard-wise (shard
    p's slot range on ``mesh.devices[p]``), so the slots a probe touches
    live on the shard the key's data rows occupy. Verdict semantics are
    unchanged (only the collision pattern moves).
    """

    def __init__(self, capacity: int = 1 << 15, impl: str = "auto",
                 device=None, mesh=None):
        if capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two: {capacity}")
        if impl not in ("auto", "on", "off"):
            raise ValueError(f"impl must be auto|on|off, got {impl!r}")
        self.capacity = capacity
        self.impl = impl
        self.mesh = mesh
        self._n_shards = 1 if mesh is None else mesh.n_shards
        if capacity % self._n_shards:
            raise ValueError(
                f"capacity {capacity} must divide evenly across "
                f"{self._n_shards} shards")
        self.device: Optional[torch.device] = None
        self.enabled = impl == "on"
        self._phi_salts: dict[str, np.uint32] = {}
        self._n_bound = 0
        if mesh is not None:
            self.place(mesh.devices[0])
        elif device is not None:
            self.place(device)

    def place(self, device) -> None:
        """Put the table on ``device`` (on a mesh: shard-wise on its
        devices, ``device`` the first); ``impl="auto"`` enables it there
        iff the device is CUDA."""
        self.device = torch.device(device)
        if self.impl == "auto":
            self.enabled = self.device.type == "cuda"
        if self.enabled:
            self._alloc()

    def _alloc(self) -> None:
        """Per shard, its (tags, fps, verdicts) columns of
        ``capacity / P`` slots on the shard's device."""
        local = self.capacity // self._n_shards
        devices = (self.mesh.devices if self.mesh is not None
                   else (self.device,))
        self._cols = [
            (torch.zeros(local, dtype=torch.int32, device=dev),
             torch.zeros(local, dtype=torch.int32, device=dev),
             torch.full((local,), int(VERDICT_MISS), dtype=torch.int8,
                        device=dev))
            for dev in devices]

    def _placed(self) -> None:
        if self.device is None:
            raise RuntimeError("VerdictTable has no device: pass device= "
                               "or run it under an Executor")

    def _slots(self, tags: np.ndarray) -> np.ndarray:
        """Slot index per tag. Single-device: the tag's low bits.
        Partitioned: owning shard (tag top bits, the data tier's
        routing) * local capacity + the tag's low bits within it."""
        if self._n_shards == 1:
            return tags & np.uint32(self.capacity - 1)
        from ..kernels.partition.ref import shard_of_np

        local = self.capacity // self._n_shards
        owner = shard_of_np(tags, self._n_shards).astype(np.uint32)
        return owner * np.uint32(local) + (tags & np.uint32(local - 1))

    def _by_shard(self, slots: np.ndarray):
        """(shard, its columns, positions into the batch, local slots
        as an int64 tensor on the shard's device) for every shard the
        batch touches."""
        local = self.capacity // self._n_shards
        owner = slots // local
        for p, cols in enumerate(self._cols):
            idx = np.flatnonzero(owner == p)
            if len(idx):
                loc = torch.as_tensor((slots[idx] % local).astype(np.int64),
                                      device=cols[0].device)
                yield cols, idx, loc

    def clear(self) -> None:
        """Drop every binding (query-scope reset, with the host cache)."""
        if self.enabled and self._n_bound:
            self._alloc()
        self._n_bound = 0
        self._phi_salts.clear()

    def _salted(self, phi: str, hashes, fps):
        salt = self._phi_salts.get(phi)
        if salt is None:
            salt = _fnv1a_str(phi)
            self._phi_salts[phi] = salt
        tags = np.asarray(hashes, dtype=np.uint32) ^ salt
        mix = np.uint32((int(salt) * 0x9E3779B1) & 0xFFFFFFFF)
        return tags, np.asarray(fps, dtype=np.uint32) ^ mix

    @staticmethod
    def _dev(a: np.ndarray, device) -> torch.Tensor:
        """uint32 host array -> int32-bit tensor on ``device``."""
        return torch.as_tensor(np.ascontiguousarray(a).view(np.int32),
                               device=device)

    def bind(self, phi: str, hashes, fps, verdicts) -> None:
        """Scatter resolved verdicts for φ's representatives: one device
        pass per shard touched, first write wins (occupied slots keep
        their entry). In-batch slot duplicates are dropped host-side
        first."""
        if not self.enabled or len(np.asarray(hashes)) == 0:
            return
        self._placed()
        tags, fps = self._salted(phi, hashes, fps)
        slots_np = self._slots(tags)
        first = np.unique(slots_np, return_index=True)[1]
        tags, fps = tags[first], fps[first]
        verdicts = np.asarray(verdicts, dtype=np.int8)[first]
        for (c_tags, c_fps, c_v), idx, loc in self._by_shard(
                slots_np[first]):
            dev = c_v.device
            keep = c_v[loc] != int(VERDICT_MISS)
            new_tags = torch.where(keep, c_tags[loc],
                                   self._dev(tags[idx], dev))
            new_fps = torch.where(keep, c_fps[loc], self._dev(fps[idx], dev))
            new_v = torch.where(keep, c_v[loc],
                                torch.as_tensor(verdicts[idx], device=dev))
            # the port updates the columns in place (the reference's
            # arrays are immutable and rebuilt by .at[].set)
            c_tags[loc] = new_tags
            c_fps[loc] = new_fps
            c_v[loc] = new_v
        self._n_bound += len(first)

    def probe(self, phi: str, hashes, fps) -> np.ndarray:
        """Resolve a batch of φ representatives against the device
        column. Returns (G,) int8 — FALSE/TRUE/NULL on a (tag,
        fingerprint) match, ``VERDICT_MISS`` otherwise. One device→host
        fetch per non-empty-table batch, ticked as site
        ``"verdict_table"``; an unbound table answers host-side."""
        g = len(np.asarray(hashes))
        if not self.enabled or g == 0 or self._n_bound == 0:
            return np.full(g, VERDICT_MISS, dtype=np.int8)
        self._placed()
        tags, fps = self._salted(phi, hashes, fps)
        order, parts = [], []
        for (c_tags, c_fps, c_v), idx, loc in self._by_shard(
                self._slots(tags)):
            dev = c_v.device
            v = c_v[loc]
            hit = ((v != int(VERDICT_MISS))
                   & (c_tags[loc] == self._dev(tags[idx], dev))
                   & (c_fps[loc] == self._dev(fps[idx], dev)))
            parts.append(torch.where(hit, v, int(VERDICT_MISS))
                         .to(self.device))
            order.append(idx)
        out = np.empty(g, dtype=np.int8)
        out[np.concatenate(order)] = torch.cat(parts).cpu().numpy()
        HOST_SYNCS.tick(site="verdict_table")
        return out


@dataclass
class CacheStats:
    """Row-weighted probe/hit/miss counters for the prompt store.
    Misses equal distinct backend invocations (C_LLM); hits are the
    calls function caching saved."""

    hits: int = 0
    misses: int = 0
    probes: int = 0

    @property
    def calls_saved(self) -> int:
        """Backend calls avoided by the cache (== ``hits``)."""
        return self.hits

    def reset(self) -> None:
        """Zero all counters (query-scope reset)."""
        self.hits = 0
        self.misses = 0
        self.probes = 0


class FunctionCache:
    """Per-query function cache for semantic operators: the prompt
    store (paper semantics), the key-probe fast path and the optional
    device-resident ``VerdictTable`` — see the module docstring for how
    the three levels nest."""

    def __init__(self, verdict_table: Optional[VerdictTable] = None):
        self._store: dict[Hashable, object] = {}
        # key-probe fast path: representative key id -> rendered prompt
        # (None = the key's referenced values render to NULL)
        self._key_prompts: dict[Hashable, Optional[str]] = {}
        self.verdicts = (verdict_table if verdict_table is not None
                         else VerdictTable())
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._store)

    def clear(self) -> None:
        """Empty every level (prompt store, key store, verdict table)
        — the per-query scope boundary of paper §5."""
        self._store.clear()
        self._key_prompts.clear()
        self.verdicts.clear()

    def probe_keys(self, key_ids: Sequence[Hashable]) -> list[object]:
        """Batch-probe the key fast path. Returns, per key id, the
        rendered prompt bound to it, None for a known-NULL key, or
        ``KEY_MISS`` for a key this scope has not seen."""
        return [self._key_prompts.get(k, KEY_MISS) for k in key_ids]

    def bind_keys(
        self, bindings: Iterable[tuple[Hashable, Optional[str]]]
    ) -> None:
        """Record key id -> rendered prompt (or None = NULL) bindings so
        later operators skip the render for the same representative."""
        self._key_prompts.update(bindings)

    def lookup_batch(
        self,
        keys: Sequence[Hashable],
        compute_batch: Callable[[list[Hashable]], list[object]],
        counts: Optional[Sequence[int]] = None,
    ) -> list[object]:
        """Resolve a batch of keys. Distinct missing keys are computed once
        via ``compute_batch`` (one backend invocation for the whole batch).

        ``counts`` gives each key's row multiplicity when the caller has
        already deduplicated upstream: a key standing for g rows accounts
        for g probes, of which g - 1 would have been cache hits on the
        per-row path. Stats are therefore identical whether dedup happens
        here or on the device before the call.
        """
        total = len(keys) if counts is None else int(sum(counts))
        self.stats.probes += total
        missing: list[Hashable] = []
        seen = set()
        for k in keys:
            if k not in self._store and k not in seen:
                missing.append(k)
                seen.add(k)
        if missing:
            results = compute_batch(missing)
            if len(results) != len(missing):
                raise RuntimeError(f"backend returned {len(results)} "
                                   f"results for {len(missing)} prompts")
            for k, r in zip(missing, results):
                self._store[k] = r
        self.stats.misses += len(missing)
        self.stats.hits += total - len(missing)
        return [self._store[k] for k in keys]
