"""Host-facing wrappers: row hashing, first-occurrence dedup, and the
device group build.

``group_build`` is the shared entry point of the group-build subsystem:
one device pass (stable sort by a 32-bit key + the boundary scan) that
returns representatives, the inverse scatter map, group counts and
segment offsets for an (N, C) int32 key matrix, fetched to the host in
ONE ``.cpu()`` of a packed buffer. Its consumers: semantic dedup
(``dedup_representatives``), grouped aggregates
(``group_build_columns``) and the sort-based join build
(``segmented_reduce.ops.join_match_lists``).

For C == 1 the sort key is the raw key column (injective, so grouping
is exact). For C > 1 it is the FNV-1a row hash; one device-side
comparison detects 32-bit collisions and the host regroups exactly
(``np.unique(axis=0)``) in that rare case.

Impls: ``"kernel"`` launches the CUDA FNV (K2) and boundary-scan (K3)
kernels on a CUDA device (their plain versions on the CPU); ``"ref"``
runs the plain PyTorch versions; ``"host"`` is the numpy oracle;
``"auto"`` is the kernel on a CUDA device and the host build on the
CPU. Sort keys are carried as int32 bit patterns: a uint32 order
is the signed order of the bits XOR 0x80000000, so torch sorts int32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..compact.compact import prefix_count_kernel
from ..compact.ref import prefix_count_torch
from ..sync import HOST_SYNCS
from ..util import as_device, np_dtype, resolve_impl, to_numpy
from .group_build import group_boundaries_kernel
from .hash_dedup import hash_rows_kernel
from .ref import (
    column_codes_np,
    first_occurrence_ref,
    group_boundaries_ref,
    group_build_np,
    hash_rows_np,
    hash_rows_ref,
)

INT32_MIN = -2**31
INT32_MAX = 2**31 - 1


def _hash_bits(keys: torch.Tensor, impl: str) -> torch.Tensor:
    """(N, C) int32 -> (N,) int32 FNV-1a bits on the resolved impl."""
    return hash_rows_ref(keys) if impl == "ref" else hash_rows_kernel(keys)


def hash_rows(keys: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """(N, C) int32 key matrix -> (N,) uint32 FNV-1a row hashes.
    ``impl``: "kernel" (CUDA) | "ref" (plain torch) | "auto" (kernel on
    a CUDA device, plain torch on the CPU)."""
    impl = resolve_impl(impl, "ref", keys)
    return _hash_bits(keys, impl).view(torch.uint32)


def dedup_mask(keys: torch.Tensor, *, impl: str = "auto",
               return_hashes: bool = False):
    """keys: (N, C) int32 -> bool (N,): True at the first occurrence of
    each distinct key row. ``return_hashes=True`` also returns the (N,)
    uint32 row hashes."""
    impl = resolve_impl(impl, "ref", keys)
    h = _hash_bits(keys, impl)
    m = first_occurrence_ref(h)
    return (m, h.view(torch.uint32)) if return_hashes else m


# ---------------------------------------------------------------- group build

@dataclass(frozen=True)
class GroupBuild:
    """Grouping of an (N, C) int32 key matrix (the reference contract).

    Groups are ordered by ascending 32-bit sort key (the raw key column
    for C == 1, the FNV-1a row hash for C > 1; after a collision repair,
    lexicographically by key row). ``reps[g]`` is the first row of group
    g, ``group_ids[i]`` maps row i to its group, ``order`` lists the rows
    grouped (stable) and ``starts``/``counts`` delimit each group's
    segment inside ``order``. ``sort_keys[i]`` is row i's sort key:
    int32 for C == 1, the uint32 row hash for C > 1.
    """

    num_groups: int
    group_ids: np.ndarray  # (N,) int64
    reps: np.ndarray       # (G,) int64, first occurrence per group
    counts: np.ndarray     # (G,) int64
    starts: np.ndarray     # (G,) int64, exclusive cumsum of counts
    order: np.ndarray      # (N,) int64, rows sorted by group id (stable)
    sort_keys: np.ndarray  # (N,) int32/uint32


def _group_build_device(keys: torch.Tensor, impl: str) -> torch.Tensor:
    """Sort-by-key + boundary scan over an (N, C) int32 key matrix on
    its device. Returns ONE packed int32 buffer ``[num_groups,
    collision, inverse(N), reps(N), counts(N), starts(N), order(N),
    sort_key_bits(N)]`` (reps/counts/starts valid in their first
    num_groups slots) so the host wrapper fetches it in one copy."""
    n, c = keys.shape
    dev = keys.device
    if c == 1:
        sk = keys[:, 0].contiguous()
        sort_bits = sk  # signed key order, exact
    else:
        sk = _hash_bits(keys, impl)
        sort_bits = sk ^ INT32_MIN  # unsigned hash order as int32
    order = torch.argsort(sort_bits, stable=True).to(torch.int32)
    order_l = order.long()
    sk_sorted = sort_bits[order_l].contiguous()
    if impl == "ref":
        bnd, gid = group_boundaries_ref(sk_sorted)
    else:
        bnd, gid = group_boundaries_kernel(sk_sorted)
    num_groups = bnd.sum(dtype=torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    # per-group quantities scatter to their group-id slot; non-boundary
    # rows target the overflow slot n + 1, sliced off. Slots past the
    # last group keep start n, so each group's count is the next
    # group's start minus its own.
    slot = torch.where(bnd != 0, gid, n + 1).long()
    reps = torch.zeros(n + 2, dtype=torch.int32, device=dev)
    reps[slot] = order
    starts = torch.full((n + 2,), n, dtype=torch.int32, device=dev)
    starts[slot] = iota
    counts = starts[1:n + 1] - starts[:n]
    inverse = torch.empty(n, dtype=torch.int32, device=dev)
    inverse[order_l] = gid
    # exact-collision check: every row must equal its representative's
    # key row
    rep_rows = reps[inverse.long()].long()
    collision = (keys[rep_rows] != keys).any().to(torch.int32)
    return torch.cat([num_groups.view(1), collision.view(1), inverse,
                      reps[:n], counts, starts[:n], order, sk])


def _unpack_group_build(buf: np.ndarray, n: int, c: int) -> tuple:
    g, collision = int(buf[0]), bool(buf[1])
    parts = buf[2:].reshape(6, n)
    inverse, reps, counts, starts, order, sk = parts
    sk = sk.copy() if c == 1 else sk.view(np.uint32).copy()
    return g, collision, GroupBuild(
        num_groups=g,
        group_ids=inverse.astype(np.int64),
        reps=reps[:g].astype(np.int64),
        counts=counts[:g].astype(np.int64),
        starts=starts[:g].astype(np.int64),
        order=order.astype(np.int64),
        sort_keys=sk,
    )


def _group_build_exact_host(keys_np: np.ndarray) -> GroupBuild:
    """32-bit hash collision repair: exact regroup by key row, in
    ``np.unique(axis=0)`` lexicographic group order."""
    uniq, reps, inverse, counts = np.unique(
        keys_np, axis=0, return_index=True, return_inverse=True,
        return_counts=True)
    inverse = inverse.reshape(-1)
    g = uniq.shape[0]
    order = np.argsort(inverse, kind="stable")
    starts = np.zeros(g, dtype=np.int64)
    if g:
        np.cumsum(counts[:-1], out=starts[1:])
    return GroupBuild(
        num_groups=g,
        group_ids=inverse.astype(np.int64),
        reps=reps.astype(np.int64),
        counts=counts.astype(np.int64),
        starts=starts,
        order=order.astype(np.int64),
        sort_keys=hash_rows_np(keys_np),
    )


def _group_build_host(keys_np: np.ndarray) -> GroupBuild:
    """Pure-numpy group build (the oracle + collision repair)."""
    g, inverse, reps, counts, starts, order, sk = group_build_np(keys_np)
    if keys_np.shape[1] > 1 and \
            not np.array_equal(keys_np[reps][inverse], keys_np):
        return _group_build_exact_host(keys_np)
    return GroupBuild(num_groups=g, group_ids=inverse, reps=reps,
                      counts=counts, starts=starts, order=order,
                      sort_keys=sk)


def _empty_build() -> GroupBuild:
    empty = np.zeros(0, dtype=np.int64)
    return GroupBuild(0, empty, empty, empty, empty, empty,
                      np.zeros(0, dtype=np.uint32))


def group_build(keys, *, impl: str = "auto", device=None) -> GroupBuild:
    """Group build for an (N, C) int32 host key matrix.

    On device impls the keys are uploaded to ``device`` (the CPU when
    None) and one device pass plus ONE device→host fetch (site
    ``"group_build"``) produce the full segment structure; see
    ``GroupBuild`` for the field contract. The result is always exact:
    C == 1 sorts by the raw key, and C > 1 hash collisions are detected
    by a single comparison and repaired host-side.
    """
    keys_np = np.ascontiguousarray(to_numpy(keys), dtype=np.int32)
    if keys_np.ndim != 2:
        raise ValueError(f"keys must be (N, C), got {keys_np.shape}")
    n, c = keys_np.shape
    if n == 0:
        return _empty_build()
    dev = as_device(device)
    impl = resolve_impl(impl, "host", dev)
    if impl == "host":
        HOST_SYNCS.fallback("group_build")
        return _group_build_host(keys_np)
    buf = _group_build_device(torch.from_numpy(keys_np).to(dev), impl)
    buf = buf.cpu().numpy()
    HOST_SYNCS.tick(site="group_build")
    _, collision, gb = _unpack_group_build(buf, n, c)
    if collision:
        # rare 32-bit hash collision: exact host regroup (np.unique)
        HOST_SYNCS.fallback("group_build_collision")
        return _group_build_exact_host(keys_np)
    return gb


# --------------------------------------------------------- code assignment

def _sortable_bits(col: torch.Tensor):
    """Order-preserving map of a device-width column to int32 sort bits
    (the signed view of the reference's biased uint32 bits), plus the
    rows that must always open a fresh group (NaN keys). -0.0 is
    canonicalised to +0.0 by comparison, and NaN is pinned to the top
    of the sort space (INT32_MAX), which no other float reaches."""
    if col.dtype.is_floating_point:
        isn = torch.isnan(col)
        x = col.to(torch.float32)
        x = torch.where(x == 0.0, torch.zeros_like(x), x)
        b = x.view(torch.int32)
        bits = torch.where(b >= 0, b, b ^ INT32_MAX)
        return torch.where(isn, INT32_MAX, bits), isn
    none = torch.zeros(col.shape, dtype=torch.bool, device=col.device)
    if col.dtype in (torch.uint8, torch.uint16, torch.uint32):
        return (col.to(torch.int64) + INT32_MIN).to(torch.int32), none
    # signed ints / bool: the signed order is the key order
    return col.to(torch.int32), none


def _rank_codes(bits: torch.Tensor, force_new: torch.Tensor,
                impl: str) -> torch.Tensor:
    """Dense rank codes for one column: stable sort, boundary flags
    (``force_new`` rows — NaN keys — always open a group), running count
    of the flags (the prefix-count kernel on device impls), scatter back
    to row order."""
    n = bits.shape[0]
    order = torch.argsort(bits, stable=True)
    sb = bits[order]
    sf = force_new[order]
    prev = torch.cat([sb[:1] ^ 1, sb[:-1]])
    bnd = ((sb != prev) | sf).to(torch.int32)
    psum = (prefix_count_torch(bnd) if impl == "ref"
            else prefix_count_kernel(bnd))
    codes = torch.empty(n, dtype=torch.int32, device=bits.device)
    codes[order] = psum - 1
    return codes


def _device_width(col) -> bool:
    """True when a column can take the device code-assignment path
    (narrow numeric/bool — exactly the dtypes ``as_column`` puts on a
    device; strings and 64-bit numerics stay with the host oracle)."""
    try:
        dt = np_dtype(col)
    except (AttributeError, TypeError):
        return False
    return dt.kind in "iufb" and dt.itemsize <= 4


def group_build_columns(key_columns, *, impl: str = "auto", device=None
                        ) -> tuple[np.ndarray, GroupBuild]:
    """Device code assignment + group build for arbitrary-dtype key
    columns: the grouped-aggregation entry point.

    Returns ``(codes, gb)``: the (N, C) int32 per-column rank codes
    (order-isomorphic to the values, NaN keys distinct — the
    ``column_codes_np`` contract) and the ``GroupBuild`` over the code
    rows. On device impls the code assignment, the row-wise group build
    and the collision check run on the columns' device (the first
    tensor column's, else ``device``) and come back in ONE fetch (site
    ``"group_build_columns"``). ``"host"`` is the exact numpy oracle,
    recorded as a ``host_fallbacks["group_key_codes"]`` serving, and so
    is any column of non-device width.
    """
    if not key_columns:
        raise ValueError("group_build_columns needs at least one column")
    n = int(np.shape(key_columns[0])[0])
    c = len(key_columns)
    if n == 0:
        return np.zeros((0, c), dtype=np.int32), _empty_build()
    tensors = [k for k in key_columns if isinstance(k, torch.Tensor)]
    dev = tensors[0].device if tensors else as_device(device)
    impl = resolve_impl(impl, "host", dev)
    if impl != "host" and not all(_device_width(k) for k in key_columns):
        impl = "host"
    if impl == "host":
        HOST_SYNCS.fallback("group_key_codes")
        codes = column_codes_np([to_numpy(k) for k in key_columns])
        return codes, _group_build_host(codes)
    cols = [k.to(dev) if isinstance(k, torch.Tensor)
            else torch.as_tensor(np.asarray(k), device=dev)
            for k in key_columns]
    codes_t = torch.stack([_rank_codes(*_sortable_bits(col), impl)
                           for col in cols], dim=1)
    buf = torch.cat([codes_t.reshape(-1), _group_build_device(codes_t, impl)])
    buf = buf.cpu().numpy()
    HOST_SYNCS.tick(site="group_build_columns")
    codes = np.ascontiguousarray(buf[:n * c].reshape(n, c))
    _, collision, gb = _unpack_group_build(buf[n * c:], n, c)
    if collision:
        # rare 32-bit hash collision over code rows: exact host regroup
        HOST_SYNCS.fallback("group_build_collision")
        return codes, _group_build_exact_host(codes)
    return codes, gb


def dedup_representatives(keys, *, impl: str = "auto",
                          return_hashes: bool = False, device=None):
    """Host-facing dedup for the semantic batch pipeline.

    keys: (N, C) int32 — one row per candidate LLM invocation, columns
    are the referenced base tables' row_ids. Returns numpy arrays
    ``(mask, reps, inverse)``: first-occurrence mask, the first row of
    each distinct key in ascending row order, and the map from each row
    to its representative. ``return_hashes=True`` appends the (G,)
    uint32 per-representative sort keys (the row hashes for C > 1) for
    the function cache's key-probe fast path. Built on ``group_build``
    (on ``device``); only the G-sized reorder happens here.
    """
    keys_np = np.ascontiguousarray(to_numpy(keys), dtype=np.int32)
    n = keys_np.shape[0]
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        out = (np.zeros(0, dtype=bool), empty, empty)
        return out + (np.zeros(0, dtype=np.uint32),) if return_hashes else out
    gb = group_build(keys_np, impl=impl, device=device)
    # groups come back in sort-key order; reorder into ascending row
    # order so first-seen semantics match per-row execution exactly
    order = np.argsort(gb.reps)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    reps = gb.reps[order]
    inverse = rank[gb.group_ids]
    mask = np.zeros(n, dtype=bool)
    mask[reps] = True
    if return_hashes:
        hashes = np.asarray(gb.sort_keys)[reps].astype(np.uint32)
        return mask, reps, inverse, hashes
    return mask, reps, inverse
