"""Tensor-, expert- and data-parallel execution of the model over a
``ModelMesh`` (no reference counterpart: this is what GSPMD and
``shard_map`` do for the reference's sharded ``jit``).

The mesh is read as a (DP, TP) grid: DP data-parallel ranks (the
policy's ``dp_axes``, 'pod' and 'data', flattened row-major in mesh
order) by TP tensor-parallel ranks (its ``tp_axis``, 'model'). Under
``dp_over_tp`` (pure data parallelism over both axes: the batch over
``dp_axes + (tp_axis,)``, every parameter replicated) the grid is
dp·tp data ranks, row-major as the policy orders the batch's axes, by
TP = 1.
Position (i, t) of the grid is a device of the mesh, and every loop of
the port's sharded model runs over these positions, each on its own
device, so the same code serves distinct cards and shards that share
one card.

* ``Sharded`` — one tensor laid out over the grid: ``parts[i, t]`` is
  the local tensor on the device of (i, t), ``index[i, t]`` the slices
  of the global tensor it holds. A dimension split over mesh axes of
  total size n is cut into chunks of ceil(size / n), row-major over
  the named axes (a trailing chunk may be shorter or empty, where
  GSPMD pads). The query heads follow that rule (``head_range``:
  hymba-1.5b's 25 over 2 are 13 + 12, over 4 7 + 7 + 7 + 4). The
  grouped-query KV heads are the exception: rank t holds the KV heads
  its query heads read (``kv_range``), so a KV head count that does
  not divide TP (starcoder2-3b's 2 over 4), a replicated KV spec
  (``shard_kv_heads=False``) or query heads that straddle groups
  (hymba's rank 0 of 2 reads KV heads 0-2, rank 1 KV heads 2-4) give
  each rank the heads it needs; two ranks' KV ranges may then overlap
  in part, and ``Sharded.slices`` cuts them into disjoint pieces. A
  rank's query heads attend in runs (``head_runs``), each inside one
  KV head's group or over whole groups, one kernel call a run.
  Positions on one device that hold the same slice share one tensor,
  so a tree sharded over one card holds each weight once. ``unshard``
  writes the parts back into one global tensor.
* ``Rows`` — activations: a global batch of ``n`` rows, data-parallel
  rank i holding rows [i·c, (i+1)·c), c = ceil(n / DP), the last
  chunk padded with zero rows (GSPMD's padding), replicated over the
  TP ranks.
* ``gmap`` runs a function at every position; positions whose
  arguments are the same objects (replicated work on a shared device)
  run it once and share the result.
* ``all_reduce`` sums over the TP ranks (or over every rank) in rank
  order on each receiving device; ``all_gather`` concatenates over
  the TP ranks in rank order.
* ``local_grid`` hands each position its parameters, the FSDP
  (``embed``) dimension gathered over the data-parallel ranks at use.
* ``shard_cache_seq`` (``seq_sharded``): the K/V, ``slot_pos`` and MLA
  latent cache leaves split over the sequence (``kv_seq``) across the
  TP ranks, rank t holding positions [t·c, (t+1)·c), c = ceil(T / TP)
  (``seq_slice``; the last slice shorter, or empty), of every KV head
  (the reference's ``cache_specs`` drops ``kv_heads`` there, so
  ``kv_range`` does not apply). Decode attends over each slice and
  ``combine_partials`` merges the slices' outputs by their
  log-sum-exps, in rank order.
* Training: every collective above is built of ``.to``, ``cat`` and
  ``add``, so autograd runs back through it (the FSDP gather's
  backward adds each position's gradient of a part into that part: the
  reduce-scatter). ``sum_replicas`` makes the gradients of the
  positions that hold one slice on different devices equal (GSPMD's
  gradient all-reduce), and ``slices`` visits each distinct global
  slice once (the gradient norm, checkpoints, ``unshard``).

* The dry run's batch that does not divide the data axes
  (``launch/dryrun.py``, the reference's fallback: ``dp_axes`` empty,
  the parameters still FSDP over the data axes): the grid's data ranks
  are those axes, each holding the whole batch (``MeshGrid.replicas``).
* ``tally_collectives``: while on, every exchange point above adds the
  bytes each receiving position takes from others (``_tally``: the
  result's bytes; an all-reduce's twice, as the reference's dry run
  counts a ring) by kind, whether or not the positions share a device
  (the dry run's positions all lie on ``meta``), and, when autograd
  carries a gradient back through it, its backward (an all-reduce
  again, an all-gather's reduce-scatter: ``_tally_backward``); off, it
  costs one global read a position.

No ``torch.distributed``: one process drives every position, as the
partitioned data tier does (``sharding/data.py``), so a mesh over
shards of one card needs no process group.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
from typing import Callable, Optional

import numpy as np
import torch

from .policy import PartitionSpec, ShardingPolicy


# the dry run's collective tally (``tally_collectives``); None when off
TALLY: Optional[dict] = None
# the dry run's hook around each ``gmap`` call (``around_calls``): it
# measures a position's transient bytes; None when off
AROUND: Optional[Callable] = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _add(kind: str, nbytes: float) -> None:
    TALLY[kind] = TALLY.get(kind, 0.0) + nbytes
    counts = TALLY.setdefault("_counts", {})
    counts[kind] = counts.get(kind, 0) + 1


def _tally(kind: str, t: torch.Tensor, times: float = 1.0) -> None:
    """Add the bytes of ``t`` (``times`` over) to the tally's ``kind``."""
    _add(kind, _nbytes(t) * times)


def _tally_backward(t: torch.Tensor, kind: str, nbytes: float) -> None:
    """Tally ``kind`` of ``nbytes`` when autograd carries a gradient back
    through ``t`` (the exchange's backward; a hook fires once a backward
    pass, so a layer recomputed under remat counts once)."""
    if t.requires_grad:
        def hook(_):
            if TALLY is not None:
                _add(kind, nbytes)
        t.register_hook(hook)


@contextlib.contextmanager
def tally_collectives():
    """While open, the exchange points tally the bytes each receiving
    position takes from other positions, by kind ("all-reduce" twice
    its result's bytes, "all-gather", "reduce-scatter"; module doc).
    Yields the tally dict ({kind: bytes summed over the positions,
    "_counts": {kind: receptions}})."""
    global TALLY
    prev, TALLY = TALLY, {}
    try:
        yield TALLY
    finally:
        TALLY = prev


@contextlib.contextmanager
def around_calls(hook: Callable):
    """While open, ``gmap`` runs each call as ``hook(fn, args)``."""
    global AROUND
    prev, AROUND = AROUND, hook
    try:
        yield
    finally:
        AROUND = prev


class MeshNotPorted(NotImplementedError):
    """A policy knob the model-parallel port does not run: ``ep_over_dp``
    with ``dp_over_tp`` (``check_policy``)."""


# ---------------------------------------------------------------------------
# the (DP, TP) grid of a policy's mesh
# ---------------------------------------------------------------------------


class MeshGrid:
    """A policy's mesh as a (DP, TP) grid of devices (module doc)."""

    def __init__(self, policy: ShardingPolicy):
        mesh = policy.mesh
        names = mesh.axis_names
        shape = mesh.shape
        dp_axes = tuple(a for a in names if a in policy.dp_axes)
        if set(dp_axes) != set(policy.dp_axes):
            raise ValueError(f"dp_axes {policy.dp_axes} not on the mesh "
                             f"{names}")
        tp_axes = (policy.tp_axis,) if policy.tp_axis else ()
        rest = tuple(a for a in names if a not in dp_axes + tp_axes
                     and shape[a] > 1)
        # the reference's dry run replicates a batch that its data axes
        # do not divide (dp_axes empty): those axes' ranks each hold the
        # whole batch, the parameters FSDP over them as before
        self.replicas = bool(rest) and not dp_axes and not policy.dp_over_tp
        if rest and not self.replicas:
            raise MeshNotPorted(f"mesh axes {list(rest)} are neither data- "
                                f"nor tensor-parallel under this policy")
        if self.replicas:
            dp_axes = rest
        order = [names.index(a) for a in dp_axes + tp_axes] + [
            names.index(a) for a in names if a not in dp_axes + tp_axes]
        if policy.dp_over_tp:  # the batch's axes: dp_axes + (tp_axis,)
            dp_axes, tp_axes = dp_axes + tp_axes, ()
        self.dp_axes = dp_axes
        self.tp_axis = tp_axes[0] if tp_axes else None
        self.dp = int(np.prod([shape[a] for a in dp_axes]))
        self.tp = shape[self.tp_axis] if self.tp_axis else 1
        self.sizes = shape
        self.devices = mesh.devices.transpose(order).reshape(self.dp,
                                                             self.tp)

    def coords(self):
        return [(i, t) for i in range(self.dp) for t in range(self.tp)]

    def axis_coord(self, i: int, t: int) -> dict:
        """Each mesh axis's coordinate at grid position (i, t)."""
        out = {}
        for a in reversed(self.dp_axes):
            out[a] = i % self.sizes[a]
            i //= self.sizes[a]
        if self.tp_axis:
            out[self.tp_axis] = t
        return out


def on_mesh(policy: Optional[ShardingPolicy]) -> bool:
    """True when ``policy`` spreads the model over more than one mesh
    position (the sharded code paths run)."""
    return policy is not None and policy.active


@functools.lru_cache(maxsize=32)
def mesh_grid(policy: ShardingPolicy) -> MeshGrid:
    return MeshGrid(policy)


def home_device(policy: ShardingPolicy) -> torch.device:
    """Where a mesh engine keeps its slot state and gathered logits:
    the device of grid position (0, 0)."""
    return mesh_grid(policy).devices[0, 0]


def check_policy(policy: ShardingPolicy) -> None:
    """The policy knobs the sharded model runs: batch over the data
    axes, heads/mlp/vocab/expert over the model axis (experts over
    both with ``ep_over_dp``), KV heads sharded or not, FSDP on or
    off, pure data parallelism over both axes (``dp_over_tp``),
    ``seq_parallel`` (which changes no function: no model code of the
    reference constrains an activation to 'seq') and
    ``shard_cache_seq`` (the caches over the sequence: ``seq_sharded``).
    ``ep_over_dp`` with ``dp_over_tp`` raises, where the reference's
    expert windows (over dp·tp·tp ranks) do not match the experts its
    ranks hold (over dp·tp)."""
    if policy.ep_over_dp and policy.dp_over_tp:
        raise MeshNotPorted("ShardingPolicy.ep_over_dp with dp_over_tp is "
                            "not run by the model-parallel port")
    fsdp = tuple(a for a in policy.fsdp_axes
                 if policy.mesh.shape.get(a, 1) > 1)
    data = policy.dp_axes or tuple(
        a for a in policy.mesh.axis_names if a != policy.tp_axis
        and policy.mesh.shape[a] > 1)  # the dry run's replicated batch
    if policy.fsdp_params and fsdp and fsdp != tuple(
            a for a in data if policy.mesh.shape.get(a, 1) > 1):
        raise MeshNotPorted("FSDP over axes other than the data axes")


def seq_sharded(policy: Optional[ShardingPolicy]) -> bool:
    """True when the policy's caches lie over the sequence across more
    than one tensor-parallel rank (``shard_cache_seq`` at TP > 1; under
    ``dp_over_tp`` ``kv_seq`` maps to no axis, and the grid has TP =
    1)."""
    return (on_mesh(policy) and policy.shard_cache_seq
            and mesh_grid(policy).tp > 1)


def seq_slice(T: int, tp: int, t: int) -> tuple[int, int]:
    """(lo, n): the cache positions [lo, lo + n) of T that
    tensor-parallel rank t of ``tp`` holds under ``shard_cache_seq``,
    chunks of ceil(T / tp) as ``leaf_index`` cuts them."""
    c = -(-T // tp)
    lo = min(t * c, T)
    return lo, min(lo + c, T) - lo


def _grid(g: MeshGrid) -> np.ndarray:
    return np.empty((g.dp, g.tp), dtype=object)


# ---------------------------------------------------------------------------
# sharded tensors
# ---------------------------------------------------------------------------


def head_range(num_heads: int, tp: int, t: int) -> tuple[int, int]:
    """The query heads [lo, hi) of tensor-parallel rank ``t`` of ``tp``:
    chunks of ceil(H / tp), as ``leaf_index`` cuts the ``heads``
    dimension (the last chunk shorter, or empty)."""
    c = -(-num_heads // tp)
    lo = min(t * c, num_heads)
    return lo, min(lo + c, num_heads)


def kv_range(num_heads: int, num_kv_heads: int, tp: int, t: int
             ) -> tuple[int, int]:
    """The KV heads [lo, hi) that tensor-parallel rank ``t`` of ``tp``
    reads: query head h reads KV head h // g (g = H / K), so the rank's
    query heads [a, b) (``head_range``) read KV heads a // g to
    (b - 1) // g. A rank may hold whole groups, lie inside one group or
    straddle groups (hymba-1.5b's 25 over 5 at tp 2: KV heads 0-2 and
    2-4); a rank with no query heads reads none."""
    H, K = num_heads, num_kv_heads
    if K <= 0 or H % K:
        raise ValueError(f"{H} query heads over {K} KV heads")
    a, b = head_range(H, tp, t)
    g = H // K
    if a == b:
        return min(a // g, K), min(a // g, K)
    return a // g, (b - 1) // g + 1


def head_runs(num_heads: int, num_kv_heads: int, tp: int, t: int
              ) -> list[tuple[int, int, int, int]]:
    """Rank ``t``'s query heads as runs (qa, qb, ka, kb) in the rank's
    local numbering: query heads [qa, qb) read KV heads [ka, kb), the
    same number of query heads a KV head (adjacent KV heads whose counts
    agree merge into one run). Whole groups and a rank inside one group
    are one run; a rank that straddles groups has up to three (a
    partial group, whole groups, a partial group), each one K7 or K8
    call at a group size the kernels take."""
    a, b = head_range(num_heads, tp, t)
    lo, hi = kv_range(num_heads, num_kv_heads, tp, t)
    g = num_heads // num_kv_heads
    runs: list[list[int]] = []
    q = 0
    for j in range(lo, hi):
        n = min(b, (j + 1) * g) - max(a, j * g)
        last = runs[-1] if runs else None
        if last and (last[1] - last[0]) == n * (last[3] - last[2]):
            last[1] += n
            last[3] += 1
        else:
            runs.append([q, q + n, j - lo, j - lo + 1])
        q += n
    return [tuple(r) for r in runs]


@functools.lru_cache(maxsize=64)
def run_grid(num_heads: int, num_kv_heads: int, policy: ShardingPolicy
             ) -> np.ndarray:
    """Each position's ``head_runs`` where its query heads need more than
    one run (or none: a rank without query heads), else None (the
    heads not split over the tensor ranks, or one run: the attention
    call is the one-device call). Positions of one tensor rank share
    one object, so ``gmap`` keeps their sharing."""
    g = mesh_grid(policy)
    out = _grid(g)
    heads_tp = g.tp > 1 and policy.spec("heads")[0] == policy.tp_axis
    per_t = {}
    for t in range(g.tp):
        runs = (head_runs(num_heads, num_kv_heads, g.tp, t)
                if heads_tp and num_heads else None)
        per_t[t] = None if runs is None or len(runs) == 1 else tuple(runs)
    for i, t in g.coords():
        out[i, t] = per_t[t]
    return out


def kv_pieces(num_heads: int, num_kv_heads: int, tp: int
              ) -> list[tuple[int, int, int]]:
    """(t, a, b): the KV heads [a, b) of rank t's local range that,
    concatenated in rank order, give every KV head once: each rank
    whose ``kv_range`` reaches past the ranks before it, from the first
    head they did not hold (ranks inside one group share its range;
    straddling ranks overlap in a head)."""
    out, end = [], 0
    for t in range(tp):
        lo, hi = kv_range(num_heads, num_kv_heads, tp, t)
        if hi > end:
            out.append((t, end - lo, hi - lo))
            end = hi
    return out


def kv_owners(num_heads: int, num_kv_heads: int, tp: int) -> list[int]:
    """The tensor-parallel ranks of ``kv_pieces``, in rank order."""
    return [t for t, _, _ in kv_pieces(num_heads, num_kv_heads, tp)]


def dedupe_spec(spec) -> PartitionSpec:
    """Drop an entry that names a mesh axis an earlier entry already
    used (the reference's ``cache_specs`` rule; a parameter spec meets
    it under ``ep_over_dp``, whose experts take the data axis that
    FSDP also names)."""
    out, seen = [], set()
    for a in spec:
        names = a if isinstance(a, tuple) else (a,)
        out.append(None if any(n in seen for n in names if n) else a)
        seen.update(n for n in names if n)
    return PartitionSpec(*out)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def leaf_index(g: MeshGrid, shape, spec, i: int, t: int,
               kv: Optional[tuple[int, int]] = None,
               kv_dims: tuple = ()) -> tuple:
    """The slices of a global tensor of ``shape`` under ``spec`` that
    grid position (i, t) holds (module doc); dimensions in ``kv_dims``
    take the KV heads [lo, hi) = ``kv`` of rank t."""
    coord = g.axis_coord(i, t)
    idx = []
    for dim, (size, entry) in enumerate(zip(shape, spec)):
        if dim in kv_dims:
            idx.append(slice(*kv))
            continue
        names = _names(entry)
        if not names:
            idx.append(slice(None))
            continue
        n, r = 1, 0
        for a in names:
            n *= g.sizes[a]
            r = r * g.sizes[a] + coord[a]
        c = -(-size // n)
        lo = min(r * c, size)
        idx.append(slice(lo, min(lo + c, size)))
    return tuple(idx)


class Sharded:
    """One tensor laid out over a policy's grid (module doc)."""

    def __init__(self, shape, dtype, spec, parts: np.ndarray,
                 index: np.ndarray, fsdp_dims: tuple = ()):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.spec = PartitionSpec(*spec)
        self.parts = parts
        self.index = index
        self.fsdp_dims = fsdp_dims

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.spec}, grid "
                f"{self.parts.shape})")

    def unshard(self, device=None) -> torch.Tensor:
        """The global tensor, each distinct slice written once from its
        first holder in rank order (parts holding the same slice
        agree)."""
        dev = device if device is not None else self.parts[0, 0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for idx, (first, *_) in self.slices():
            out[idx] = self.piece(first, idx).to(dev)
        return out

    def slices(self) -> list[tuple[tuple, list]]:
        """(index, holders) of each distinct global slice, in rank order
        i·TP + t of its first holder; ``holders`` are the positions
        (i, t) whose part holds it, in rank order. The slices tile the
        global tensor: where every two parts' slices are equal or
        disjoint (chunks, and KV ranges of whole groups or one group)
        they are the parts' own slices; where two ranks' KV ranges
        overlap in part (query heads that straddle groups) each part's
        slice is cut at every other part's bounds into pieces, and
        ``piece`` gives a holder's view of one."""
        n = len(self.shape)
        bounds = [set() for _ in range(n)]
        norm = {}
        for i, t in np.ndindex(*self.parts.shape):
            k = tuple(s.indices(m)[:2] for s, m in
                      zip(self.index[i, t], self.shape))
            norm[i, t] = k
            for d, (a, b) in enumerate(k):
                bounds[d].update((a, b))
        cuts = [sorted(b) for b in bounds]
        out: dict = {}
        for (i, t), k in norm.items():
            spans = [[(c0, c1) for c0, c1 in zip(cuts[d], cuts[d][1:])
                      if a <= c0 and c1 <= b] for d, (a, b) in enumerate(k)]
            if any(not sp for sp in spans):  # an empty part
                spans = [[(a, b)] for a, b in k]
            for cell in itertools.product(*spans):
                idx = (self.index[i, t] if cell == k
                       else tuple(slice(a, b) for a, b in cell))
                out.setdefault(cell, (idx, []))[1].append((i, t))
        return list(out.values())

    def local(self, pos, idx) -> tuple[tuple, bool]:
        """(the slices of the part at ``pos`` that hold the global slice
        ``idx``, whether they are the whole part)."""
        local, whole = [], True
        for s, o, m in zip(idx, self.index[pos], self.shape):
            a, b, _ = s.indices(m)
            oa, ob, _ = o.indices(m)
            whole &= (a, b) == (oa, ob)
            local.append(slice(a - oa, b - oa))
        return tuple(local), whole

    def piece(self, pos, idx) -> torch.Tensor:
        """The part at ``pos``'s view of the global slice ``idx`` (one of
        ``slices``' pieces it holds): the part itself where the piece is
        its whole slice."""
        local, whole = self.local(pos, idx)
        return self.parts[pos] if whole else self.parts[pos][local]

    def distinct(self) -> list[tuple[tuple, torch.Tensor]]:
        """((i, t), part) of each distinct part object once, at its first
        position in rank order (positions on one device that hold the
        same slice share one part)."""
        seen: dict = {}
        for (i, t), part in np.ndenumerate(self.parts):
            seen.setdefault(id(part), ((i, t), part))
        return list(seen.values())

    def map(self, fn: Callable, dtype=None) -> "Sharded":
        """``fn`` of each distinct part once, laid out as this tensor
        (same index, same sharing)."""
        made: dict = {}
        parts = np.empty(self.parts.shape, dtype=object)
        for (i, t), part in np.ndenumerate(self.parts):
            if id(part) not in made:
                made[id(part)] = fn(part)
            parts[i, t] = made[id(part)]
        return Sharded(self.shape, self.dtype if dtype is None else dtype,
                       self.spec, parts, self.index, self.fsdp_dims)

    def layers(self, n: int) -> list["Sharded"]:
        """The ``n`` slices of a stacked (L, ...) leaf, views of the
        parts, each part unbound once (so the backward stacks the L
        layers' gradients into it once, where a view a layer would add
        a zero (L, ...) gradient a layer); a part shared by several
        positions gives them one view per layer."""
        views: dict = {}
        out = []
        for l in range(n):
            parts = np.empty(self.parts.shape, dtype=object)
            index = np.empty(self.parts.shape, dtype=object)
            for (i, t), part in np.ndenumerate(self.parts):
                if id(part) not in views:
                    views[id(part)] = torch.unbind(part)
                parts[i, t] = views[id(part)][l]
                index[i, t] = self.index[i, t][1:]
            out.append(Sharded(self.shape[1:], self.dtype, self.spec[1:],
                               parts, index,
                               tuple(d - 1 for d in self.fsdp_dims)))
        return out


def _key(idx) -> tuple:
    return tuple((s.start, s.stop) for s in idx)


def _lay_out(shape, g: MeshGrid, spec, kv, kv_dims, make):
    """(parts, index) of a tensor of ``shape`` under ``spec``, each part
    ``make(idx, device)``; positions on one device holding the same
    slice share one part."""
    parts, index, made = _grid(g), _grid(g), {}
    for i, t in g.coords():
        idx = leaf_index(g, shape, spec, i, t, kv(t) if kv_dims else None,
                         kv_dims)
        dev = g.devices[i, t]
        key = (str(dev), _key(idx))
        if key not in made:
            made[key] = make(idx, dev)
        parts[i, t], index[i, t] = made[key], idx
    return parts, index


def split(x: torch.Tensor, g: MeshGrid, spec, kv=None, kv_dims=(),
          fsdp_dims=()) -> Sharded:
    """``x`` laid out over ``g`` under ``spec`` (``kv(t)`` the KV range
    of rank t for the dimensions ``kv_dims``), each part a contiguous
    copy on its position's device."""
    def copy(idx, dev):
        src = x[idx]
        return torch.empty(src.shape, dtype=x.dtype, device=dev).copy_(src)

    parts, index = _lay_out(x.shape, g, spec, kv, kv_dims, copy)
    return Sharded(x.shape, x.dtype, spec, parts, index, fsdp_dims)


def part_shape(shape, idx) -> tuple:
    """The shape of the part at slices ``idx`` of a tensor of ``shape``."""
    return tuple(len(range(*s.indices(n))) for s, n in zip(idx, shape))


def zeros(shape, dtype, g: MeshGrid, spec, kv=None, kv_dims=(),
          fill=0) -> Sharded:
    """A ``Sharded`` of ``fill`` without a global tensor."""
    def full(idx, dev):
        return torch.full(part_shape(shape, idx), fill, dtype=dtype,
                          device=dev)

    parts, index = _lay_out(shape, g, spec, kv, kv_dims, full)
    return Sharded(shape, dtype, spec, parts, index)


def like(ref: Sharded, make: Callable, dtype, last: Optional[int] = None
         ) -> Sharded:
    """A tensor laid out as ``ref`` (its positions, devices, slices and
    sharing), the part at slices ``idx`` on ``dev`` ``make(idx, dev)``.
    With ``last`` the last dimension is whole, of size ``last``, at
    every position (the spec's last entry None): the layout of an int8
    moment's block scales beside its parameter."""
    shape, spec = ref.shape, ref.spec
    if last is not None:
        shape = (*shape[:-1], last)
        spec = PartitionSpec(*spec[:-1], None)
    parts, index, made = (np.empty(ref.parts.shape, dtype=object),
                          np.empty(ref.parts.shape, dtype=object), {})
    for (i, t), part in np.ndenumerate(ref.parts):
        idx = ref.index[i, t]
        if last is not None:
            idx = (*idx[:-1], slice(0, last))
        key = (str(part.device), _key(idx))
        if key not in made:
            made[key] = make(idx, part.device)
        parts[i, t], index[i, t] = made[key], idx
    return Sharded(shape, dtype, spec, parts, index, ref.fsdp_dims)


def split_like(x: torch.Tensor, ref: Sharded) -> Sharded:
    """The global tensor ``x`` laid out as ``ref`` (``like``; ``x``'s
    shape is ``ref``'s, or ``ref``'s but for a whole last dimension)."""
    last = None if tuple(x.shape) == ref.shape else x.shape[-1]

    def copy(idx, dev):
        src = x[idx]
        return torch.empty(src.shape, dtype=x.dtype, device=dev).copy_(src)

    return like(ref, copy, x.dtype, last)


def sum_replicas(x: Sharded) -> Sharded:
    """``x`` (a gradient) with the parts of every slice that several
    devices hold replaced by their sum, added in rank order i·TP + t of
    each part's first holder on each holder's device, as
    ``all_reduce(over="all")`` adds: the gradient all-reduce of the
    replicated parameters (norms over TP, every leaf without FSDP over
    the data ranks, KV heads that ``kv_range`` gives several ranks; a
    KV head two straddling ranks share is a piece of each part, summed
    into a copy of it). Positions on one device that share a part hold
    one gradient, accumulated by autograd, and count once. Every holder
    ends with the same bits."""
    parts = x.parts.copy()
    copies: dict = {}
    for idx, holders in x.slices():
        if TALLY is not None and len(holders) > 1:
            for p in holders:
                _tally("all-reduce", x.piece(p, idx), 2.0)
        objs = {}
        for p in holders:
            objs.setdefault(id(x.parts[p]), p)
        if len(objs) < 2:
            continue
        made: dict = {}
        for p in holders:
            part = x.parts[p]
            local, whole = x.local(p, idx)
            if id(part) not in made:
                made[id(part)] = functools.reduce(
                    torch.add, [x.piece(q, idx).to(part.device)
                                for q in objs.values()])
                if not whole:
                    if id(part) not in copies:
                        copies[id(part)] = part.clone()
                    copies[id(part)][local] = made[id(part)]
            if whole:
                parts[p] = made[id(part)]
    for p in np.ndindex(*parts.shape):
        if id(x.parts[p]) in copies:
            parts[p] = copies[id(x.parts[p])]
    return Sharded(x.shape, x.dtype, x.spec, parts, x.index, x.fsdp_dims)


def unshard(tree, device=None):
    """A tree of ``Sharded`` leaves as global tensors (on ``device``,
    default each leaf's first part's)."""
    if isinstance(tree, dict):
        return {k: unshard(v, device) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.unshard(device)
    return tree


def local_grid(tree: dict, g: MeshGrid) -> np.ndarray:
    """A grid of per-position parameter dicts: each leaf's part, with its
    FSDP dimension gathered (concatenated in data-parallel rank order)
    onto the position's device. Positions on one device with the same
    parts share one gathered tensor, and positions whose every leaf is
    the same tensor (weights replicated over the tensor-parallel ranks
    of a shared device: the SSM's) share one dict, so ``gmap`` runs
    their work once. (No nested recursive closure: it would hold the
    gathered tensors in a reference cycle until the cycle collector
    ran, every layer's at once.)"""
    out, made, same = _grid(g), {}, {}
    for i, t in g.coords():
        loc = _local_tree(tree, g, i, t, made)
        out[i, t] = same.setdefault(tuple(map(id, _leaves(loc))), loc)
    return out


def _leaves(node) -> list:
    if isinstance(node, dict):
        return [x for v in node.values() for x in _leaves(v)]
    return [node]


def _local_tree(node, g: MeshGrid, i: int, t: int, made: dict):
    if isinstance(node, dict):
        return {k: _local_tree(v, g, i, t, made) for k, v in node.items()}
    if not node.fsdp_dims:
        return node.parts[i, t]
    dev = g.devices[i, t]
    parts = [node.parts[j, t] for j in range(g.dp)]
    key = (str(dev), tuple(id(p) for p in parts))
    if key not in made:
        (dim,) = node.fsdp_dims
        made[key] = torch.cat([p.to(dev) for p in parts], dim=dim)
    if TALLY is not None:
        _tally("all-gather", made[key])
        # the backward's reduce-scatter of the gathered gradient
        _tally_backward(made[key], "reduce-scatter",
                        _nbytes(node.parts[i, t]))
    return made[key]


def local_config(cfg, g: MeshGrid, t: int = 0):
    """``cfg`` at tensor-parallel rank ``t``'s widths: its query heads
    (``head_range``), the KV heads it reads (``kv_range``), its share
    of ``d_ff`` and of the experts (``head_dim`` pinned to the model's).
    The SSM family has no attention heads: only ``d_ff`` and the
    experts change."""
    a, b = head_range(cfg.num_heads, g.tp, t)
    lo, hi = (kv_range(cfg.num_heads, cfg.num_kv_heads, g.tp, t)
              if cfg.num_heads else (0, 0))
    return cfg.replace(
        num_heads=b - a, num_kv_heads=hi - lo,
        head_dim=cfg.resolved_head_dim, d_ff=-(-cfg.d_ff // g.tp),
        num_experts=cfg.num_experts // g.tp)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


class Rows:
    """A global batch of ``n`` rows over a grid (module doc)."""

    def __init__(self, grid: np.ndarray, n: int):
        self.grid = grid
        self.n = n

    @property
    def chunk(self) -> int:
        return self.grid[0, 0].shape[0]

    @property
    def padded(self) -> bool:
        return self.chunk * self.grid.shape[0] != self.n

    def gather(self, device=None) -> torch.Tensor:
        """The global (n, ...) tensor on ``device`` (default (0, 0)'s)."""
        dev = device if device is not None else self.grid[0, 0].device
        return torch.cat([self.grid[i, 0].to(dev)
                          for i in range(self.grid.shape[0])])[:self.n]


def scatter_rows(x: torch.Tensor, g: MeshGrid) -> Rows:
    """``x`` (n, ...) as ``Rows``: chunk i of ceil(n / DP) rows (zero
    rows after the last) on every device of data-parallel rank i."""
    n = x.shape[0]
    if g.replicas:  # every data rank holds the whole batch
        grid, made = _grid(g), {}
        for i, t in g.coords():
            dev = g.devices[i, t]
            if str(dev) not in made:
                made[str(dev)] = x.to(dev)
            grid[i, t] = made[str(dev)]
        return Rows(grid, n)
    c = -(-n // g.dp)
    if c * g.dp != n:
        x = torch.cat([x, x.new_zeros((c * g.dp - n, *x.shape[1:]))])
    grid, made = _grid(g), {}
    for i, t in g.coords():
        dev = g.devices[i, t]
        key = (str(dev), i)
        if key not in made:
            made[key] = x[i * c:(i + 1) * c].to(dev)
        grid[i, t] = made[key]
    return Rows(grid, n)


def gmap(fn: Callable, *args):
    """``fn`` at every grid position over the positions' values of
    ``args`` (``Rows``, grids, or values passed whole); positions with
    identical argument objects share one call. Returns ``Rows`` (with
    the first ``Rows`` argument's ``n``) or a grid."""
    grids = [a.grid if isinstance(a, Rows) else a for a in args]
    shape = next(a.shape for a in grids if isinstance(a, np.ndarray))
    out, made = np.empty(shape, dtype=object), {}
    for i, t in np.ndindex(*shape):
        vals = [a[i, t] if isinstance(a, np.ndarray) else a for a in grids]
        key = tuple(id(v) for v in vals)
        if key not in made:
            made[key] = fn(*vals) if AROUND is None else AROUND(fn, vals)
        out[i, t] = made[key]
    rows = next((a for a in args if isinstance(a, Rows)), None)
    return Rows(out, rows.n) if rows is not None else out


def unzip(grid: np.ndarray, n: int) -> list[np.ndarray]:
    """A grid of n-tuples as n grids."""
    outs = [np.empty(grid.shape, dtype=object) for _ in range(n)]
    for idx, val in np.ndenumerate(grid):
        for o, v in zip(outs, val):
            o[idx] = v
    return outs


def positions(g: MeshGrid) -> np.ndarray:
    """A grid holding each position's (i, t)."""
    out = _grid(g)
    for i, t in g.coords():
        out[i, t] = (i, t)
    return out


def _collect(x, g: MeshGrid, ranks: Callable, combine: Callable,
             kind: str):
    """Each position receives ``combine`` of the values of ``ranks(i,
    t)``, in that order, moved to its device (one result per distinct
    device and source set); the tally counts ``kind`` at each position
    whose sources are not itself alone."""
    grid = x.grid if isinstance(x, Rows) else x
    out, made = _grid(g), {}
    for i, t in g.coords():
        dev = g.devices[i, t]
        srcs = ranks(i, t)
        src = [grid[r] for r in srcs]
        key = (str(dev), tuple(id(s) for s in src))
        if key not in made:
            made[key] = combine([s.to(dev) for s in src])
        out[i, t] = made[key]
        if TALLY is not None and srcs != [(i, t)]:
            r = made[key]
            nb = _nbytes(r)
            _tally(kind, r, 2.0 if kind == "all-reduce" else 1.0)
            # the backward: the gradient all-reduced back to the
            # sources, or each source's piece of it reduce-scattered
            if kind == "all-reduce":
                _tally_backward(r, kind, 2.0 * nb)
            else:
                _tally_backward(r, "reduce-scatter", nb / len(srcs))
    return Rows(out, x.n) if isinstance(x, Rows) else out


def all_reduce(x, g: MeshGrid, over: str = "tp"):
    """Sum the positions' partial values over the TP ranks of each
    data-parallel rank (``over="tp"``) or over every rank in rank
    order i·TP + t (``over="all"``), on each position's device."""
    def ranks(i, t):
        return [(j, u) for j in (range(g.dp) if over == "all" else (i,))
                for u in range(g.tp)]
    return _collect(x, g, ranks, lambda ts: functools.reduce(torch.add, ts),
                    "all-reduce")


def all_gather(x, g: MeshGrid, dim: int):
    """Concatenate the positions' values over the TP ranks, in rank
    order, along ``dim``, onto each position's device."""
    return _collect(x, g, lambda i, t: [(i, u) for u in range(g.tp)],
                    lambda ts: torch.cat(ts, dim=dim), "all-gather")


def gather_ranks(x, g: MeshGrid, pieces: list[tuple[int, int, int]],
                 dim: int):
    """Concatenate, in the order of ``pieces`` ((u, a, b): rank u's
    values [a, b) along ``dim``), the tensor-parallel ranks' values onto
    each position's device: every KV head once from ``kv_pieces``."""
    def cat(ts):
        return torch.cat([x_.narrow(dim, a, b - a) if (a, b) != (
            0, x_.shape[dim]) else x_ for x_, (_, a, b) in zip(ts, pieces)],
            dim=dim)
    return _collect(x, g, lambda i, t: [(i, u) for u, _, _ in pieces], cat,
                    "all-gather")


def combine_partials(out: np.ndarray, lse: np.ndarray, g: MeshGrid
                     ) -> np.ndarray:
    """Each position receives the attention of its rows over the whole
    sequence from every tensor-parallel rank's partial attention over
    its slice: ``out`` (B, H, X) normalised over the slice and ``lse``
    (B, H) its log-sum-exp (-inf where the slice held nothing live),
    weighted by exp(lse - max lse) and summed in rank order, as
    ``all_reduce`` sums its parts; a row that no slice holds gives 0.
    One result per distinct device and source set."""
    res, made = _grid(g), {}
    for i, t in g.coords():
        dev = g.devices[i, t]
        src = [(out[i, u], lse[i, u]) for u in range(g.tp)]
        key = (str(dev), tuple(id(a) for pair in src for a in pair))
        if TALLY is not None and g.tp > 1:
            for o, s_ in src:
                _tally("all-gather", o)
                _tally("all-gather", s_)
        if key not in made:
            outs = [o.to(dev) for o, _ in src]
            lses = [s_.to(dev) for _, s_ in src]
            m = functools.reduce(torch.maximum, lses)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            w = [torch.exp(s_ - m) for s_ in lses]
            den = functools.reduce(torch.add, w)
            num = functools.reduce(torch.add, [
                wu[..., None] * o for wu, o in zip(w, outs)])
            made[key] = num / torch.where(den > 0, den, torch.ones_like(
                den))[..., None]
        res[i, t] = made[key]
    return res


def insert_rows(dst: Sharded, src: Sharded, slots: torch.Tensor, n: int,
                g: MeshGrid) -> None:
    """Write rows [0, n) of ``src`` (a cache leaf of an admission's
    prefill, rows along axis 1) into rows ``slots`` (a device tensor of
    n global slot indices) of ``dst`` (the shared decode cache), in
    place, each into the shard that holds its slot (a leaf split over
    the sequence: each part of the same rank's slice of ``src``).
    Without a host sync: a shard of several data-parallel ranks maps
    each of its local slots to a source row on the device and merges
    them."""
    done = set()
    for (i, t), part in np.ndenumerate(dst.parts):
        if id(part) in done:
            continue
        done.add(id(part))
        dev = part.device
        rows = torch.cat([src.parts[j, t].to(dev) for j in range(g.dp)],
                         dim=1)[:, :n]
        idx = slots.to(dev).long()
        if g.dp == 1:
            part.index_copy_(1, idx, rows)
            continue
        cd = part.shape[1]
        loc = idx - i * cd
        ok = (loc >= 0) & (loc < cd)
        src_of = torch.full((cd + 1,), -1, dtype=torch.long, device=dev)
        src_of.scatter_(0, torch.where(ok, loc, cd),
                        torch.arange(n, device=dev))
        src_of = src_of[:cd]
        keep = (src_of >= 0).view(1, cd, *([1] * (part.dim() - 2)))
        part.copy_(torch.where(keep, rows.index_select(
            1, src_of.clamp(min=0)), part))


# ---------------------------------------------------------------------------
# token layouts of the mixture of experts
# ---------------------------------------------------------------------------


def _all_tokens(x: Rows, g: MeshGrid, i: int, t: int, made: dict):
    """Every real row of ``x``, flattened to (n·S, D), on (i, t)'s
    device."""
    dev = g.devices[i, t]
    key = (str(dev), tuple(id(x.grid[j, t]) for j in range(g.dp)))
    if key not in made:
        rows = torch.cat([x.grid[j, t].to(dev) for j in range(g.dp)])
        made[key] = rows[:x.n].reshape(-1, rows.shape[-1])
    if TALLY is not None and g.dp > 1:
        _tally("all-gather", made[key])
    return made[key]


def token_chunks(x: Rows, g: MeshGrid, everywhere: bool = False):
    """The reference's expert-parallel token layouts of the flattened
    (n·S, D) tokens: data-parallel rank i's contiguous chunk of
    n·S / DP tokens (its own rows flattened, when the rows split
    evenly), or with ``everywhere`` every token on every position."""
    out, made = _grid(g), {}
    T = x.n * x.grid[0, 0].shape[1]
    for i, t in g.coords():
        if everywhere:
            out[i, t] = _all_tokens(x, g, i, t, made)
        elif not x.padded:
            xl = x.grid[i, t]
            out[i, t] = xl.reshape(-1, xl.shape[-1])
        else:
            c = T // g.dp
            out[i, t] = _all_tokens(x, g, i, t, made)[i * c:(i + 1) * c]
    return out


def tokens_to_rows(y: np.ndarray, x: Rows, g: MeshGrid,
                   everywhere: bool = False) -> Rows:
    """``token_chunks``'s inverse for the outputs ``y`` of each
    position's tokens: back to ``x``'s rows (padding rows zero)."""
    out, made = _grid(g), {}
    S, D = x.grid[0, 0].shape[1], y[0, 0].shape[-1]
    c = x.chunk
    for i, t in g.coords():
        if not everywhere and not x.padded:
            # one view a source, so positions that share it share rows
            if id(y[i, t]) not in made:
                made[id(y[i, t])] = y[i, t].reshape(c, S, D)
            out[i, t] = made[id(y[i, t])]
            continue
        dev = g.devices[i, t]
        src = [y[i, t]] if everywhere else [y[j, t] for j in range(g.dp)]
        key = (str(dev), tuple(id(s) for s in src), i)
        if TALLY is not None and not everywhere and g.dp > 1:
            for s in src:
                _tally("all-gather", s)
        if key not in made:
            full = torch.cat([s.to(dev) for s in src]).reshape(x.n, S, D)
            pad = c * g.dp - x.n
            if pad:
                full = torch.cat([full, full.new_zeros((pad, S, D))])
            made[key] = full[i * c:(i + 1) * c]
        out[i, t] = made[key]
    return Rows(out, x.n)


__all__ = ["MeshGrid", "MeshNotPorted", "Rows", "Sharded", "all_gather",
           "all_reduce", "check_policy", "combine_partials", "dedupe_spec",
           "gather_ranks", "gmap", "head_range", "head_runs", "home_device",
           "insert_rows", "kv_owners", "kv_pieces", "kv_range",
           "leaf_index", "like", "local_config", "local_grid", "mesh_grid",
           "on_mesh", "part_shape", "positions", "run_grid", "scatter_rows",
           "around_calls",
           "seq_sharded", "seq_slice", "split", "split_like",
           "sum_replicas", "tally_collectives", "token_chunks",
           "tokens_to_rows", "unshard", "unzip", "zeros"]
