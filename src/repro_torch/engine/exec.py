"""Physical executor for hybrid plans over columnar PyTorch tables.

Vectorised, mask-based execution (DuckDB-pipeline analogue):

* σ / SF update validity masks (no materialisation);
* ⋈ / × / γ / sort / limit materialise compacted outputs — on device
  impls through the ``kernels/compact`` stream-compaction op plus one
  fused device gather per operator, so device columns never bounce
  through the host between operators and every remaining fetch is
  ticked into ``ExecStats.pipeline_syncs``;
* γ, ⋈ and semantic dedup all sit on the ``group_build`` op
  (``kernels/hash_dedup``): one sort-by-key + boundary-scan pass that
  returns representatives, inverse scatter map, group counts and
  segment offsets behind a single device→host fetch;
* γ turns arbitrary-dtype keys into int32 codes in the same device pass
  (``group_build_columns``) and reduces every aggregate column in one
  segmented pass (int32/float32 min/max through the segmented-reduction
  kernel);
* ⋈ is served by the planner's physical operator: ``hash`` (the
  open-addressing ``hash_join_match``: torch build and probe, the
  radix-rank kernel for the grouped build order, one sync for the
  match total — or a live ``streaming.StreamJoinBuild`` covering the
  build side, recorded as ``stream``), ``sort_merge`` (a pre-sorted
  build side skips the sort; otherwise the sort-based
  ``join_match_lists`` groups the build side with ``group_build`` and
  probes and expands on the device) or ``host`` (the searchsorted
  oracle);
* semantic operators stack the referenced row_ids of *valid* rows into an
  (N, C) key matrix, collapse duplicates with ``dedup_representatives``,
  render prompts only for first-occurrence representatives, and scatter
  backend results back to all N rows through the inverse mapping. The
  ``FunctionCache`` stays above this as the cross-operator dedup layer,
  and on the card its device ``VerdictTable`` resolves repeat filter
  verdicts in one gather.

The executor records the quantities the paper's cost model predicts:
``llm_calls`` (distinct backend invocations = C_LLM), ``rel_rows`` (rows
processed by relational operators = C_rel) and ``probe_rows`` (cache
lookups triggered by pulled-up filters). ``Executor(vectorized=False)``
keeps the per-row / per-group reference paths for equivalence testing;
both paths produce identical results (rows AND row order) and identical
llm_calls / cache_hits / null_skipped accounting.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..core.plan import (
    Aggregate,
    BoolOp,
    Cmp,
    Col,
    Const,
    CrossJoin,
    Expr,
    Filter,
    Join,
    Limit,
    Node,
    Project,
    Scan,
    SemanticFilter,
    SemanticJoin,
    SemanticProject,
    Sort,
    Union,
)
from ..kernels.expand.ops import expand_segments
from ..kernels.hash_dedup.ops import dedup_representatives, group_build_columns
from ..kernels.hash_dedup.ref import hash_rows_np
from ..kernels.hash_join.ops import hash_join_match, sorted_probe_match
from ..kernels.segmented_reduce.ops import (
    _DEVICE_DTYPES,
    join_match_lists,
    segment_plan_from_group_build,
    segmented_aggregate,
)
from ..kernels.sync import HOST_SYNCS, SERVING_SITES
from ..kernels.util import np_dtype, resolve_impl, to_numpy
from ..semantic.cache import FP_BASIS
from ..semantic.runner import SemanticResult, SemanticRunner
from ..trace import span
from .table import (
    Database,
    HostIndex,
    LazyColumn,
    Table,
    as_column,
    fetch,
    is_device,
)

MAX_CROSS_ROWS = 30_000_000


@dataclass
class ExecStats:
    """Per-query execution counters mirroring the cost model's terms:
    ``llm_calls`` (distinct backend invocations = C_LLM), ``rel_rows``
    (rows through relational operators = C_rel), ``probe_rows`` (cache
    lookups triggered by pulled-up filters), plus the host wall clock
    of ``execute``, per-operator breakdowns and ``pipeline_syncs`` — the
    device→host fetches ``kernels.sync.HOST_SYNCS`` recorded while the
    plan ran."""

    llm_calls: int = 0
    cache_hits: int = 0
    probe_rows: int = 0
    null_skipped: int = 0
    rel_rows: int = 0
    sem_rows: int = 0
    wall_s: float = 0.0
    per_op: dict = field(default_factory=dict)
    prompt_chars: int = 0
    prompts_rendered: int = 0  # host renders (distinct keys, vectorized)
    pipeline_syncs: int = 0  # data-path device→host fetches in execute()
    serving_syncs: int = 0  # LLM-tier fetches (SERVING_SITES), separate
    collective_ops: int = 0  # cross-device exchanges (mesh executors)
    # physical operator -> count of equi joins it served this query
    # ("hash" | "stream" | "sort_merge" | "host" | "partitioned" |
    # "reference")
    join_physical: dict = field(default_factory=dict)

    def bump(self, op: str, key: str, v: float) -> None:
        """Accumulate ``v`` under ``per_op[op][key]``."""
        d = self.per_op.setdefault(op, {})
        d[key] = d.get(key, 0) + v


class ExecutionError(RuntimeError):
    """A plan references columns/tables the executor cannot resolve, or
    an operator hits a hard resource bound (``MAX_CROSS_ROWS``)."""


def _scalar(v):
    """Numpy scalars as Python scalars, so a comparison against a
    tensor keeps the column's dtype (a Python number is weakly typed in
    torch as in JAX)."""
    return v.item() if isinstance(v, np.generic) else v


class Executor:
    """Physical executor for hybrid plans over a ``Database``, on the
    database's device.

    ``vectorized=True`` (default) runs the kernel-accelerated paths;
    ``vectorized=False`` keeps the per-row / per-group reference paths,
    and both produce identical rows, row order and llm_calls /
    cache_hits / null_skipped accounting. ``kernel_impl`` threads an
    implementation token ("auto" | "kernel" | "ref" | "host") through
    every kernel-backed operator. A runner whose ``VerdictTable`` has no
    device yet is placed on the database's device.

    ``mesh=`` (a ``sharding.DataMesh``) enables the key-partitioned data
    tier (``sharding/data.py``): grouped aggregates and equi joins over
    partitionable keys run shard-local after one exchange per side,
    producing row-for-row identical output; ``partitioned=False`` keeps
    a mesh-constructed executor on the single-device path."""

    def __init__(self, db: Database, runner: SemanticRunner,
                 fresh_cache_per_query: bool = True,
                 vectorized: bool = True,
                 kernel_impl: str = "auto",
                 mesh=None, partitioned: Optional[bool] = None):
        self.db = db
        self.device = db.device
        self.runner = runner
        self.fresh_cache_per_query = fresh_cache_per_query
        self.vectorized = vectorized
        resolve_impl(kernel_impl, "host")  # validate the token
        self.kernel_impl = kernel_impl
        self.mesh = mesh
        self.partitioned = (partitioned if partitioned is not None
                            else mesh is not None)
        if self.partitioned and mesh is None:
            raise ValueError("partitioned=True requires mesh=")
        vt = runner.cache.verdicts
        if vt.device is None:
            vt.place(self.device)
        self._pcache = None
        if mesh is not None:
            from ..sharding.data import PartitionCache

            self._pcache = PartitionCache(mesh)
            # partition the runner's verdict table by the same key hash:
            # the default-constructed table is per-query cache state, so
            # rebinding it empty is lossless; an explicitly mesh-bound
            # (or custom) table is left alone
            if vt.mesh is None:
                from ..semantic.cache import VerdictTable

                runner.cache.verdicts = VerdictTable(
                    capacity=vt.capacity,
                    impl="on" if vt.enabled else "off", mesh=mesh)
        # optional streaming.StreamContext: when set, hash joins whose
        # build side is covered by a live incremental StreamJoinBuild
        # probe it instead of rebuilding the table (join_physical
        # "stream"); identical match lists either way.
        self.stream = None

    def _host_pipeline(self) -> bool:
        return resolve_impl(self.kernel_impl, "host", self.device) == "host"

    def _tensor(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=dtype, device=self.device)

    def _ones(self, n: int) -> torch.Tensor:
        return torch.ones(n, dtype=torch.bool, device=self.device)

    # ------------------------------------------------------------------ API
    def execute(self, plan: Node) -> tuple[Table, ExecStats]:
        """Run ``plan`` to a materialised ``Table`` plus its
        ``ExecStats`` (resetting the per-query cache scope first unless
        constructed with ``fresh_cache_per_query=False``), under the
        span ``exec.query``, whose id is the query's trace id."""
        if self.fresh_cache_per_query:
            self.runner.reset_query_scope()
        stats = ExecStats()
        t0 = time.perf_counter()
        syncs0 = HOST_SYNCS.syncs
        serving0 = HOST_SYNCS.site_total(SERVING_SITES)
        coll0 = HOST_SYNCS.collectives
        with span("exec.query"):
            table = self._run(plan, stats)
        stats.wall_s = time.perf_counter() - t0
        stats.collective_ops = HOST_SYNCS.collectives - coll0
        stats.serving_syncs = HOST_SYNCS.site_total(SERVING_SITES) - serving0
        stats.pipeline_syncs = (HOST_SYNCS.syncs - syncs0
                                - stats.serving_syncs)
        return table, stats

    # ------------------------------------------------------------ dispatch
    def _run(self, node: Node, stats: ExecStats) -> Table:
        name = type(node).__name__
        if isinstance(node, Scan):
            out = self.db.tables[node.table]
            stats.rel_rows += out.num_valid
            stats.bump(name, "rows", out.num_valid)
            return out
        if isinstance(node, (SemanticFilter, SemanticProject, SemanticJoin)):
            children = [self._run(c, stats) for c in node.children]
            return self._run_semantic(node, children, stats)

        children = [self._run(c, stats) for c in node.children]
        out = self._run_relational(node, children, stats)
        in_rows = sum(c.num_valid for c in children)
        stats.rel_rows += in_rows + out.num_valid
        stats.bump(name, "rows", in_rows + out.num_valid)
        return out

    # ------------------------------------------------------------ relational
    def _run_relational(self, node: Node, ch: list[Table],
                        stats: ExecStats) -> Table:
        if isinstance(node, Filter):
            mask = self._eval_pred(node.pred, ch[0])
            return ch[0].with_mask(mask)
        if isinstance(node, Project):
            return ch[0].select(self._resolve_cols(node.cols, ch[0]))
        if isinstance(node, Join):
            return self._equi_join(ch[0], ch[1], node.left_key,
                                   node.right_key, physical=node.physical,
                                   stats=stats)
        if isinstance(node, CrossJoin):
            return self._cross_join(ch[0], ch[1])
        if isinstance(node, Aggregate):
            return self._aggregate(node, ch[0])
        if isinstance(node, Limit):
            t = ch[0].compact(self.kernel_impl)
            idx = np.arange(min(node.n, t.capacity))
            return t.gather(idx, self.kernel_impl)
        if isinstance(node, Sort):
            t = ch[0].compact(self.kernel_impl)
            if t.capacity == 0:
                return t
            keys = []
            for colname, desc in reversed(node.keys):
                v = fetch(t.col(colname), "sort_keys")
                if not desc:
                    keys.append(v)
                elif v.dtype.kind == "f":
                    # float negation keeps NaN (NULL SP outputs) sorting
                    # last under lexsort, matching ascending behaviour
                    keys.append(-v)
                else:
                    # rank-based descending: negation raises on strings,
                    # wraps unsigned ints and overflows INT_MIN
                    ranks = np.unique(v, return_inverse=True)[1]
                    keys.append(-ranks)
            order = np.lexsort(keys)
            out = t.gather(order, self.kernel_impl)
            # an ascending primary key is a pre-sorted-build guarantee
            # downstream sort-merge joins can spend
            if not node.keys[0][1]:
                out.sorted_by = node.keys[0][0]
            return out
        if isinstance(node, Union):
            parts = [c.compact(self.kernel_impl) for c in ch]
            cols = {}
            for k in parts[0].columns:
                vs = [p.col(k) for p in parts]
                if all(is_device(v) for v in vs):
                    cols[k] = torch.cat(vs)  # stays on the device
                else:
                    cols[k] = as_column(np.concatenate(
                        [fetch(v, "union_concat") for v in vs]), self.device)
            n = sum(p.capacity for p in parts)
            return Table(columns=cols, valid=self._ones(n), _num_valid=n)
        raise ExecutionError(f"unsupported relational node {type(node)}")

    def _resolve_cols(self, cols: list[str], t: Table) -> list[str]:
        out = []
        for c in cols:
            if c in t.columns:
                out.append(c)
            elif c not in self.db.text_cols:
                # text columns exist only as payload; anything else is a
                # planner bug that must not silently drop output columns
                raise ExecutionError(
                    f"unknown projection column {c} "
                    f"(have {sorted(t.columns)[:8]}...)")
        return out or list(t.columns)

    def _eval_pred(self, e: Expr, t: Table) -> torch.Tensor:
        if isinstance(e, BoolOp):
            masks = [self._eval_pred(a, t) for a in e.args]
            if e.op == "and":
                m = masks[0]
                for x in masks[1:]:
                    m = m & x
                return m
            if e.op == "or":
                m = masks[0]
                for x in masks[1:]:
                    m = m | x
                return m
            return ~masks[0]
        if isinstance(e, Cmp):
            lhs = self._eval_value(e.left, t)
            if e.op == "in":
                return self._pred_in(lhs, e.right)
            if e.op == "between":
                lo, hi = (_scalar(v) for v in e.right)
                if self._on_host(lhs, lo) or self._on_host(lhs, hi):
                    v = fetch(lhs, "predicate")
                    return self._tensor((v >= lo) & (v <= hi))
                return (lhs >= lo) & (lhs <= hi)
            rhs = (
                self._eval_value(e.right, t)
                if isinstance(e.right, Expr)
                else _scalar(e.right)
            )
            ops = {
                "==": lambda a, b: a == b,
                "!=": lambda a, b: a != b,
                "<": lambda a, b: a < b,
                "<=": lambda a, b: a <= b,
                ">": lambda a, b: a > b,
                ">=": lambda a, b: a >= b,
            }
            if self._on_host(lhs, rhs):
                if is_device(rhs):
                    rhs = to_numpy(rhs)  # unticked, as in the reference
                out = np.asarray(ops[e.op](fetch(lhs, "predicate"), rhs))
                if out.ndim == 0:  # incomparable types collapse to a scalar
                    out = np.full(np.shape(lhs)[0], bool(out))
                return self._tensor(out)
            return ops[e.op](lhs, rhs)
        raise ExecutionError(f"unsupported predicate {e}")

    @staticmethod
    def _on_host(lhs, rhs) -> bool:
        """Host-side columns (strings, 64-bit numerics — numpy arrays or
        their deferred ``LazyColumn`` gathers) and constants outside
        int32 range compare in numpy: a tensor op would reject strings
        outright and wrap 64-bit values through int32."""
        if not is_device(lhs) or isinstance(rhs, (np.ndarray, LazyColumn)):
            return True
        if isinstance(rhs, str):
            return True
        if isinstance(rhs, (int, np.integer)) and not isinstance(rhs, bool):
            return not -2**31 <= int(rhs) < 2**31
        return False

    def _pred_in(self, lhs, values) -> torch.Tensor:
        """IN-list membership. Numeric lists against device columns stay
        on the device at the column's device precision (floats as
        float32, ints as int32, as JAX's 32-bit mode stores them);
        string lists and integer values outside int32 range evaluate
        host-side in numpy."""
        vals = np.asarray(list(values))
        if is_device(lhs) and vals.dtype.kind in "iufb":
            in_range = vals.dtype.kind not in "iu" or (
                len(vals) == 0
                or (-2**31 <= int(vals.min()) and int(vals.max()) < 2**31))
            if in_range:
                narrow = {"f": np.float32, "b": np.bool_}.get(
                    vals.dtype.kind, np.int32)
                return torch.isin(lhs, self._tensor(vals.astype(narrow)))
        return self._tensor(np.isin(fetch(lhs, "predicate"), vals))

    def _eval_value(self, e: Expr, t: Table):
        if isinstance(e, Col):
            if e.name not in t.columns:
                raise ExecutionError(f"column {e.name} not in table "
                                     f"({list(t.columns)[:8]}...)")
            return t.col(e.name)
        if isinstance(e, Const):
            return e.value
        raise ExecutionError(f"unsupported value expr {e}")

    @staticmethod
    def _join_key_physical(col) -> bool:
        """int32-codable key: eligible for the device physical joins
        (strings and 64-bit keys go through the shared code space)."""
        dt = np_dtype(col)
        return dt.kind in "iub" and dt.itemsize <= 4

    def _partitioned_join(self, rt: Table, rk: str, pk_col):
        """Match lists from the key-partitioned mesh join, or None when
        the partitioned path does not apply (no mesh, host impl, or a
        key the partitioner cannot route) — the caller then falls back
        to single-device physical selection."""
        if not self.partitioned or self._host_pipeline():
            return None
        from ..sharding.data import is_partitionable, sharded_join_match

        if not (is_partitionable(pk_col)
                and is_partitionable(rt.col(rk))):
            return None
        return sharded_join_match(self._pcache, rt, rk, pk_col,
                                  impl=self.kernel_impl)

    def _equi_join(self, left: Table, right: Table, lk: str, rk: str,
                   physical: Optional[str] = None,
                   stats: Optional[ExecStats] = None) -> Table:
        """Equi join, dispatched on the planner's chosen physical
        operator (``Join.physical``; ``None`` = decide here):

        * ``"hash"`` — ``hash_join_match``: device open-addressing
          build + one-pass probe (one sync for the total); when
          ``self.stream`` holds a live incremental build covering the
          build-side table, that structure serves the probe instead
          without rebuilding (recorded as ``"stream"``, bit-identical
          match lists);
        * ``"sort_merge"`` — when the build side is already ordered by
          the key (``Table.sorted_by``) the sort phase is skipped
          (``sorted_probe_match``); otherwise the sort-based
          ``join_match_lists`` pays its group build;
        * ``"host"`` — the host searchsorted oracle.

        String/64-bit keys always take the shared-code-space host path.
        The reference path (``vectorized=False``) is the stable argsort
        + searchsorted + ``np.repeat`` baseline. ``stats.join_physical``
        records which operator served each join."""
        lt = left.compact(self.kernel_impl)
        rt = right.compact(self.kernel_impl)
        if self.vectorized:
            pk_col, bk_col = lt.col(lk), rt.col(rk)
            phys = physical or "auto"
            matches = self._partitioned_join(rt, rk, pk_col)
            if matches is not None:
                # key-partitioned mesh join: np match lists in the
                # probe-major contract order; device int32 indices keep
                # the joined gather on its fused device path
                phys = "partitioned"
                out_l = self._tensor(matches[0], torch.int32)
                out_r = self._tensor(matches[1], torch.int32)
            elif not (self._join_key_physical(pk_col)
                    and self._join_key_physical(bk_col)):
                phys = "host"  # string/64-bit keys: shared code space
                out_l, out_r = join_match_lists(
                    pk_col, bk_col, impl=self.kernel_impl,
                    device=self.device)
            elif phys == "auto":
                phys = ("sort_merge" if rt.sorted_by == rk
                        and np_dtype(bk_col).kind in "ib" else "hash")
            if phys == "hash":
                # streaming interception: a live incremental build
                # covering EXACTLY this build-side table serves the
                # probe without rebuilding (bit-identical match lists;
                # None = not covered / skew fallback)
                matches = None
                if self.stream is not None:
                    sjb = self.stream.build_for(rt, rk, self.kernel_impl)
                    if sjb is not None:
                        matches = sjb.probe(pk_col, self.kernel_impl)
                if matches is not None:
                    phys = "stream"
                    out_l, out_r = matches
                else:
                    out_l, out_r = hash_join_match(
                        pk_col, bk_col, impl=self.kernel_impl,
                        device=self.device)
            elif phys == "sort_merge":
                if (rt.sorted_by == rk
                        and np_dtype(bk_col).kind in "ib"):
                    out_l, out_r = sorted_probe_match(
                        pk_col, bk_col, impl=self.kernel_impl,
                        device=self.device)
                else:  # pre-sorted guarantee lost: sort-based device join
                    out_l, out_r = join_match_lists(
                        pk_col, bk_col, impl=self.kernel_impl,
                        device=self.device)
            elif phys == "host" and self._join_key_physical(pk_col):
                out_l, out_r = join_match_lists(pk_col, bk_col, impl="host",
                                                device=self.device)
            elif phys not in ("host", "partitioned"):
                raise ExecutionError(f"unknown physical join {phys!r}")
        else:
            phys = "reference"
            lkv = fetch(lt.col(lk), "join_keys")
            rkv = fetch(rt.col(rk), "join_keys")
            order = np.argsort(rkv, kind="stable")
            rk_sorted = rkv[order]
            lo = np.searchsorted(rk_sorted, lkv, "left")
            hi = np.searchsorted(rk_sorted, lkv, "right")
            counts = hi - lo
            total = int(counts.sum())
            out_l = np.repeat(np.arange(len(lkv)), counts)
            starts = np.repeat(lo, counts)
            within = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts)
            out_r = order[starts + within]
        if stats is not None:
            stats.join_physical[phys] = stats.join_physical.get(phys, 0) + 1
        return self._gather_joined(lt, rt, out_l, out_r)

    def _gather_joined(self, lt: Table, rt: Table, out_l, out_r) -> Table:
        """Materialise join output columns with ONE gather per column.
        Shared by ⋈ and ×. Device index lists keep device columns on the
        device via the fused ``take_rows`` gather and defer host-side
        columns lazily. Host index lists: when the whole pipeline is
        host-resolved every column defers behind one shared
        ``HostIndex`` per side (site ``join_gather``); otherwise columns
        densify eagerly through ``as_column`` exactly once."""
        if is_device(out_l):
            tl = lt.take_rows(out_l)
            tr = rt.take_rows(out_r)
            return Table(columns={**tl.columns, **tr.columns},
                         valid=tl.valid, _num_valid=tl.capacity)
        if self.vectorized and self._host_pipeline():
            il, ir = HostIndex(out_l), HostIndex(out_r)
            cols = {k: LazyColumn(v, il, site="join_gather")
                    for k, v in lt.columns.items()}
            for k, v in rt.columns.items():
                cols[k] = LazyColumn(v, ir, site="join_gather")
            n = len(out_l)
            return Table(columns=cols, valid=self._ones(n), _num_valid=n)
        # densifying a device column here is a real device→host fetch
        # and is ticked so pipeline_syncs stays honest
        cols = {k: as_column(fetch(v, "join_gather")[out_l], self.device)
                for k, v in lt.columns.items()}
        for k, v in rt.columns.items():
            cols[k] = as_column(fetch(v, "join_gather")[out_r], self.device)
        return Table(columns=cols, valid=self._ones(len(out_l)),
                     _num_valid=len(out_l))

    def _cross_join(self, left: Table, right: Table) -> Table:
        """Cross join. Vectorized: the row-pair enumeration is the
        ``kernels/expand`` op (n2 rows per left segment, zero offsets →
        tiled right indices), handed over as device tensors on device
        impls; reference: host ``np.repeat``/``np.tile``."""
        lt = left.compact(self.kernel_impl)
        rt = right.compact(self.kernel_impl)
        n1, n2 = lt.capacity, rt.capacity
        if n1 * n2 > MAX_CROSS_ROWS:
            raise ExecutionError(
                f"cross join of {n1}x{n2} exceeds MAX_CROSS_ROWS")
        if self.vectorized:
            out_l, out_r = expand_segments(
                np.full(n1, n2, dtype=np.int64), impl=self.kernel_impl,
                as_device=True, device=self.device)
        else:
            out_l = np.repeat(np.arange(n1), n2)
            out_r = np.tile(np.arange(n2), n1)
        return self._gather_joined(lt, rt, out_l, out_r)

    def _aggregate(self, node: Aggregate, child: Table) -> Table:
        """Dispatch grouped/global aggregation to the vectorized or
        per-group reference implementation (the reference also defines
        the n == 0 empty-column dtypes)."""
        t = child.compact(self.kernel_impl)
        n = t.capacity
        if not node.group_by:
            cols = {}
            for func, c, name in node.aggs:
                cols[f"agg.{name}"] = as_column(
                    [self._agg_value(func, t, c, np.arange(n))], self.device)
            return Table(columns=cols, valid=self._ones(1))
        if not self.vectorized or n == 0:
            return self._aggregate_ref(node, t)
        if self.partitioned and not self._host_pipeline():
            out = self._aggregate_partitioned(node, t)
            if out is not None:
                return out
        return self._aggregate_vectorized(node, t)

    def _aggregate_ref(self, node: Aggregate, t: Table) -> Table:
        """Per-group reference path: O(G*N) ``np.nonzero`` scan per group
        and aggregate column (and the n == 0 case, whose empty-column
        dtypes it defines)."""
        keys = np.stack([fetch(t.col(k), "agg_keys")
                         for k in node.group_by], axis=1)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        g = uniq.shape[0]
        cols = {}
        for i, k in enumerate(node.group_by):
            dt = np_dtype(t.col(k))  # dtype only — no column fetch
            cols[k] = as_column(uniq[:, i].astype(dt), self.device)
        for func, c, name in node.aggs:
            vals = [self._agg_value(func, t, c, np.nonzero(inverse == gi)[0])
                    for gi in range(g)]
            # numpy promotion keeps integer aggregates integral (int64);
            # as_column keeps 64-bit results host-side at full precision
            cols[f"agg.{name}"] = as_column(vals, self.device)
        return Table(columns=cols, valid=self._ones(g),
                     sorted_by=node.group_by[0])

    def _aggregate_vectorized(self, node: Aggregate, t: Table) -> Table:
        """Grouped aggregation in one segmented pass per aggregate column.

        ``group_build_columns`` assigns per-column int32 rank codes AND
        builds the groups in a single device pass (one device→host
        fetch), yielding group ids plus a ready ``SegmentPlan``, and
        ``segmented_aggregate`` reduces each column over the segments.
        Per-group outputs are then permuted (a G-sized gather) to the
        reference path's ``np.unique(axis=0)`` lexicographic order so
        order-sensitive downstream operators (LIMIT) see identical rows.
        """
        key_cols = [t.col(k) for k in node.group_by]
        codes, gb = group_build_columns(key_cols, impl=self.kernel_impl,
                                        device=self.device)
        g = gb.num_groups
        plan = segment_plan_from_group_build(gb)
        # codes are order-isomorphic to key values, so lexsorting the G
        # representatives' code rows (primary = first group-by column)
        # reproduces np.unique(axis=0)'s group order
        grp_order = np.lexsort(
            tuple(codes[gb.reps, j]
                  for j in range(codes.shape[1] - 1, -1, -1)))
        reps_sorted = gb.reps[grp_order]
        cols = {}
        for i, k in enumerate(node.group_by):
            # device key columns gather their G representatives on the
            # device (no N-sized host fetch); host columns gather in np
            if is_device(key_cols[i]):
                cols[k] = torch.index_select(
                    key_cols[i], 0,
                    self._tensor(reps_sorted.astype(np.int64)))
            else:
                cols[k] = as_column(
                    fetch(key_cols[i], "agg_keys")[reps_sorted], self.device)
        for func, c, name in node.aggs:
            values = None if func == "count" else t.col(c)
            cols[f"agg.{name}"] = as_column(
                segmented_aggregate(plan, values, func,
                                    impl=self.kernel_impl)[grp_order],
                self.device)
        # np.unique(axis=0) group order ascends by the first group key:
        # the pre-grouped guarantee sort-merge joins price as free
        return Table(columns=cols, valid=self._ones(g), _num_valid=g,
                     sorted_by=node.group_by[0])

    def _aggregate_partitioned(self, node: Aggregate, t: Table
                               ) -> Optional[Table]:
        """Grouped aggregation over the key-partitioned mesh layout, or
        None when a group key cannot be partitioned (string / float /
        64-bit — the single-device path handles those).

        The layout's merged ``SegmentPlan`` is ALREADY in the reference
        ``np.unique(axis=0)`` group order with rows in original order
        inside each group, so ``segmented_aggregate`` accumulates in
        the exact single-device order (bit-identical float64 sums) and
        no G-sized output permute is needed; device-dtype min/max stay
        on the device through the shard-local ``sharded_segment_reduce``
        (K5 per shard). A repeated query over an unchanged table reuses
        the cached layout and pays zero collectives."""
        # sharding.data imports the engine: imported here, as the
        # reference does
        from ..sharding.data import is_partitionable, sharded_segment_reduce

        key_cols = [t.col(k) for k in node.group_by]
        if not all(is_partitionable(c) for c in key_cols):
            return None
        st = self._pcache.layout(t, tuple(node.group_by),
                                 site="exchange_aggregate",
                                 impl=self.kernel_impl)
        plan, reps_sorted = st.group_plan()
        reps = self._tensor(reps_sorted.astype(np.int64))
        cols = {k: torch.index_select(key_cols[i], 0, reps)
                for i, k in enumerate(node.group_by)}
        for func, c, name in node.aggs:
            values = None if func == "count" else t.col(c)
            if (func in ("min", "max") and is_device(values)
                    and np_dtype(values) in _DEVICE_DTYPES
                    and plan.num_groups > 0):
                out = sharded_segment_reduce(st, values, func,
                                             impl=self.kernel_impl)
            else:
                out = segmented_aggregate(plan, values, func,
                                          impl=self.kernel_impl)
            cols[f"agg.{name}"] = as_column(out, self.device)
        g = plan.num_groups
        return Table(columns=cols, valid=self._ones(g), _num_valid=g,
                     sorted_by=node.group_by[0])

    @staticmethod
    def _agg_value(func: str, t: Table, c: str, idx: np.ndarray):
        """Aggregate one group, preserving exactness: count is integral,
        sum/min/max over integer columns stay integer, avg accumulates
        in float64. Over zero rows min/max/avg are SQL NULL (NaN) while
        count is 0 and sum keeps the 0/0.0 identity."""
        if func == "count":
            return np.int64(len(idx))
        v = fetch(t.col(c), "agg_values")[idx]
        if len(v) == 0:
            if func != "sum":
                return np.float64(np.nan)
            return (np.int64(0) if v.dtype.kind in "bui"
                    else np.float64(0.0))
        if func == "sum":
            return (v.sum(dtype=np.int64) if v.dtype.kind in "bui"
                    else v.sum(dtype=np.float64))
        if func == "avg":
            return np.float64(v.mean(dtype=np.float64))
        return {"min": np.min, "max": np.max}[func](v)

    # ------------------------------------------------------------- semantic
    def _ref_id_columns(self, tc: Table, ref_tables: frozenset[str]
                        ) -> tuple[list[str], list[np.ndarray]]:
        """The referenced tables' row_id columns of a compacted table, in
        deterministic (sorted) table order."""
        rts = sorted(ref_tables)
        id_cols = []
        for rt in rts:
            col = f"{rt}.row_id"
            if col not in tc.columns:
                raise ExecutionError(
                    f"semantic operator references {rt} but {col} missing")
            id_cols.append(fetch(tc.col(col), "sem_keys").astype(np.int32))
        return rts, id_cols

    def _context_at(self, rts: list[str], id_cols: list[np.ndarray],
                    row: int) -> dict:
        ctx = {}
        for rt, arr in zip(rts, id_cols):
            rid = int(arr[row])
            ctx[rt] = self.db.payloads[rt][rid] if rid >= 0 else None
        return ctx

    def _contexts_for(self, t: Table, ref_tables: frozenset[str]
                      ) -> tuple[list[dict], Table]:
        """Per-row reference path: one context dict per valid row."""
        tc = t.compact(self.kernel_impl)
        rts, id_cols = self._ref_id_columns(tc, ref_tables)
        ctxs = [self._context_at(rts, id_cols, i)
                for i in range(tc.capacity)]
        return ctxs, tc

    def _evaluate_semantic(self, node: Node, child: Table, stats: ExecStats,
                           out_dtype: str
                           ) -> tuple[Table, SemanticResult, np.ndarray]:
        """Evaluate φ over the child's valid rows. Returns the compacted
        table, the runner result (per representative) and the inverse
        mapping scattering representative values back to rows."""
        if not self.vectorized:
            ctxs, tc = self._contexts_for(child, node.ref_tables)
            n = tc.capacity
            stats.sem_rows += n
            stats.probe_rows += n
            res = self.runner.evaluate(node.phi, ctxs, out_dtype=out_dtype)
            inverse = np.arange(n)
        else:
            tc, res, inverse = self._evaluate_vectorized(node, child, stats,
                                                         out_dtype)

        stats.llm_calls += res.distinct_calls
        stats.cache_hits += res.cache_hits
        stats.null_skipped += res.null_rows
        stats.prompts_rendered += res.prompts_rendered
        return tc, res, inverse

    def _evaluate_vectorized(self, node: Node, child: Table,
                             stats: ExecStats, out_dtype: str
                             ) -> tuple[Table, SemanticResult, np.ndarray]:
        """Vectorized path: stack referenced row_ids into an (N, C) int32
        key matrix, dedup it into first-occurrence representatives,
        render prompts/contexts for representatives only, and pass row
        multiplicities so cache accounting matches per-row execution."""
        tc = child.compact(self.kernel_impl)
        n = tc.capacity
        rts, id_cols = self._ref_id_columns(tc, node.ref_tables)
        stats.sem_rows += n
        stats.probe_rows += n

        if n == 0:
            res = SemanticResult(values=[], distinct_calls=0, cache_hits=0,
                                 null_rows=0, prompts_rendered=0)
            inverse = np.zeros(0, dtype=np.int64)
        else:
            # placeholder-free φ references no tables: every row shares one
            # constant key, so a single representative covers the batch
            keys = (np.stack(id_cols, axis=1) if id_cols
                    else np.zeros((n, 1), dtype=np.int32))
            keys = np.ascontiguousarray(keys, dtype=np.int32)
            _, reps, inverse, rep_hashes = dedup_representatives(
                keys, return_hashes=True, impl=self.kernel_impl,
                device=self.device)
            rep_ctxs = [self._context_at(rts, id_cols, int(r)) for r in reps]
            counts = np.bincount(inverse, minlength=len(reps))
            # key-probe fast path: the row hash + exact key row let the
            # FunctionCache recognise representatives seen by an
            # earlier operator before any prompt is re-rendered
            key_ids = [(int(h), keys[int(r)].tobytes())
                       for h, r in zip(rep_hashes, reps)]
            # device verdict table: hash + independent fingerprint key
            # the int8 verdict column — boolean operators only
            key_fps = (hash_rows_np(keys[reps], basis=FP_BASIS)
                       if (self.runner.cache.verdicts.enabled
                           and out_dtype == "bool") else None)
            res = self.runner.evaluate_unique(
                node.phi, rep_ctxs, counts=counts, out_dtype=out_dtype,
                key_ids=key_ids, key_hashes=rep_hashes, key_fps=key_fps)

        return tc, res, inverse

    def _run_semantic(self, node: Node, ch: list[Table],
                      stats: ExecStats) -> Table:
        if isinstance(node, SemanticJoin):
            # direct (unoptimized) execution: SJ ≡ SF over the cross product
            cross = self._cross_join(ch[0], ch[1])
            stats.rel_rows += cross.num_valid
            sf = SemanticFilter(phi=node.phi, ref_cols=list(node.ref_cols))
            return self._run_semantic(sf, [cross], stats)

        if isinstance(node, SemanticFilter):
            tc, res, inverse = self._evaluate_semantic(
                node, ch[0], stats, out_dtype="bool")
            stats.bump(f"SF{node.sf_id}", "calls", res.distinct_calls)
            rep_mask = np.asarray([bool(v) for v in res.values], dtype=bool)
            mask = rep_mask[inverse] if len(inverse) else np.zeros(0, bool)
            return tc.with_mask(self._tensor(mask))

        if isinstance(node, SemanticProject):
            tc, res, inverse = self._evaluate_semantic(
                node, ch[0], stats, out_dtype=node.out_dtype)
            stats.bump("SP", "calls", res.distinct_calls)
            rep_vals = np.asarray(
                [float(v) if v is not None else np.nan for v in res.values],
                dtype=np.float32,
            )
            vals = rep_vals[inverse] if len(inverse) else \
                np.zeros(0, np.float32)
            cols = dict(tc.columns)
            cols[node.out_col] = self._tensor(vals)
            return Table(columns=cols, valid=tc.valid,
                         _num_valid=tc._num_valid)

        raise ExecutionError(f"unsupported semantic node {type(node)}")


class FrontDoor:
    """Multi-query front door over one shared backend.

    ``n_lanes`` ``Executor`` lanes share ONE ``SemanticRunner`` — and
    through it one backend, one ``FunctionCache`` and one device
    ``VerdictTable`` (lanes are built with
    ``fresh_cache_per_query=False``, so verdicts learned by one query
    serve every later query until ``reset_scope``). Each semantic
    operator's distinct misses carry their row multiplicities to the
    backend, as in a single executor.
    """

    def __init__(self, db: Database, runner: SemanticRunner,
                 n_lanes: int = 4, vectorized: bool = True,
                 kernel_impl: str = "auto"):
        self.runner = runner
        self.lanes = [
            Executor(db, runner, fresh_cache_per_query=False,
                     vectorized=vectorized, kernel_impl=kernel_impl)
            for _ in range(max(1, n_lanes))
        ]
        self._next = 0

    def reset_scope(self) -> None:
        """Clear the shared cache scope (between workloads, not between
        queries — cross-query reuse is the point of the front door)."""
        self.runner.reset_query_scope()

    def execute(self, plan: Node) -> tuple[Table, ExecStats]:
        """Run one query on the next lane (round-robin)."""
        lane = self.lanes[self._next % len(self.lanes)]
        self._next += 1
        return lane.execute(plan)

    def run(self, plans) -> list[tuple[Table, ExecStats, float]]:
        """Run a workload; returns ``(table, stats, latency_s)`` per
        query, with latency measured submit→last-verdict so benchmarks
        can report p99 time-to-verdict."""
        out = []
        for plan in plans:
            t0 = time.perf_counter()
            table, stats = self.execute(plan)
            out.append((table, stats, time.perf_counter() - t0))
        return out
