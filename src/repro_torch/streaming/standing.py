"""Standing queries over streaming ingestion.

A ``StandingQuery`` re-runs one registered plan after every micro-batch
and emits the ROW DELTA against its previous output (added and removed
records, as multisets — a blocking operator like LIMIT or an aggregate
can retract rows, so removals are first-class) plus the per-batch
``ExecStats``. Because each standing query owns its ``SemanticRunner``
scope (one ``FunctionCache`` / ``VerdictTable`` kept warm across
batches), the incremental ``llm_calls`` of batch ``k`` equal the cold
full-recompute delta: only keys never seen before reach the backend —
PLOP's caching theorem applied over time.

Delta-emission semantics: ``BatchDelta.added`` / ``removed`` are
order-preserving multiset differences of the materialised outputs
(cumulative output = previous output - removed + added, row-for-row and
order-equivalent to a cold recompute on the concatenated snapshot —
the invariant ``tests/test_streaming.py`` pins for the reference across
all 44 corpus queries, and ``tests/test_torch_streaming.py`` for the
port). NaN compares equal to itself inside a delta key so float
rows diff stably.

``StreamSession`` bundles the pieces: one ``StreamContext`` (shared
incremental join builds) plus per-query executors wired to it, with
``ingest`` returning ``{qid: BatchDelta}``.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

from ..engine.exec import ExecStats, Executor
from ..engine.table import Database, Table
from ..semantic.runner import SemanticRunner
from .ingest import StreamContext


def freeze_record(rec: dict) -> tuple:
    """Hashable, NaN-stable key for one materialised output record
    (column-sorted items; NaN → a sentinel so it equals itself)."""
    items = []
    for k in sorted(rec):
        v = rec[k]
        if isinstance(v, float) and math.isnan(v):
            v = "__nan__"
        items.append((k, v))
    return tuple(items)


def _multiset_minus(a: list[dict], b: list[dict]) -> list[dict]:
    """Records of ``a`` not matched by ``b`` (multiset difference,
    preserving ``a``'s order; duplicates cancel one-for-one)."""
    remaining = Counter(freeze_record(r) for r in b)
    out = []
    for r in a:
        key = freeze_record(r)
        if remaining[key] > 0:
            remaining[key] -= 1
        else:
            out.append(r)
    return out


@dataclass
class BatchDelta:
    """One standing query's reaction to one micro-batch: the new rows,
    the retracted rows, and the batch's ``ExecStats`` (incremental
    ``llm_calls`` — the full-recompute delta)."""

    qid: str
    batch: int
    added: list[dict] = field(default_factory=list)
    removed: list[dict] = field(default_factory=list)
    stats: ExecStats | None = None
    output: list[dict] = field(default_factory=list)


class StandingQuery:
    """One registered plan kept continuously answered over a streamed
    database. ``refresh`` re-executes and diffs against the previous
    materialised output; the runner scope (caches) persists across
    refreshes, so repeated keys never re-reach the backend."""

    def __init__(self, qid: str, plan, executor: Executor, db: Database,
                 out_cols=None, emit: bool = True):
        self.qid = qid
        self.plan = plan
        self.executor = executor
        self.db = db
        self.out_cols = list(out_cols) if out_cols else None
        self.emit = emit
        self.total_llm_calls = 0
        self.last_table: Table | None = None
        self.last_stats: ExecStats | None = None
        self._prev: list[dict] = []

    def refresh(self, batch: int = 0) -> BatchDelta:
        """Re-run the plan on the current snapshot and emit the row
        delta (skipping materialisation when ``emit=False`` — the
        bench's timed path)."""
        table, stats = self.executor.execute(self.plan)
        self.last_table, self.last_stats = table, stats
        self.total_llm_calls += stats.llm_calls
        delta = BatchDelta(qid=self.qid, batch=batch, stats=stats)
        if self.emit:
            out = self.db.materialize(table, self.out_cols)
            delta.added = _multiset_minus(out, self._prev)
            delta.removed = _multiset_minus(self._prev, out)
            delta.output = out
            self._prev = out
        return delta


class StreamSession:
    """Micro-batch front end over one database: a shared
    ``StreamContext`` (incremental join builds folded on every append)
    plus per-query ``StandingQuery`` wrappers, each with its OWN runner
    scope over a shared backend — queries keep warm caches without
    cross-query hit leakage, matching the cold oracle's
    fresh-cache-per-query accounting."""

    def __init__(self, db: Database, backend, vectorized: bool = True,
                 kernel_impl: str = "auto", min_cap: int = 1024):
        self.db = db
        self.backend = backend
        self.vectorized = vectorized
        self.kernel_impl = kernel_impl
        self.ctx = StreamContext(db, kernel_impl=kernel_impl,
                                 min_cap=min_cap)
        self.queries: dict[str, StandingQuery] = {}

    def register(self, qid: str, plan, out_cols=None,
                 prime: bool = True, emit: bool = True) -> StandingQuery:
        """Install a standing query (its own ``SemanticRunner`` scope;
        ``fresh_cache_per_query=False`` keeps it warm across batches)
        and register its equi-join build sides with the shared context.
        ``prime=True`` runs it once on the current snapshot."""
        runner = SemanticRunner(self.backend)
        ex = Executor(self.db, runner, fresh_cache_per_query=False,
                      vectorized=self.vectorized,
                      kernel_impl=self.kernel_impl)
        ex.stream = self.ctx
        self.ctx.register_plan(plan)
        sq = StandingQuery(qid, plan, ex, self.db, out_cols=out_cols,
                           emit=emit)
        self.queries[qid] = sq
        if prime:
            sq.refresh(batch=0)
        return sq

    def ingest(self, table: str, records: list[dict]
               ) -> dict[str, BatchDelta]:
        """One micro-batch: append + fold into the incremental
        structures, then refresh every standing query."""
        self.ctx.append(table, records)
        return {qid: sq.refresh(batch=self.ctx.batches)
                for qid, sq in self.queries.items()}
