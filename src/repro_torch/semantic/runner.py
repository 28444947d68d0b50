"""Batched semantic-operator evaluation with function caching.

``SemanticRunner`` is the single entry point the relational executor uses
for SF / SP / SJ work. Two paths:

* ``evaluate`` — legacy per-row path: renders one prompt per input row,
  dedups through the ``FunctionCache`` and sends distinct misses to the
  backend.
* ``evaluate_unique`` — vectorised path: the executor has already
  collapsed rows to distinct-key *representatives* (via the
  ``hash_dedup`` group build) and passes each representative's
  row multiplicity in ``counts``; prompts are rendered only for
  representatives — and only for representatives the cache's key-probe
  fast path (keyed on the kernel's row hash + exact key row) has not
  already bound to a prompt in this scope. Cache statistics are
  weighted so ``llm_calls`` / ``cache_hits`` / ``null_skipped`` match
  the per-row path exactly.

Backend dispatch is chunked: distinct misses go out in slices of
``max_batch_rows`` (defaulting to the backend's ``preferred_batch_rows``,
which ``ModelBackend`` aligns with the serving engine's bucket size) so a
huge pulled-up filter becomes a stream of bounded batches instead of one
monolithic ``evaluate_batch``. Against an async-capable backend
(``supports_async`` — the continuous serving engine) the chunks are
*submitted as tickets* instead of drained one by one: context
construction for chunk k+1 overlaps device decode of chunk k, and each
representative's row multiplicity rides along as its fair-admission
weight (see ``docs/serving.md``).

NULL semantics (paper §4.1): a row whose referenced value is NULL requires
no LLM call; SF(NULL) = NULL (row excluded), SP(NULL) = NULL value.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .backend import Backend
from .cache import (
    KEY_MISS,
    VERDICT_FALSE,
    VERDICT_MISS,
    VERDICT_NULL,
    VERDICT_TRUE,
    FunctionCache,
)

_TEMPLATE_COL = re.compile(r"\{([A-Za-z_][\w]*\.[A-Za-z_][\w]*)\}")

# placeholder marking a representative the device verdict table already
# resolved — never rendered, never probed against the prompt store
_TABLE_HIT = object()


def render_prompt(phi: str, ctx: dict[str, dict]) -> Optional[str]:
    """Substitute {table.col} placeholders from payload rows. Returns None
    if any referenced value is NULL/missing (no LLM call needed).

    Single-pass substitution: a substituted *value* that itself contains
    ``{table.col}`` text is emitted verbatim, never re-expanded (the
    prompt-injection analogue of SQL parameter binding).
    """
    missing = False

    def _sub(m: "re.Match[str]") -> str:
        nonlocal missing
        t, c = m.group(1).split(".", 1)
        row = ctx.get(t)
        if row is None:
            missing = True
            return m.group(0)
        v = row.get(c)
        if v is None:
            missing = True
            return m.group(0)
        return str(v)

    out = _TEMPLATE_COL.sub(_sub, phi)
    return None if missing else out


@dataclass
class SemanticResult:
    # one value per context passed in — per input row on the per-row path,
    # per distinct-key representative on the vectorized path (scatter
    # through the executor's inverse map); None = NULL (no call made)
    values: list[object]
    distinct_calls: int
    cache_hits: int
    null_rows: int
    prompts_rendered: int = 0


class SemanticRunner:
    def __init__(self, backend: Backend, cache: Optional[FunctionCache] = None,
                 max_batch_rows: Optional[int] = None):
        self.backend = backend
        self.cache = cache if cache is not None else FunctionCache()
        # None -> follow the backend's preference; backends without one
        # get a single monolithic batch (the seed behaviour).
        self.max_batch_rows = max_batch_rows

    def reset_query_scope(self) -> None:
        """Paper §5: the cache is scoped per query execution."""
        self.cache.clear()
        self.cache.stats.reset()

    # ------------------------------------------------------------ dispatch
    def _batch_limit(self) -> Optional[int]:
        if self.max_batch_rows is not None:
            return self.max_batch_rows
        return getattr(self.backend, "preferred_batch_rows", None)

    @staticmethod
    def _ctx_slice(ctxs, keys, s, e):
        """Materialize contexts for one chunk: ``ctxs`` is either a
        prebuilt list or a lazy builder called with the key slice (the
        async path defers host-side context construction until the
        chunk is actually submitted, so it overlaps device decode of
        the previous chunk)."""
        if callable(ctxs):
            return ctxs(keys[s:e])
        return list(ctxs[s:e])

    def _dispatch(self, keys: list, ctxs,
                  weights: Optional[Sequence[int]] = None) -> list[object]:
        """Send distinct misses to the backend.

        Sync backends get bounded chunks, each drained before the next
        is built (the legacy shape). An async-capable backend
        (``supports_async``) instead has every chunk submitted as a
        ticket up front: ``submit_batch`` only enqueues + launches
        prefill (asynchronously), so rendering/encoding chunk k+1
        overlaps decode of chunk k, and ``collect`` drains everything
        at the end. ``weights`` (per-key row multiplicities) feed the
        scheduler's row-weighted fair admission."""
        if not keys:
            return []
        limit = self._batch_limit()
        step = limit if limit else len(keys)
        if getattr(self.backend, "supports_async", False):
            handles = []
            for s in range(0, len(keys), step):
                w = list(weights[s:s + step]) if weights is not None \
                    else None
                handles.append(self.backend.submit_batch(
                    list(keys[s:s + step]),
                    self._ctx_slice(ctxs, keys, s, s + step),
                    weights=w))
            return self.backend.collect(handles)
        out: list[object] = []
        for s in range(0, len(keys), step):
            out.extend(self.backend.evaluate_batch(
                list(keys[s:s + step]),
                self._ctx_slice(ctxs, keys, s, s + step)))
        return out

    # ------------------------------------------------------------ evaluate
    def evaluate(
        self,
        phi: str,
        contexts: Sequence[dict[str, dict]],
        out_dtype: str = "bool",
    ) -> SemanticResult:
        """Per-row path: one rendered prompt per context."""
        return self.evaluate_unique(phi, contexts, counts=None,
                                    out_dtype=out_dtype)

    def evaluate_unique(
        self,
        phi: str,
        contexts: Sequence[dict[str, dict]],
        counts: Optional[Sequence[int]] = None,
        out_dtype: str = "bool",
        key_ids: Optional[Sequence[object]] = None,
        key_hashes=None,
        key_fps=None,
    ) -> SemanticResult:
        """Evaluate distinct-key representatives. ``counts[i]`` is the
        number of input rows context i stands for (None = all 1, i.e. the
        per-row path). Returned ``values`` are per *representative*; the
        caller scatters them back through its inverse mapping. Stats are
        row-weighted so accounting matches per-row execution.

        ``key_ids[i]`` (optional) is a stable identity of representative
        i — the dedup kernel's (row hash, key row) pair — feeding the
        ``FunctionCache`` key-probe fast path: a representative an
        earlier operator already resolved under the same φ reuses its
        rendered prompt (or NULL verdict) without re-rendering, and
        ``prompts_rendered`` counts only actual renders.

        ``key_hashes``/``key_fps`` (optional uint32 arrays, one per
        representative) additionally feed the device ``VerdictTable``
        for boolean operators: representatives whose verdict the table
        already holds resolve in one device gather, skipping the render,
        the key-probe dict AND the prompt-store lookup; fresh verdicts
        are bound back after the batch. Cache statistics are unchanged
        by either fast path — a key- or table-hit row still accounts one
        probe and one hit per input row, exactly as per-row execution
        would."""
        vt = self.cache.verdicts
        use_table = (vt.enabled and out_dtype == "bool"
                     and key_hashes is not None and key_fps is not None
                     and len(contexts) > 0)
        table_v = vt.probe(phi, key_hashes, key_fps) if use_table else None
        if key_ids is not None:
            known = self.cache.probe_keys([(phi, k) for k in key_ids])
        else:
            known = None
        prompts: list[object] = []
        resolved: dict[int, bool] = {}
        table_null: set[int] = set()
        rendered = 0
        new_bindings: list[tuple[object, Optional[str]]] = []
        for i, ctx in enumerate(contexts):
            if table_v is not None and table_v[i] != VERDICT_MISS:
                if table_v[i] == VERDICT_NULL:
                    table_null.add(i)
                    prompts.append(None)
                else:
                    resolved[i] = bool(table_v[i] == VERDICT_TRUE)
                    prompts.append(_TABLE_HIT)
                continue
            if known is not None and known[i] is not KEY_MISS:
                prompts.append(known[i])
                continue
            p = render_prompt(phi, ctx)
            rendered += 1
            prompts.append(p)
            if key_ids is not None:
                new_bindings.append(((phi, key_ids[i]), p))
        if new_bindings:
            self.cache.bind_keys(new_bindings)
        if counts is None:
            counts = [1] * len(prompts)
        live_idx = [i for i, p in enumerate(prompts)
                    if p is not None and p is not _TABLE_HIT]
        null_rows = int(sum(counts[i] for i, p in enumerate(prompts)
                            if p is None))

        misses_before = self.cache.stats.misses
        hits_before = self.cache.stats.hits
        # a table-hit representative's rows would each probe (and hit)
        # the prompt store on the per-row path — account them identically
        table_rows = int(sum(counts[i] for i in resolved))
        self.cache.stats.probes += table_rows
        self.cache.stats.hits += table_rows

        def compute(missing_keys):
            key_to_ctx = {}
            row_weight: dict[object, int] = {}
            for i in live_idx:
                key_to_ctx.setdefault(prompts[i], contexts[i])
                row_weight[prompts[i]] = (row_weight.get(prompts[i], 0)
                                          + int(counts[i]))

            def build_ctx(chunk_keys):
                batch_ctx = []
                for k in chunk_keys:
                    c = dict(key_to_ctx[k])
                    c["__phi__"] = phi
                    c["__dtype__"] = out_dtype
                    batch_ctx.append(c)
                return batch_ctx

            mk = list(missing_keys)
            return self._dispatch(mk, build_ctx,
                                  weights=[row_weight[k] for k in mk])

        live_results = self.cache.lookup_batch(
            [prompts[i] for i in live_idx], compute,
            counts=[counts[i] for i in live_idx],
        )
        values: list[object] = [None] * len(prompts)
        for i, r in zip(live_idx, live_results):
            values[i] = r
        for i, v in resolved.items():
            values[i] = v
        if use_table:
            self._bind_verdicts(vt, phi, key_hashes, key_fps, prompts,
                                values, resolved.keys() | table_null)
        return SemanticResult(
            values=values,
            distinct_calls=self.cache.stats.misses - misses_before,
            cache_hits=self.cache.stats.hits - hits_before,
            null_rows=null_rows,
            prompts_rendered=rendered,
        )

    @staticmethod
    def _bind_verdicts(vt, phi, key_hashes, key_fps, prompts, values,
                       already_bound) -> None:
        """Scatter this batch's fresh boolean verdicts (incl. NULLs)
        into the device verdict table; table-hit reps (bool AND NULL)
        are already bound and skip the rebind scatter."""
        idx = [i for i in range(len(prompts)) if i not in already_bound]
        if not idx:
            return
        verdicts = np.asarray(
            [VERDICT_NULL if prompts[i] is None
             else (VERDICT_TRUE if bool(values[i]) else VERDICT_FALSE)
             for i in idx], dtype=np.int8)
        sel = np.asarray(idx)
        # sal: ok[SYNC] rep hashes are host uint32 from dedup_representatives
        vt.bind(phi, np.asarray(key_hashes)[sel], np.asarray(key_fps)[sel],
                verdicts)
