"""Shared check for ``tests/test_torch_corpus_*.py`` and
``tests/test_torch_hashcorpus_*.py``: one corpus query
(``benchmarks/corpus.py``) run by the reference and by the port on
freshly built databases of the same schema, seed and scale, under one
cost configuration (``CONFIGS``: the sort-merge configuration, or the
default ``CostParams()`` under which the planner stamps every join
``hash``), compared on rows, row order, the six ExecStats fields,
backend calls, ``join_physical`` and ``pipeline_syncs``.

The port's plan is built by the corpus's own builder functions with
the port's ``Q``/``col`` swapped in for the call (no file edited)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import benchmarks.corpus as corpus  # noqa: E402

from repro.core import CostParams, optimize  # noqa: E402
from repro.data import SCHEMAS  # noqa: E402
from repro.engine import Executor  # noqa: E402
from repro.semantic import OracleBackend, SemanticRunner  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.data import SCHEMAS as PORT_SCHEMAS  # noqa: E402
from repro_torch.engine import Executor as PortExecutor  # noqa: E402
from repro_torch.semantic import (  # noqa: E402
    OracleBackend as PortOracle,
    SemanticRunner as PortRunner,
)

SCALE = 0.2
SORT_MERGE = dict(w_hash_build=1e9, w_host_join=1e9)
CONFIGS = {"sort_merge": SORT_MERGE, "default": {}}
FIELDS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
          "sem_rows", "rel_rows", "pipeline_syncs", "join_physical")


def specs(schema: str) -> list:
    return [s for s in corpus.ALL_QUERIES if s.schema == schema]


def port_plan(spec):
    """Build ``spec``'s plan with the port's builder."""
    saved = corpus.Q, corpus.col
    corpus.Q, corpus.col = port_core.Q, port_core.col
    try:
        return spec.build()
    finally:
        corpus.Q, corpus.col = saved


def _freeze(recs):
    def fz(v):
        return "NaN" if isinstance(v, float) and v != v else v
    return [tuple((k, fz(v)) for k, v in sorted(r.items())) for r in recs]


def run_reference(spec, impl: str, config: str = "sort_merge"):
    db = SCHEMAS[spec.schema](seed=0, scale=SCALE)
    opt = optimize(spec.build(), db.catalog(), strategy="cost",
                   params=CostParams(**CONFIGS[config]))
    backend = OracleBackend(truths=db.truths)
    ex = Executor(db, SemanticRunner(backend), kernel_impl=impl)
    table, stats = ex.execute(opt.plan)
    return (_freeze(db.materialize(table, list(spec.out_cols))), stats,
            backend.calls)


def run_port(spec, impl: str, config: str = "sort_merge"):
    db = PORT_SCHEMAS[spec.schema](seed=0, scale=SCALE, device="cpu")
    opt = port_core.optimize(port_plan(spec), db.catalog(),
                             strategy="cost",
                             params=port_core.CostParams(**CONFIGS[config]))
    backend = PortOracle(truths=db.truths)
    ex = PortExecutor(db, PortRunner(backend), kernel_impl=impl)
    table, stats = ex.execute(opt.plan)
    return (_freeze(db.materialize(table, list(spec.out_cols))), stats,
            backend.calls)


def default_join_physicals(schema: str) -> dict:
    """``Join.physical`` counts over the schema's corpus plans, planned
    by the port under the default ``CostParams()``."""
    db = PORT_SCHEMAS[schema](seed=0, scale=SCALE, device="cpu")
    cat = db.catalog()
    out: dict = {}
    for spec in specs(schema):
        plan = port_core.optimize(port_plan(spec), cat, strategy="cost",
                                  params=port_core.CostParams()).plan
        for node in plan.walk():
            if isinstance(node, port_core.Join):
                out[node.physical] = out.get(node.physical, 0) + 1
    return out


def check(spec, impl: str, config: str = "sort_merge") -> None:
    """The port at ``impl`` against the reference at ``impl``, both
    planned under ``CONFIGS[config]``; at "ref" the port's "kernel"
    impl (the CUDA wrappers' plain versions on the CPU) is held to the
    same reference run."""
    want_rows, want, want_calls = run_reference(spec, impl, config)
    port_impls = (impl, "kernel") if impl == "ref" else (impl,)
    for p_impl in port_impls:
        rows, stats, calls = run_port(spec, p_impl, config)
        assert rows == want_rows, (spec.qid, p_impl)
        for f in FIELDS:
            assert getattr(stats, f) == getattr(want, f), \
                (spec.qid, p_impl, f)
        assert calls == want_calls, (spec.qid, p_impl)
