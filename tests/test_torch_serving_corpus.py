"""Hybrid queries whose semantic filters go to a language model: one
corpus query per schema (``benchmarks/corpus.py`` Q5, Q13, Q16, Q23,
q8) at scale 0.15 under the default ``CostParams()``, run in each
package through per-schema ``FrontDoor``s that share ONE runner over
``ModelBackend.from_engine(engine)`` (continuous serving, one shared
function cache), the two engines on the same carried-across weights.
Rows, order, ``llm_calls``, ``cache_hits``, ``null_skipped``,
``probe_rows``, ``pipeline_syncs``, ``serving_syncs`` and backend calls
must be identical. The same holds for one query (q8) over a tiny
hybrid (hymba-1.5b: attention with a sliding window beside Mamba-2
heads)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_corpus_check import _freeze, port_plan  # noqa: E402
import benchmarks.corpus as corpus  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.core import optimize  # noqa: E402
from repro.data import SCHEMAS  # noqa: E402
from repro.engine import FrontDoor  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.semantic import ModelBackend, SemanticRunner  # noqa: E402
from repro.serving.engine import ServingEngine  # noqa: E402
from repro.sharding import ShardingPolicy  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.data import SCHEMAS as PORT_SCHEMAS  # noqa: E402
from repro_torch.engine import FrontDoor as PortFrontDoor  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.semantic import ModelBackend as PortBackend  # noqa: E402
from repro_torch.semantic import SemanticRunner as PortRunner  # noqa: E402
from repro_torch.serving import ServingEngine as PortEngine  # noqa: E402

SCALE = 0.15
QIDS = ("Q5", "Q13", "Q16", "Q23", "q8")  # one per schema
FIELDS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
          "pipeline_syncs", "serving_syncs")


def _specs(qids=QIDS):
    by_id = {s.qid: s for s in corpus.ALL_QUERIES}
    return [by_id[q] for q in qids]


def _run(port: bool, arch: str = "stablelm-3b", qids=QIDS):
    cfg = get_tiny(arch).replace(vocab_size=512)
    params = init_params(cfg, jax.random.PRNGKey(0))
    if port:
        eng = PortEngine(cfg, params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu"), batch_size=16,
            max_seq=48, device="cpu")
        backend = PortBackend.from_engine(eng)
        runner = PortRunner(backend)
    else:
        eng = ServingEngine(cfg, params, ShardingPolicy.single(),
                            batch_size=16, max_seq=48)
        backend = ModelBackend.from_engine(eng)
        runner = SemanticRunner(backend)
    out = []
    for spec in _specs(qids):
        if port:
            db = PORT_SCHEMAS[spec.schema](seed=0, scale=SCALE,
                                           device="cpu")
            door = PortFrontDoor(db, runner, n_lanes=2)
            plan = port_core.optimize(port_plan(spec), db.catalog(),
                                      strategy="cost").plan
        else:
            db = SCHEMAS[spec.schema](seed=0, scale=SCALE)
            door = FrontDoor(db, runner, n_lanes=2)
            plan = optimize(spec.build(), db.catalog(), strategy="cost").plan
        table, stats = door.execute(plan)
        rows = _freeze(db.materialize(table, list(spec.out_cols)))
        out.append((spec.qid, rows, {f: getattr(stats, f) for f in FIELDS}))
    return out, backend.calls, eng.stats


@pytest.fixture(scope="module")
def runs():
    return _run(port=False), _run(port=True)


@pytest.mark.parametrize("i", range(len(QIDS)), ids=QIDS)
def test_query_matches_reference(runs, i):
    (want, _, _), (got, _, _) = runs
    qid, rows, stats = got[i]
    assert qid == want[i][0]
    assert rows == want[i][1], qid
    assert stats == want[i][2], qid


def test_backend_calls_and_serving(runs):
    (want, calls_r, st_r), (got, calls_p, st_p) = runs
    assert calls_p == calls_r > 0
    assert sum(s["llm_calls"] for _, _, s in got) == calls_p
    assert sum(s["serving_syncs"] for _, _, s in got) == st_p.decode_steps
    for f in ("prompts", "batches", "prefill_tokens", "decode_steps",
              "decode_tokens"):
        assert getattr(st_p, f) == getattr(st_r, f), f


def test_hybrid_query_matches_reference():
    want, calls_r, st_r = _run(False, "hymba-1.5b", ("q8",))
    got, calls_p, st_p = _run(True, "hymba-1.5b", ("q8",))
    assert got == want
    assert calls_p == calls_r > 0
    for f in ("prompts", "batches", "prefill_tokens", "decode_steps",
              "decode_tokens"):
        assert getattr(st_p, f) == getattr(st_r, f), f
