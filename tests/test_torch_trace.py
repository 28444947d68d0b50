"""The port's span recorder (``repro_torch.trace``) and the spans of the
serving tier and the mixture of experts: off by default and then free
of allocation, nested spans with their parents and trace ids, one
``serving.request`` a request with its query's id, an admission's
upload and prefill, a round's launch, fetch and harvest, the MoE spans
once a layer a step, and the admission upload counted as a serving
sync (``serving_admit``) outside ``pipeline_syncs``."""
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.core import Q, col  # noqa: E402
from repro_torch.data import make_ecommerce  # noqa: E402
from repro_torch.data.schemas import PRODUCT_IS_ELECTRONICS  # noqa: E402
from repro_torch.engine import FrontDoor  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.semantic import ModelBackend, SemanticRunner  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

REC = trace.RECORDER


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts and ends with the recorder off and empty."""
    REC.disable()
    REC.take()
    yield REC
    REC.disable()
    REC.take()


def engine(arch: str, batch_size: int = 4) -> ServingEngine:
    cfg = get_tiny(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    return ServingEngine(cfg, params, batch_size=batch_size, max_seq=32,
                         max_new_tokens=2, device="cpu")


def by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def children(spans, parent) -> list:
    return sorted(s.name for s in spans if s.parent == parent.span_id)


def test_off_records_nothing_and_returns_one_object():
    assert not REC.on
    first = trace.span("serving.round")
    assert first is trace.OFF
    for name in ("exec.query", "model.moe.route", "anything"):
        assert trace.span(name) is first
    with trace.span("serving.admit") as sp:
        sp.set("width", 4)
        with trace.span("serving.admit.upload"):
            assert REC.trace_id() == 0
    assert REC.take() == [] and REC.stack == []


def test_spans_nest_and_self_time_is_the_rest():
    REC.enable()
    with trace.span("exec.query") as q:
        with trace.span("serving.round") as r:
            r.set("live", 3)
            with trace.span("serving.round.launch"):
                time.sleep(0.002)
            with trace.span("serving.round.fetch"):
                assert REC.trace_id() == q.span_id
            time.sleep(0.001)
    REC.disable()
    with trace.span("exec.query"):
        pass
    got = REC.take()
    assert [s.name for s in got] == ["serving.round.launch",
                                     "serving.round.fetch",
                                     "serving.round", "exec.query"]
    launch, fetch, rnd, query = got
    assert query.parent == 0 and query.trace == query.span_id
    assert rnd.parent == query.span_id and rnd.attrs == {"live": 3}
    for s in got:
        assert s.trace == query.span_id
        assert s.start_ns <= s.end_ns
    for c in (launch, fetch):
        assert c.parent == rnd.span_id
        assert rnd.start_ns <= c.start_ns <= c.end_ns <= rnd.end_ns
    # self time: the duration less the children's, which do not overlap
    self_ns = {s.span_id: (s.end_ns - s.start_ns) - sum(
        c.end_ns - c.start_ns for c in got if c.parent == s.span_id)
        for s in got}
    assert launch.end_ns <= fetch.start_ns
    assert self_ns[rnd.span_id] == (rnd.end_ns - rnd.start_ns) - (
        launch.end_ns - launch.start_ns) - (fetch.end_ns - fetch.start_ns)
    assert self_ns[rnd.span_id] >= 1_000_000  # the sleep outside both
    assert self_ns[launch.span_id] == launch.end_ns - launch.start_ns
    assert self_ns[query.span_id] == query.end_ns - query.start_ns - (
        rnd.end_ns - rnd.start_ns)


def test_the_clock_is_the_epoch_clock_of_the_profiler():
    REC.enable()
    now = time.time_ns()
    assert abs(REC.now_ns() - now) < 5_000_000
    assert abs(REC.stamp_ns(time.perf_counter()) - now) < 5_000_000


def query_plan():
    return (Q.scan("products").where(col("products.price") < 400)
            .sem_filter(PRODUCT_IS_ELECTRONICS)
            .select("products.title").build())


def front_door_query(eng, on: bool):
    db = make_ecommerce(seed=4, scale=0.05, device="cpu")
    backend = ModelBackend.from_engine(eng)
    door = FrontDoor(db, SemanticRunner(backend), n_lanes=2)
    if on:
        REC.enable()
    table, stats = door.execute(query_plan())
    REC.disable()
    return db.materialize(table, ["products.title"]), stats, backend.calls


def test_front_door_query_spans_and_serving_syncs():
    eng = engine("starcoder2-3b")
    rows_off, stats_off, calls_off = front_door_query(eng, on=False)
    assert REC.take() == []
    eng = engine("starcoder2-3b")
    rows, stats, calls = front_door_query(eng, on=True)
    got = REC.take()
    assert rows == rows_off and calls == calls_off > 4
    assert stats.pipeline_syncs == stats_off.pipeline_syncs
    # one sync a round and one an admission batch, all serving syncs
    assert stats.serving_syncs == stats_off.serving_syncs == \
        eng.stats.decode_steps + eng.stats.batches
    names = by_name(got)
    assert set(names) == {"exec.query", "serving.request", "serving.admit",
                          "serving.admit.upload", "serving.admit.prefill",
                          "serving.round", "serving.round.launch",
                          "serving.round.fetch", "serving.round.harvest"}
    (query,) = names["exec.query"]
    assert query.trace == query.span_id
    for s in got:
        assert s.trace == query.span_id, s
    reqs = names["serving.request"]
    assert len(reqs) == calls == eng.stats.prompts
    for r in reqs:
        assert r.attrs["query"] == query.span_id == r.parent
        assert 0 <= r.attrs["queued_ns"] <= r.end_ns - r.start_ns
        assert query.start_ns <= r.start_ns <= r.end_ns <= query.end_ns
    assert sorted(r.attrs["rid"] for r in reqs) == list(range(calls))
    admits = names["serving.admit"]
    assert len(admits) == eng.stats.batches
    assert sum(a.attrs["width"] for a in admits) == calls
    assert sum(a.attrs["tokens"] for a in admits) == \
        eng.stats.prefill_tokens
    assert sum(a.attrs["positions"] for a in admits) == \
        eng.stats.prefill_positions
    for a in admits:
        assert children(got, a) == ["serving.admit.prefill",
                                    "serving.admit.upload"]
    rounds = names["serving.round"]
    assert len(rounds) == eng.stats.decode_steps
    assert sum(r.attrs["live"] for r in rounds) == \
        eng.stats.live_slot_steps
    for r in rounds:
        assert children(got, r) == ["serving.round.fetch",
                                    "serving.round.harvest",
                                    "serving.round.launch"]
        assert 1 <= r.attrs["live"] <= eng.batch_size
    # each request was admitted inside an admission span and finished
    # inside a round's harvest (the operator note's walk)
    harvests = names["serving.round.harvest"]
    for r in reqs:
        adm_t = r.start_ns + r.attrs["queued_ns"]
        assert sum(a.start_ns <= adm_t <= a.end_ns for a in admits) == 1
        assert sum(h.start_ns <= r.end_ns <= h.end_ns
                   for h in harvests) == 1


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "starcoder2-3b"))
def test_moe_spans_once_a_layer_a_step(arch):
    eng = engine(arch)
    REC.enable()
    eng.answer([f"moe span probe {i}" for i in range(6)])
    REC.disable()
    names = by_name(REC.take())
    steps = eng.stats.batches + eng.stats.decode_steps
    if arch == "starcoder2-3b":
        assert "model.moe.route" not in names
        assert "model.moe.experts" not in names
        return
    layers = eng.cfg.num_layers
    route, experts = names["model.moe.route"], names["model.moe.experts"]
    assert len(route) == len(experts) == layers * steps
    ids = {s.span_id: s for v in names.values() for s in v}
    for s in route + experts:
        assert ids[s.parent].name in ("serving.admit.prefill",
                                      "serving.round.launch")
    for r, e in zip(route, experts):  # route then experts, a layer
        assert r.parent == e.parent and r.end_ns <= e.start_ns


@pytest.mark.parametrize("arch", ("starcoder2-3b", "olmoe-1b-7b"))
def test_admission_positions_read_by_chip_spans(arch):
    """The ``positions`` of the admissions' spans are the positions the
    engine prefilled (each admission's longest prompt rounded up to 16
    on the dense model, max_seq on the MoE), and ``chip_spans.py``'s
    ``prefill_fill`` reads ``ServingStats.prefill_fill`` from them; spans
    without ``positions`` read None."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_spans.py"
    spec = importlib.util.spec_from_file_location("chip_spans", path)
    chip_spans = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_spans)

    eng = engine(arch)
    REC.enable()
    eng.answer([f"fill probe {i} " + "word " * (3 * i) for i in range(7)])
    REC.disable()
    spans = REC.take()
    admits = by_name(spans)["serving.admit"]
    per_row = {a.attrs["positions"] // a.attrs["width"] for a in admits}
    assert per_row == ({16, 32} if arch == "starcoder2-3b" else {32})
    assert chip_spans.prefill_fill(spans) == eng.stats.prefill_fill < 1
    bare = [s._replace(attrs={"width": 1, "tokens": 3}) for s in admits]
    assert chip_spans.prefill_fill(bare) is None
