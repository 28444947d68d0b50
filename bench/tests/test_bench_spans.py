"""The span readings (``bench/spans.py``) on hand-made run records: idle
time intersected with spans, a kernel put down to the innermost span
open at its launch, the nearest-rank p95 of queue waits, None where
nothing was recorded; and a plain run's record as it was, with the
program's span recorder off after the session."""
import torch

from bench import harness, spans
from bench.tests import tiny

MS = 1_000_000


def span(name, s, e, sid, parent=0, **attrs):
    return (name, s * MS, e * MS, sid, parent, 1, attrs)


def record(spans_, records=(), launches=None, t0=0, t1=100):
    return {"trace": {"spans": list(spans_), "records": list(records),
                      "launches": launches or {}, "t0_ns": t0 * MS,
                      "t1_ns": t1 * MS}}


def kernel(s, e, corr, name="k"):
    return (name, s * MS, e * MS, corr)


def test_idle_is_the_gaps_inside_each_span():
    # device busy [10, 20] and [30, 60]; window [0, 100]
    recs = [kernel(10, 20, 1), kernel(30, 50, 2), kernel(45, 60, 3)]
    run = record([span("serving.round", 15, 35, 1),  # idle 20..30: 10
                  span("serving.round", 55, 80, 2),  # idle 60..80: 20
                  span("serving.admit", 0, 5, 3)],  # idle 0..5: 5
                 recs)
    assert spans.idle_ms(run, "serving.round") == 15.0
    assert spans.idle_ms(run, "serving.admit") == 5.0
    assert spans.idle_ms(run, "serving.request") is None
    assert spans.gaps(recs, 0, 100 * MS) == [
        (0, 10 * MS), (20 * MS, 30 * MS), (60 * MS, 100 * MS)]


def test_a_kernel_goes_to_the_innermost_span_of_its_launch():
    sp = [span("serving.round", 0, 50, 1),
          span("serving.round.launch", 1, 20, 2, 1),
          span("model.moe.route", 2, 5, 3, 2),
          span("model.moe.experts", 5, 12, 4, 2),
          span("serving.round.fetch", 20, 40, 5, 1),
          # written after the fact: overlaps everything, takes nothing
          ("serving.request", 0, 90 * MS, 6, 0, 1, {"queued_ns": 0})]
    # device time runs later than the launches, as on a card
    recs = [kernel(10, 14, 1), kernel(14, 30, 2), kernel(30, 34, 3),
            kernel(34, 38, 4), kernel(60, 70, 5)]
    launches = {1: 3 * MS, 2: 6 * MS, 3: 8 * MS, 4: 15 * MS,
                5: 25 * MS}
    run = record(sp, recs, launches)
    got = {r[3]: s and s[0] for r, s in spans.kernel_spans(run)}
    assert got == {1: "model.moe.route", 2: "model.moe.experts",
                   3: "model.moe.experts", 4: "serving.round.launch",
                   5: "serving.round.fetch"}
    busy = 4 + 16 + 4 + 4 + 10
    assert spans.share(run, "model.moe.experts") == 100 * 20 / busy
    assert spans.share(run, "model.moe.route") == 100 * 4 / busy
    # a record without its launch is left out; a launch outside every
    # span belongs to none
    run = record(sp, recs + [kernel(80, 81, 9)], {**launches, 7: 0})
    assert len(spans.kernel_spans(run)) == 5
    assert spans.innermost(sp[:5], [95 * MS]) == [None]


def test_queue_wait_p95_by_nearest_rank_and_launch_mean():
    reqs = [span("serving.request", 0, 50, i, queued_ns=q * MS)
            for i, q in enumerate([7] + [1] * 18 + [9, 8], 1)]
    run = record(reqs + [span("serving.round.launch", 0, 3, 30),
                         span("serving.round.launch", 5, 10, 31)])
    # 21 waits: rank ceil(0.95 * 21) = 20, the second largest
    assert spans.queue_wait_p95_s(run) == 0.008
    assert spans.p95([3.0]) == 3.0
    assert spans.mean_ms(run, "serving.round.launch") == 4.0


def test_self_time_is_the_duration_less_the_children():
    sp = [span("serving.round", 0, 50, 1),
          span("serving.round.launch", 1, 20, 2, 1),
          span("model.moe.route", 2, 5, 3, 2),
          span("serving.round.fetch", 20, 40, 4, 1),
          ("serving.request", 0, 90 * MS, 5, 1, 1, {"queued_ns": 0})]
    got = spans.self_ns(sp)
    # the request is written after the fact: it is no one's child
    assert got == {1: 11 * MS, 2: 16 * MS, 3: 3 * MS, 4: 20 * MS,
                   5: 90 * MS}


def test_host_time_in_a_span_by_runtime_call():
    sp = [span("serving.round.launch", 0, 10, 1),
          span("serving.round.launch", 20, 40, 2),
          span("serving.round.fetch", 40, 45, 3)]
    calls = [("cudaLaunchKernel", 1 * MS, 2 * MS),
             ("cudaLaunchKernel", 3 * MS, 9 * MS),
             ("cudaLaunchKernel", 21 * MS, 22 * MS),
             ("cudaMemcpyAsync", 41 * MS, 42 * MS),
             ("cudaStreamSynchronize", 42 * MS, 44 * MS),
             # outside every span, and one cut at its span's end
             ("cudaLaunchKernel", 15 * MS, 16 * MS),
             ("cudaLaunchKernel", 38 * MS, 41 * MS)]
    run = record(sp)
    assert spans.calls_in(run, "serving.round.launch") is None
    run["trace"]["calls"] = calls
    got = spans.calls_in(run, "serving.round.launch")
    assert got["calls"] == {"cudaLaunchKernel": {
        "count": 2.0, "ms": 5.0, "max_ms": 6.0}}
    assert got["outside_ms"] == 10.0
    got = spans.calls_in(run, "serving.round.fetch")
    assert got["calls"]["cudaStreamSynchronize"] == {
        "count": 1.0, "ms": 2.0, "max_ms": 2.0}
    assert got["outside_ms"] == 2.0
    assert spans.calls_in(run, "serving.admit.upload") is None


def test_nothing_recorded_reads_none():
    for run in ({"trace": None}, {"trace": {"busy_s": 1.0}}, record([]),
                record([span("serving.round", 0, 5, 1)])):
        assert spans.queue_wait_p95_s(run) is None
        assert spans.mean_ms(run, "serving.round.launch") is None
        assert spans.share(run, "model.moe.experts") is None
        assert spans.share(run, "model.moe.route") is None
        assert spans.idle_ms(run, "serving.admit") is None
    # a dense model: spans, records and launches, but no MoE span
    run = record([span("serving.round", 0, 5, 1)], [kernel(1, 2, 1)],
                 {1: 0})
    assert spans.share(run, "model.moe.experts") is None
    assert spans.idle_ms(run, "serving.round") == 4.0


def test_a_plain_run_record_is_as_before_and_the_recorder_stays_off():
    from repro_torch.trace import RECORDER

    ses = harness.session(tiny.cell(), 2**31 + 17, 0.05, False,
                          torch.device("cpu"))
    assert list(ses.run) == [
        "config", "mix", "setup_s", "window_s", "passes", "queries",
        "optimize_s", "pipeline_syncs", "backend_calls", "ttv_s",
        "requests", "trace"]
    assert ses.run["trace"] is None and ses.breakdown is None
    assert not RECORDER.on and RECORDER.spans == [] and \
        RECORDER.stack == []
