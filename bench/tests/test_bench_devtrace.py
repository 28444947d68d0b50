"""The traced window's arithmetic and the per-layer readers on a record
made by hand (the profiler itself runs on the card only)."""
import pytest

from bench import devtrace, flops, manifest, peaks


def window(events, t0=0, t1=100):
    w = devtrace.Window.__new__(devtrace.Window)
    w.t0, w.t1, w.events = t0, t1, events
    return w


def test_busy_is_the_union_and_gaps_its_complement():
    w = window([("a", 10, 20), ("b", 15, 30), ("c", 50, 60),
                ("a", 55, 58)])
    assert w.busy() == [[10, 30], [50, 60]]
    assert w.busy_s == 30 / 1e9
    assert w.gaps() == [(0, 10), (30, 50), (60, 100)]
    assert w.by_name() == {"a": 13 / 1e9, "b": 15 / 1e9, "c": 10 / 1e9}


def test_idle_is_split_by_the_host_phase_it_fell_in():
    w = window([("k", 10, 20), ("k", 40, 90)])
    marks = [(5, "optimize"), (30, "round"), (45, "execute")]
    idle = w.idle_by_phase(marks)
    # gaps 0-10, 20-40, 90-100: 0-5 before any mark, 5-10 optimize,
    # 20-30 optimize, 30-40 round, 90-100 execute
    assert idle == pytest.approx({"harness": 5e-9, "optimize": 15e-9,
                                  "round": 10e-9, "execute": 10e-9})
    assert sum(idle.values()) == pytest.approx(40e-9)


CFG = manifest.config("starcoder2-3b")


def record(**trace):
    base = {"window_s": 2.0, "busy_s": 1.5, "by_name": {},
            "admit_ms": [], "round_ms": [], "k7": {}, "k8": {},
            "k8_lengths": []}
    base.update(trace)
    return {"config": CFG, "trace": base, "requests": [], "queries": 1}


def test_rooflines_read_bound_over_device_time():
    shape7 = (16, 24, 2, 128, 128, 128)
    shape8 = (16, 24, 2, 131, 128)
    lengths = [20] * 16
    run = record(
        k7={(shape7, "causal"): 30},
        k8={(shape8, "lengths"): 60},
        k8_lengths=[lengths, lengths],
        by_name={"void (anonymous namespace)::flash_fwd_kernel<8, true>(x)":
                 0.01, "void decode_kernel<128>(Args)": 0.004,
                 "sgemm": 1.0})
    b7 = 30 * flops.bound_s(*flops.k7_work(shape7, "causal"),
                            peaks.DENSE_TENSOR_FLOPS, peaks.HBM_BYTES_PER_S)
    b8 = 60 * flops.bound_s(*flops.k8_work(shape8, lengths),
                            peaks.DENSE_TENSOR_FLOPS, peaks.HBM_BYTES_PER_S)
    assert manifest.metric_reader("k7_roofline")(run) == \
        pytest.approx(100 * b7 / 0.01)
    assert manifest.metric_reader("k8_roofline")(run) == \
        pytest.approx(100 * b8 / 0.004)
    assert manifest.metric_reader("device_idle")(run) == pytest.approx(25)


def test_readers_return_nothing_without_something_to_read():
    run = record()
    for name in ("k7_roofline", "k8_roofline", "admit_ms", "round_ms",
                 "mfu"):
        assert manifest.metric_reader(name)(run) is None
    assert manifest.metric_reader("k7_roofline")({"trace": None}) is None


def test_k8_launches_must_match_rounds_and_layers():
    shape8 = (16, 24, 2, 131, 128)
    run = record(k8={(shape8, "lengths"): 59}, k8_lengths=[[1] * 16] * 2,
                 by_name={"decode_kernel": 1.0})
    with pytest.raises(ValueError):
        manifest.metric_reader("k8_roofline")(run)


def test_mfu_counts_the_served_requests():
    prompt = "Is this review positive? It was fine. Answer YES or NO."
    run = record()
    run["requests"] = [(prompt, [7, 9])]
    got = manifest.metric_reader("mfu")(run)
    from bench.ref import tokenizer as tk

    n = len(tk.prompt_tokens(prompt, 128, CFG["vocab_size"]))
    want = 100 * flops.model_flops(CFG, [(n, 2)]) / (
        2.0 * peaks.DENSE_TENSOR_FLOPS)
    assert got == pytest.approx(want)
