"""The check's probes leave the timed path as it is on every step they
do not sample: which steps they take is decided from the scheduler's
host state, and an admission or round not taken reaches the engine
with its tensors untouched."""
import types

import torch

from bench import probes


class Opaque:
    """A stand-in for a device tensor: any read but its shape fails."""

    def __init__(self, shape):
        self.shape = shape

    def __getattr__(self, name):
        raise AssertionError(f"the probe read {name!r} of a step it did "
                             f"not sample")


def engine(b=4, layers=2, T=10, K=1, d=2):
    got = []
    sched = types.SimpleNamespace(
        _slot_req=[None] * b,
        _cache={"k": torch.zeros(layers, b, T, K, d),
                "v": torch.zeros(layers, b, T, K, d)})
    sched.live_slots = lambda: [s for s, r in enumerate(sched._slot_req)
                                if r is not None]
    eng = types.SimpleNamespace(
        batch_size=b, max_seq=6, scheduler=sched,
        _prefill_insert=lambda *a: got.append(("admit", a)),
        _decode_round=lambda *a: got.append(("round", a)))
    return eng, got


def request(prompt):
    return types.SimpleNamespace(prompt=prompt)


def test_unsampled_steps_read_nothing_from_the_device():
    eng, got = engine()
    steps = probes.Steps(eng, admits={1}, rounds={1}, longest={"long"},
                         positions=5)
    sched = eng.scheduler
    sched._slot_req[0], sched._slot_req[2] = request("a"), request("b")
    adm = Opaque((2, 8))
    eng._prefill_insert("cache", "cur", "pos", "live", "rem", adm)
    cur = Opaque((4,))
    eng._decode_round("cache", cur, "pos", "live", "rem")
    steps.close()
    assert got == [("admit", ("cache", "cur", "pos", "live", "rem", adm)),
                   ("round", ("cache", cur, "pos", "live", "rem"))]
    assert steps.admissions == [] and steps.rounds == []


def test_a_sampled_step_is_copied_to_the_host_as_it_was():
    eng, _ = engine()
    eng._decode_round = lambda *a: torch.arange(8, dtype=torch.int32)
    sched = eng.scheduler
    k = sched._cache["k"]
    k.copy_(torch.arange(k.numel(), dtype=torch.float32).view(k.shape))
    steps = probes.Steps(eng, admits={0}, rounds=set(), longest={"long"},
                         positions=5)
    sched._slot_req[1], sched._slot_req[3] = request("a"), request("b")
    adm = torch.zeros(2, 8, dtype=torch.int32)
    adm[:, -2] = torch.tensor([1, 3])
    eng._prefill_insert(sched._cache, None, None, None, None, adm)
    sched._slot_req[0] = request("long")  # the longest: its first round
    cur = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    pos = torch.tensor([4, 0, 2, 1], dtype=torch.int32)
    live = torch.tensor([True, True, False, True])
    eng._decode_round(sched._cache, cur, pos, live, None)
    eng._decode_round(sched._cache, cur, pos, live, None)
    steps.close()
    (a,), (r,) = steps.admissions, steps.rounds
    assert a["prompts"] == ["a", "b"] and torch.equal(a["adm"], adm)
    assert torch.equal(a["kv"][0], k[:, [1, 3], :5])
    assert torch.equal(r["state"], torch.stack([cur, pos, live.int()]))
    assert torch.equal(r["kv"][0], k[:, :, :5])
    assert torch.equal(r["emit"], torch.arange(4, dtype=torch.int32))
