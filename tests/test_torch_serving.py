"""The port's serving tier against the reference's, on the same weights.

The reference's parameters (``repro.models.init_params``) are carried
across with ``params_from_numpy``; both engines serve the same prompts
and must give identical answers, continuous and drained (a partial final
chunk included), identical ``ServingStats`` counters, the same
``serving_round``/``serving_decode`` sync counts (the port also counts
each admission's upload, ``serving_admit``), the same slot
assignments under recycling and weighted/FIFO admission, and the same
``ModelBackend`` parsing and tokenizer ids, for dense, MoE
(olmoe-1b-7b, also at a capacity factor that drops rows), SSM
(mamba2-370m), hybrid (hymba-1.5b) and MLA (deepseek-v3-671b) models. The tiny hybrid's window
is 16, so its engines (max_seq 24) keep the last 16 padded positions
in a ring, and a short prompt's first decode sees only the slot it
writes (a reference behaviour the port keeps). On the CPU the port's
attention and SSD take their plain paths; ``TestKernelPathGlue`` runs
the K7/K8/K9 call sites with the kernels' plain versions swapped in.
"""
import random

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_tiny  # noqa: E402
from repro.kernels.sync import HOST_SYNCS as REF_SYNCS  # noqa: E402
from repro.kernels.sync import SERVING_SITES as REF_SITES  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.semantic import ModelBackend  # noqa: E402
from repro.serving.engine import ServingEngine  # noqa: E402
from repro.sharding import ShardingPolicy  # noqa: E402
from repro.training.data import HashTokenizer  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.kernels.sync import HOST_SYNCS, SERVING_SITES  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.semantic import ModelBackend as PortBackend  # noqa: E402
from repro_torch.serving import ServingEngine as PortEngine  # noqa: E402
from repro_torch.serving import ServingStats  # noqa: E402
from repro_torch.training.data import (  # noqa: E402
    HashTokenizer as PortTokenizer,
)

ARCHS = ("stablelm-3b", "starcoder2-3b", "qwen2.5-32b", "olmoe-1b-7b",
         "mamba2-370m", "hymba-1.5b", "deepseek-v3-671b")
COUNTERS = ("prompts", "batches", "prefill_tokens", "decode_steps",
            "prefill_rows", "live_prefill_rows", "slot_steps",
            "live_slot_steps", "decode_tokens", "queued_peak")
_WEIGHTS: dict = {}


def weights(arch: str):
    """(cfg, reference params, port params) of ``arch``'s tiny config
    at vocab 512 (as ``tests/test_serving.py``), from PRNGKey(0)."""
    if arch not in _WEIGHTS:
        cfg = get_tiny(arch).replace(vocab_size=512)
        ref = init_params(cfg, jax.random.PRNGKey(0))
        port = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
        _WEIGHTS[arch] = (cfg, ref, port)
    return _WEIGHTS[arch]


def engines(arch: str, batch_size=4, max_seq=24, max_new=2, **cfg_kw):
    """A fresh reference engine and port engine on the same weights
    (``cfg_kw`` replaces fields of the config the weights were made
    for)."""
    cfg, ref_p, port_p = weights(arch)
    cfg = cfg.replace(**cfg_kw)
    ref = ServingEngine(cfg, ref_p, ShardingPolicy.single(),
                        tokenizer=HashTokenizer(cfg.vocab_size),
                        batch_size=batch_size, max_seq=max_seq,
                        max_new_tokens=max_new)
    port = PortEngine(cfg, port_p, tokenizer=PortTokenizer(cfg.vocab_size),
                      batch_size=batch_size, max_seq=max_seq,
                      max_new_tokens=max_new, device="cpu")
    return ref, port


def counters(stats) -> dict:
    return {f: getattr(stats, f) for f in COUNTERS}


def sites(syncs) -> dict:
    """The reference's serving sites (the port adds ``serving_admit``,
    its admission upload, counted apart)."""
    return {s: syncs.by_site.get(s, 0) for s in REF_SITES}


def admits() -> int:
    return HOST_SYNCS.by_site.get("serving_admit", 0)


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("arch", ARCHS)
def test_answers_stats_and_syncs_match(arch):
    """Continuous then drained over 7 prompts (bucketed 4 + 2 + 1, and
    a partial final drained chunk): identical answers, stats counters
    and serving-site sync counts."""
    ref, port = engines(arch)
    prompts = [f"is item {i} acceptable for {arch}?" for i in range(7)]
    r0, p0, a0 = sites(REF_SYNCS), sites(HOST_SYNCS), admits()
    want = ref.answer(prompts)
    got = port.answer(prompts)
    assert got == want
    assert counters(port.stats) == counters(ref.stats)
    assert port.stats.batches == 3  # widths 4 + 2 + 1
    assert delta(sites(HOST_SYNCS), p0) == delta(sites(REF_SYNCS), r0)
    assert admits() - a0 == 3  # one upload an admission batch
    r1, p1, a1 = sites(REF_SYNCS), sites(HOST_SYNCS), admits()
    want_d = ref.answer_drained(prompts)
    got_d = port.answer_drained(prompts)
    assert got_d == want_d == got
    assert counters(port.stats) == counters(ref.stats)
    assert delta(sites(HOST_SYNCS), p1) == delta(sites(REF_SYNCS), r1)
    assert admits() == a1
    assert len(port.stats.ttv_s) == len(ref.stats.ttv_s) == 14


def test_moe_drops_follow_the_admission_shape():
    """olmoe-tiny at capacity factor 0.5: experts drop rows both at
    admission (capacity from the bucketed B x S, padding routed too) and
    at every decode round (from the live and dead slots' B rows). The
    answers and token ids over continuous, drained and two-wave serving
    equal the reference's."""
    ref, port = engines("olmoe-1b-7b", max_new=3, moe_capacity_factor=0.5)
    prompts = [f"does expert {i} drop this row?" + " word" * (i % 5)
               for i in range(9)]
    assert port.answer(prompts) == ref.answer(prompts)
    assert port.answer_drained(prompts) == ref.answer_drained(prompts)
    assert counters(port.stats) == counters(ref.stats)
    waves = []
    for eng in (ref, port):
        ta = eng.submit(prompts[:3])
        eng.poll()
        tb = eng.submit(prompts[3:])
        eng.drain()
        waves.append(eng.answers(ta) + eng.answers(tb))
    assert waves[0] == waves[1]


def test_shuffled_arrival_and_interleaved_tickets():
    ref, port = engines("stablelm-3b")
    prompts = [f"shuffled arrival prompt {i}" for i in range(13)]
    base = port.answer_drained(prompts)
    assert base == ref.answer_drained(prompts)
    perm = random.Random(7).sample(range(13), 13)
    shuf = port.answer([prompts[i] for i in perm])
    assert [shuf[perm.index(i)] for i in range(13)] == base
    ta = port.submit(prompts[:5])
    tb = port.submit(prompts[5:8])
    port.drain()
    assert port.answers(ta) + port.answers(tb) == base[:8]


def _slot_reuse_scenario(eng):
    """The reference's slot-reuse sequence; returns the scheduler's
    live/free slots after each step, the answers and the slot of the
    recycled request."""
    sched = eng.scheduler
    trace = []
    ta = eng.submit(["first long-running prompt"])
    trace.append(sched.live_slots())
    eng.poll()
    tb = eng.submit([f"second wave prompt {i}" for i in range(3)])
    trace.append(sched.live_slots())
    eng.poll()
    trace.append((eng.done(ta), eng.done(tb), sched.free_slots(),
                  sched.live_slots()))
    tc = eng.submit(["third prompt lands in the recycled slot"])
    trace.append(sched.live_slots())
    reused = sched._slot_req[0].rid == tc.rids[0]
    eng.drain()
    return trace, reused, [eng.answers(t) for t in (ta, tb, tc)]


def test_slot_freed_mid_decode_is_reused():
    """A finished sequence frees its slot while neighbours decode, the
    next submit recycles it, and the port follows the reference slot
    for slot and answer for answer."""
    ref, port = engines("stablelm-3b")
    want = _slot_reuse_scenario(ref)
    got = _slot_reuse_scenario(port)
    assert got == want
    trace, reused, _ = got
    assert trace[0] == [0] and trace[1] == [0, 1, 2, 3]
    assert trace[2] == (True, False, [0], [1, 2, 3])
    assert trace[3] == [0, 1, 2, 3] and reused


def _admission_order(eng, weighted: bool):
    busy = eng.submit([f"busy slot filler {i}" for i in range(4)])
    if weighted:
        light = eng.submit([f"light singleton {i}" for i in range(5)],
                           weights=[1.0] * 5)
        heavy = eng.submit(["heavy many-row representative"],
                           weights=[1000.0])
        rids = light.rids + heavy.rids
        tickets = (busy, light, heavy)
    else:
        rest = eng.submit([f"queued prompt {i}" for i in range(6)])
        rids = rest.rids
        tickets = (busy, rest)
    reqs = [eng.scheduler._reqs[r] for r in rids]
    eng.drain()
    order = sorted(range(len(reqs)), key=lambda i: (reqs[i].t_admit, i))
    for t in tickets:
        eng.answers(t)
    return order, [r.t_admit for r in reqs]


@pytest.mark.parametrize("weighted", (False, True), ids=("fifo", "weighted"))
def test_admission_order_matches_reference(weighted):
    ref, port = engines("qwen2.5-32b")
    order, admits = _admission_order(port, weighted)
    assert order == _admission_order(ref, weighted)[0]
    if weighted:  # the heavy request overtakes the earlier singletons
        assert all(admits[-1] <= a for a in admits[:-1])
        assert any(admits[-1] < a for a in admits[:-1])
    else:  # FIFO, the first freed wave strictly first
        assert admits == sorted(admits)
        assert max(admits[:4]) < min(admits[4:])


def test_one_sync_per_round_and_latency_stats():
    _, port = engines("stablelm-3b")
    port.stats = ServingStats()
    before = HOST_SYNCS.site_total(SERVING_SITES)
    rounds = HOST_SYNCS.by_site.get("serving_round", 0)
    port.answer([f"round sync probe {i}" for i in range(10)])
    assert HOST_SYNCS.by_site["serving_round"] - rounds == \
        port.stats.decode_steps
    assert HOST_SYNCS.site_total(SERVING_SITES) - before == \
        port.stats.decode_steps + port.stats.batches
    assert len(port.stats.ttv_s) == 10 and port.stats.queued_peak >= 6
    snap = port.stats.snapshot()
    assert snap["ttv_p99_s"] >= snap["ttv_p50_s"] > 0


def test_drained_partial_chunk_reports_dead_slots():
    _, port = engines("stablelm-3b")
    port.answer_drained(["the only prompt of this chunk"])
    assert port.stats.prefill_rows == 4
    assert port.stats.live_prefill_rows == 1
    assert port.stats.prefill_occupancy == 0.25


DENSE = ("stablelm-3b", "starcoder2-3b", "qwen2.5-32b")


def worded(n_words: int, tag: str) -> str:
    """A prompt of ``n_words`` words: ``n_words + 2`` tokens with BOS and
    SEP, cut at the engine's max_seq."""
    return " ".join(f"{tag}{i}" for i in range(n_words))


# token lengths 3, 12, 20 and 40 (fills max_seq 40), then 7, 19 and 11:
# admissions of widths 4, 2 and 1 at lengths 40, 32 and 16
MIXED = [worded(w, t) for w, t in ((1, "a"), (10, "b"), (18, "c"),
                                   (60, "d"), (5, "e"), (17, "f"),
                                   (9, "g"))]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_admission_trimmed_to_its_longest_prompt(arch):
    """Prompts of very different lengths, one filling max_seq: a dense
    engine prefills each admission at its longest prompt rounded up to
    16 (capped at max_seq) and still answers as the reference, which
    prefills max_seq, with the reference's counters, continuous and
    drained."""
    ref, port = engines(arch, max_seq=40)
    want = ref.answer(MIXED)
    assert port.answer(MIXED) == want
    assert counters(port.stats) == counters(ref.stats)
    assert port.stats.batches == 3
    assert port.stats.prefill_positions == 4 * 40 + 2 * 32 + 1 * 16
    before = port.stats.prefill_positions
    assert port.answer_drained(MIXED) == ref.answer_drained(MIXED) == want
    assert counters(port.stats) == counters(ref.stats)
    # drained chunks of 4: lengths (3, 12, 20, 40) and (7, 19, 11)
    assert port.stats.prefill_positions - before == 4 * 40 + 4 * 32
    assert port.stats.prefill_fill == port.stats.prefill_tokens / (
        port.stats.prefill_positions)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_length_by_family(arch):
    """The admission's length, read through ``prefill_positions``: a
    dense model prefills its longest prompt rounded up to 16 (max_seq
    where a prompt fills it); MoE, SSM, hybrid and MLA models prefill
    max_seq, whose padding their reference's capacity and state take
    in."""
    _, port = engines(arch, max_seq=40)
    dense = arch in DENSE
    assert port.trim_prefill == dense
    # words + 2 tokens: 3, 16, 17, 32, 33 and 40 (cut at max_seq)
    for words, want in ((1, 16), (14, 16), (15, 32), (30, 32), (31, 40),
                        (60, 40)):
        before = port.stats.prefill_positions
        port.answer([worded(words, "w")])
        assert port.stats.prefill_positions - before == \
            (want if dense else 40), words
    assert port.admit_len == 40  # reset after each admission


@pytest.mark.parametrize("arch", DENSE)
def test_trimmed_admission_writes_the_padded_state(arch):
    """Port against port: after one admission of mixed lengths at 16
    positions, the keys and values at every row's real positions, their
    ``slot_pos`` and the slot state (``cur``, ``pos``, ``live``,
    ``rem``) equal those of the same admission prefilled at max_seq;
    the packed upload handed to ``_prefill_insert`` keeps its
    ``max_seq + 2`` columns."""
    _, trim = engines(arch, max_seq=40)
    _, full = engines(arch, max_seq=40)
    full.trim_prefill = False
    seen = []
    insert = trim._prefill_insert

    def recorded(cache, cur, pos, live, rem, adm):
        seen.append((tuple(adm.shape), trim.admit_len))
        return insert(cache, cur, pos, live, rem, adm)

    trim._prefill_insert = recorded
    prompts = [worded(w, t) for w, t in ((1, "p"), (12, "q"), (6, "r"),
                                         (3, "s"))]
    for eng in (trim, full):
        eng.submit(prompts)
    assert seen == [((4, 42), 16)]
    assert (trim.stats.prefill_positions, full.stats.prefill_positions) \
        == (4 * 16, 4 * 40)
    a, b = trim.scheduler, full.scheduler
    for name in ("_cur", "_pos", "_live", "_rem"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for slot, req in enumerate(a._slot_req):
        n = req.length
        for leaf in ("k", "v"):
            torch.testing.assert_close(a._cache[leaf][:, slot, :n],
                                       b._cache[leaf][:, slot, :n],
                                       atol=1e-6, rtol=1e-6)
        assert torch.equal(a._cache["slot_pos"][:, slot, :n],
                           b._cache["slot_pos"][:, slot, :n])
    trim.drain()
    full.drain()
    assert [r.out_ids for r in a._reqs.values()] == \
        [r.out_ids for r in b._reqs.values()]


def test_mesh_engine_prefills_max_seq():
    """Under a mesh policy the dense engine keeps max_seq: the rows go
    into the shards that hold their slots at the cache's full length."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import shard_params
    from repro_torch.sharding.policy import ShardingPolicy as PortPolicy

    cfg, _, params = weights("starcoder2-3b")
    pol = PortPolicy.for_mesh(make_mesh(1, 2, devices=["cpu"] * 2))
    eng = PortEngine(cfg, shard_params(cfg, params, pol), policy=pol,
                     batch_size=4, max_seq=40, device="cpu",
                     attn_impl="ref")
    assert not eng.trim_prefill and eng.prefill_len([3, 5]) == 40
    _, one = engines("starcoder2-3b", max_seq=40)
    prompts = [worded(w, "m") for w in (1, 4, 9)]
    assert eng.answer(prompts) == one.answer(prompts)
    assert eng.stats.prefill_positions == 2 * 40 + 1 * 40
    assert one.stats.prefill_positions == 2 * 16 + 1 * 16


def test_hybrid_short_prompt_sees_only_its_slot():
    """The reference's ring-plus-padding behaviour, kept on purpose: the
    admission prefills the whole 24-wide padded row, so the 16-slot ring
    holds positions 8..23 (padding); a prompt shorter than 8 tokens
    starts decoding at pos = len - 1 < 8 and sees only the slot it
    writes. The answers still equal the reference's."""
    ref, port = engines("hymba-1.5b")
    prompts = ["short one", "tiny", "a slightly longer prompt here ok"]
    sched = port.scheduler
    ticket = port.submit(prompts)
    sp = sched._cache["slot_pos"]
    assert sp.shape[2] == 16 and port.cache_len == 27
    for s in sched.live_slots():
        pos = int(sched._pos[s])
        assert sorted(sp[0, s].tolist()) == list(range(8, 24))
        if pos < 8:  # nothing in the ring is at or before pos
            assert bool((sp[:, s] > pos).all())
    assert min(int(p) for p in sched._pos[:3]) < 8
    port.drain(ticket)
    assert port.answers(ticket) == ref.answer(prompts)


class TestKernelPathGlue:
    """The K7/K8/K9 call sites of ``attention_block``/
    ``attention_decode``/``ssm_block`` (strided (B,S,H,d) views, the
    (B,T,K,d) cache permuted, ``lengths = pos + 1`` for the dense
    model and the slot mask for the hybrid's ring, the window, x/B/C as
    strided slices of the conv output) with the kernels' plain versions
    in place of the kernels: the same answers as the plain paths
    through slot recycling. For the dense model, slot_pos[t] == t up to
    pos on every live slot after every round (what makes K8's length
    mask equal the reference's slot mask)."""

    @pytest.fixture
    def glue(self, monkeypatch):
        calls = {"flash": 0, "decode_len": 0, "decode_slots": 0, "ssd": 0}

        def fa(q, k, v, *, causal=True, window=0, impl="auto"):
            assert impl == "kernel"
            calls["flash"] += 1
            return fa_ops.flash_attention(q, k, v, causal=causal,
                                          window=window, impl="ref")

        def dec(q, k, v, lengths=None, *, slot_pos=None, pos=None,
                window=0, impl="auto"):
            assert impl == "kernel"
            if lengths is not None:
                assert lengths.dtype == torch.int32 and slot_pos is None
                calls["decode_len"] += 1
            else:
                assert window > 0 and pos is not None
                calls["decode_slots"] += 1
            return dec_ops.decode_attention(q, k, v, lengths,
                                            slot_pos=slot_pos, pos=pos,
                                            window=window, impl="ref")

        def chunk(x, dt, A, B, C, *, chunk):
            # the kernel's operand contract: float32, unit stride on the
            # last axis, dt and A contiguous, s a multiple of chunk
            for a in (x, dt, A, B, C):
                assert a.dtype == torch.float32 and a.stride(-1) == 1
            assert dt.is_contiguous() and A.is_contiguous()
            assert x.shape[1] % chunk == 0
            calls["ssd"] += 1
            return ssd_chunk_ref(x, dt, A, B, C, chunk)

        monkeypatch.setattr(port_layers, "flash_attention", fa)
        monkeypatch.setattr(port_layers, "decode_attention", dec)
        monkeypatch.setattr(ssd_ops, "ssd_chunk_kernel", chunk)
        return calls

    def test_kernel_path_matches_plain_path(self, glue):
        cfg, _, params = weights("starcoder2-3b")
        runs = {}
        for impl in ("kernel", "ref"):
            eng = PortEngine(cfg, params, batch_size=4, max_seq=24,
                             max_new_tokens=3, device="cpu", attn_impl=impl)
            sched = eng.scheduler
            ta = eng.submit([f"glue wave one {i}" for i in range(3)])
            eng.poll()
            tb = eng.submit([f"glue wave two {i}" for i in range(6)])
            checked = 0
            while eng.poll():
                pos = sched._pos.tolist()
                # dead slots decode too, at a frozen pos: still in bounds
                assert max(pos) < eng.cache_len
                sp = sched._cache["slot_pos"]
                for s in sched.live_slots():
                    want = torch.arange(pos[s] + 1, dtype=torch.int32)
                    assert torch.equal(sp[:, s, :pos[s] + 1],
                                       want.expand(cfg.num_layers, -1))
                    checked += 1
            runs[impl] = eng.answers(ta) + eng.answers(tb)
            assert checked > 0 and eng.stats.batches > 2
        assert runs["kernel"] == runs["ref"]

    def test_moe_kernel_path_matches_plain_path(self, glue):
        """olmoe-tiny (multi-head, group 1) through two waves: K7 once
        per layer per admission, K8 with ``lengths`` once per layer per
        round, the same answers as the plain path."""
        cfg, _, params = weights("olmoe-1b-7b")
        runs = {}
        for impl in ("kernel", "ref"):
            for k in glue:
                glue[k] = 0
            eng = PortEngine(cfg, params, batch_size=4, max_seq=24,
                             max_new_tokens=3, device="cpu", attn_impl=impl)
            ta = eng.submit([f"moe glue one {i}" for i in range(3)])
            eng.poll()
            tb = eng.submit([f"moe glue two {i} " + "word " * i
                             for i in range(6)])
            eng.drain()
            runs[impl] = eng.answers(ta) + eng.answers(tb)
            st, L = eng.stats, cfg.num_layers
            want = ({"flash": L * st.batches, "decode_len":
                     L * st.decode_steps, "decode_slots": 0, "ssd": 0}
                    if impl == "kernel" else dict.fromkeys(glue, 0))
            assert glue == want and st.batches > 2
        assert runs["kernel"] == runs["ref"]

    @pytest.mark.parametrize("arch", ("mamba2-370m", "hymba-1.5b"))
    def test_ssm_kernel_paths_match_plain_path(self, glue, arch):
        """Two waves through slot recycling; the hybrid at max_seq 24,
        so its ring wraps; K9 once per layer per admission, K7 (with
        the window) too for the hybrid, and K8 with the slot mask once
        per layer per round."""
        cfg, _, params = weights(arch)
        runs = {}
        for impl in ("kernel", "ref"):
            for k in glue:
                glue[k] = 0
            eng = PortEngine(cfg, params, batch_size=4, max_seq=24,
                             max_new_tokens=3, device="cpu", attn_impl=impl,
                             ssd_impl=impl)
            ta = eng.submit([f"glue wave one {i}" for i in range(3)])
            eng.poll()
            tb = eng.submit([f"glue wave two {i} " + "word " * i
                             for i in range(6)])
            eng.drain()
            runs[impl] = eng.answers(ta) + eng.answers(tb)
            st = eng.stats
            L = cfg.num_layers
            attn = cfg.family == "hybrid"
            want = ({"flash": L * st.batches * attn, "decode_len": 0,
                     "decode_slots": L * st.decode_steps * attn,
                     "ssd": L * st.batches} if impl == "kernel"
                    else dict.fromkeys(glue, 0))
            assert glue == want and st.batches > 2
        assert runs["kernel"] == runs["ref"]

    def test_prefill_and_decode_logits(self, glue):
        from repro_torch.models import decode_step, prefill

        cfg, _, params = weights("qwen2.5-32b")
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (3, 20)), dtype=torch.int32)
        pos = torch.tensor([19, 4, 11], dtype=torch.int32)
        out = {}
        for impl in ("kernel", "ref"):
            lg, cache = prefill(cfg, params, {"tokens": toks}, max_seq=24,
                                attn_impl=impl)
            ld, _ = decode_step(cfg, params, cache, toks[:, 0], pos,
                                attn_impl=impl)
            out[impl] = (lg, ld, cache)
        for a, b in zip(out["kernel"][:2], out["ref"][:2]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        for k in ("k", "v", "slot_pos"):
            torch.testing.assert_close(out["kernel"][2][k],
                                       out["ref"][2][k], atol=1e-5,
                                       rtol=1e-5)

    def test_hybrid_prefill_and_decode_logits(self, glue):
        """Prefill longer than the window (the ring wraps, K7's window
        cuts), then decode steps past the wrap: every cache leaf and
        every logit of the kernel path within 1e-5 of the plain path
        (the stand-ins sum in other orders: the SSD's chunk step against
        ``ssd_chunked``)."""
        from repro_torch.models import decode_step, prefill

        cfg, _, params = weights("hymba-1.5b")
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (3, 37)), dtype=torch.int32)
        out = {}
        for impl in ("kernel", "ref"):
            lg, cache = prefill(cfg, params, {"tokens": toks}, max_seq=40,
                                attn_impl=impl, ssd_impl=impl)
            logits = [lg]
            pos = torch.tensor([36, 20, 30], dtype=torch.int32)
            for step in range(4):
                ld, _ = decode_step(cfg, params, cache, toks[:, step], pos,
                                    attn_impl=impl)
                logits.append(ld)
                pos = pos + 1
            out[impl] = (logits, cache)
        assert glue["flash"] == glue["ssd"] == cfg.num_layers
        assert glue["decode_slots"] == 4 * cfg.num_layers
        for a, b in zip(out["kernel"][0], out["ref"][0]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        for k, v in out["ref"][1].items():
            torch.testing.assert_close(out["kernel"][1][k], v, atol=1e-5,
                                       rtol=1e-5)


def test_kernel_impl_raises_on_cpu():
    cfg, _, params = weights("stablelm-3b")
    eng = PortEngine(cfg, params, batch_size=2, max_seq=8, device="cpu",
                     attn_impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        eng.answer(["no kernel off the card"])


def test_model_backend_parse_matches_reference():
    ref = ModelBackend(lambda ps: [], out_dtype="bool")
    port = PortBackend(lambda ps: [], out_dtype="bool")
    replies = ["YES", "no", "<17> YES", "true story", "1", "", None,
               "  yes  ", "-42 apples", "3.5", "<9> <12>", "abc -7 8"]
    for dtype in ("bool", "int", "float", "str"):
        for r in replies:
            ctx = {"__dtype__": dtype}
            assert port._parse(r, ctx) == ref._parse(r, ctx), (r, dtype)
    assert port._parse("YES", {}) is True


def test_model_backend_over_engine():
    _backend_over_engine("stablelm-3b")


def test_model_backend_over_mla_engine():
    """deepseek-tiny (MLA, shared expert): ``ModelBackend`` answers as
    the reference's over its engine, sync and async."""
    _backend_over_engine("deepseek-v3-671b")


def _backend_over_engine(arch):
    ref, port = engines(arch)
    rb, pb = ModelBackend(ref.answer), PortBackend(port.answer)
    ctx = [{"__dtype__": "bool"}] * 3
    prompts = ["prompt a", "prompt b", "prompt c"]
    assert pb.evaluate_batch(prompts, ctx) == rb.evaluate_batch(prompts, ctx)
    assert pb.calls == rb.calls == 3
    ab = PortBackend.from_engine(port)
    assert ab.supports_async and ab.preferred_batch_rows == 32
    h = ab.submit_batch(prompts, ctx, weights=[1, 5, 2])
    assert ab.collect([h]) == rb.evaluate_batch(prompts, ctx)
    assert not PortBackend.from_engine(port, continuous=False).supports_async


@pytest.mark.parametrize("vocab", (256, 512, 49152))
def test_hash_tokenizer_ids(vocab):
    texts = ["hello world", "Is the category 'winter goods line 7' "
             "seasonal? Answer YES or NO. sep", "", "ünïcödé wörds ok"]
    for t in texts:
        for n in (1, 8, 64):
            np.testing.assert_array_equal(
                PortTokenizer(vocab).encode(t, n),
                HashTokenizer(vocab).encode(t, n))


def test_serve_entry_point_tiny_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "stablelm-3b", "--tiny", "--device", "cpu",
          "--prompts", "hello", "world"])
    out = capsys.readouterr().out
    assert "random-weight stablelm-tiny on cpu" in out
    assert "'hello' -> " in out and "'world' -> " in out
    assert "2 prompts, 1 batches" in out


def test_serve_entry_point_defaults_to_olmoe(capsys):
    """As the reference's ``launch/serve.py``, the default ``--arch`` is
    olmoe-1b-7b (here its tiny config on the CPU)."""
    from repro_torch.launch.serve import main

    main(["--tiny", "--device", "cpu", "--prompts", "hello", "world"])
    out = capsys.readouterr().out
    assert "random-weight olmoe-tiny on cpu" in out
    assert "'world' -> " in out and "2 prompts, 1 batches" in out


@pytest.mark.parametrize("arch", ("mamba2-370m", "hymba-1.5b"))
def test_serve_entry_point_ssm_families_tiny_cpu(capsys, arch):
    from repro_torch.configs import get_tiny
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--tiny", "--device", "cpu", "--max-seq", "24",
          "--prompts", "hello", "world", "again"])
    out = capsys.readouterr().out
    assert f"random-weight {get_tiny(arch).name} on cpu" in out
    assert "'again' -> " in out and "3 prompts, 2 batches" in out


def test_serve_entry_point_mla_tiny_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "deepseek-v3-671b", "--tiny", "--device", "cpu",
          "--max-seq", "24", "--prompts", "hello", "world", "again"])
    out = capsys.readouterr().out
    assert "random-weight deepseek-tiny on cpu" in out
    assert "'again' -> " in out and "3 prompts, 2 batches" in out
