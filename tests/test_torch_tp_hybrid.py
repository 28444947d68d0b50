"""The hybrid (hymba) at tp > 1 without ``dp_over_tp`` over the port's
model mesh: query heads in ceil chunks (``sharding.model.head_range``:
25 over 2 is 13 + 12, over 4 7 + 7 + 7 + 4), each rank's KV heads the
ones its query heads read (``kv_range``; ranks that straddle groups
overlap in a KV head), its attention in ``head_runs`` (one K7 or K8
call a run), the overlapping KV parts cut into pieces by
``Sharded.slices`` (``sum_replicas``, the gradient norm, ``unshard``),
``kv_pieces``/``gather_ranks`` and the hybrid's ring split over the
sequence under ``shard_cache_seq``. Held on meshes of repeated CPU
devices to the reference's jitted Auto-axes mesh runs on forced host
devices (one subprocess for the module,
``tests/torch_tp_hybrid_check.py``) on the reference's weights, at
``tests/test_torch_tp_families.py``'s tolerances: logits 1e-4 of the
reference's max|logit| (prefill and 4 greedy decode steps past the
16-slot ring's wrap), float cache leaves 1e-5 of max(1, max|leaf|),
``slot_pos`` and greedy ids exact; 3 fp32 train steps at
``tests/test_torch_train_tp_families.py``'s (losses 1e-5, parameters
1e-4)."""
import contextlib
import io

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_families_check as fam  # noqa: E402
import torch_tp_hybrid_check as chk  # noqa: E402
from repro.configs import get_tiny as ref_tiny  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.params import shard_params  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import ShardingPolicy  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    global_norm,
    init_state,
)
from repro_torch.training.train_step import build_train_step  # noqa: E402

LOGIT_TOL = 1e-4  # of max|logit|
KV_TOL = 1e-5
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
DEVICES = {"shared": ("cpu",), "two_names": ("cpu", "cpu:0")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the per-position mesh code (as
    ``tests/test_torch_tp_families.py``), restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module: the tests
    that need no reference (listed first) run while it compiles."""
    out = tmp_path_factory.mktemp("tp_hybrid") / "ref.npz"
    proc = chk.start_reference(str(out))
    yield proc, out
    proc.kill()


@pytest.fixture(scope="module")
def ref(reference_run):
    proc, out = reference_run
    fam.finish_reference(proc, str(out))
    return dict(np.load(out))


def policy(dp, tp, names=("cpu",), rep=None):
    devs = [names[i % len(names)] for i in range(dp * tp)]
    return ShardingPolicy.for_mesh(make_mesh(dp, tp, devices=devs)).replace(
        **(rep or {}))


_WEIGHTS: dict = {}


def weights(name):
    """The reference's weights of ``chk.config(name)``, as fresh port
    tensors (training updates them in place)."""
    if name not in _WEIGHTS:
        _WEIGHTS[name] = jax.tree.map(np.asarray, ref_init(
            chk.config(name, ref_tiny), jax.random.PRNGKey(0)))
    return pm.params_from_numpy(_WEIGHTS[name], "cpu")


def case_batch(cfg, rows=fam.PROMPT[0], seq=fam.PROMPT[1], seed=12):
    return {k: torch.as_tensor(v)
            for k, v in fam.cfg_batch(cfg, rows, seq, seed).items()}


def sharded(case, names=("cpu",)):
    name, (dp, tp), rep = chk.SERVE_CASES[case]
    cfg = chk.config(name, get_tiny)
    pol = policy(dp, tp, names, rep)
    return cfg, pol, shard_params(cfg, weights(name), pol)


def run(cfg, params, pol, batch, tokens=None, impl="ref", max_seq=None):
    """Prefill, then DECODE_STEPS decode steps fed ``tokens[s]`` (greedy
    when None): (prefill logits, cache after prefill, each step's
    logits, the fed tokens, final cache), caches unsharded."""
    S = batch["tokens"].shape[1]
    logits, cache = pm.prefill(cfg, params, batch,
                               max_seq=max_seq or fam.max_seq(0),
                               attn_impl=impl, ssd_impl=impl, policy=pol)
    first = sm.unshard(cache) if pol is not None else {
        k: v.clone() for k, v in cache.items()}
    B = batch["tokens"].shape[0]
    pos = torch.full((B,), S, dtype=torch.int32)
    tok = logits.argmax(-1).int()
    steps, fed = [], []
    for s in range(fam.DECODE_STEPS):
        if tokens is not None:
            tok = tokens[s]
        fed.append(tok)
        lg, cache = pm.decode_step(cfg, params, cache, tok, pos,
                                   attn_impl=impl, policy=pol)
        steps.append(lg)
        tok = lg.argmax(-1).int()
        pos = pos + 1
    fed.append(tok)
    last = sm.unshard(cache) if pol is not None else cache
    return logits, first, steps, fed, last


def close(a, b, scale):
    return float((a.float() - b.float()).abs().max()) <= scale


# --- no reference needed: these run while its subprocess compiles ---


def test_kv_range_and_runs():
    """hymba-1.5b's 25 query heads over 5 KV heads (groups of 5) at tp 2
    and 4, and 15 over 5 (groups of 3) at tp 2: each rank's query heads,
    the KV heads it reads and its runs (local numbering), the pieces
    that give every KV head once; whole-group layouts stay one run."""
    assert [sm.head_range(25, 2, t) for t in range(2)] == [(0, 13),
                                                           (13, 25)]
    assert [sm.kv_range(25, 5, 2, t) for t in range(2)] == [(0, 3), (2, 5)]
    assert [sm.head_runs(25, 5, 2, t) for t in range(2)] == [
        [(0, 10, 0, 2), (10, 13, 2, 3)], [(0, 2, 0, 1), (2, 12, 1, 3)]]
    assert sm.kv_pieces(25, 5, 2) == [(0, 0, 3), (1, 1, 3)]
    assert [sm.head_range(25, 4, t) for t in range(4)] == [
        (0, 7), (7, 14), (14, 21), (21, 25)]
    assert [sm.kv_range(25, 5, 4, t) for t in range(4)] == [
        (0, 2), (1, 3), (2, 5), (4, 5)]
    assert [sm.head_runs(25, 5, 4, t) for t in range(4)] == [
        [(0, 5, 0, 1), (5, 7, 1, 2)], [(0, 3, 0, 1), (3, 7, 1, 2)],
        [(0, 1, 0, 1), (1, 6, 1, 2), (6, 7, 2, 3)], [(0, 4, 0, 1)]]
    assert sm.kv_pieces(25, 5, 4) == [(0, 0, 2), (1, 1, 2), (2, 1, 3)]
    assert sm.kv_owners(25, 5, 4) == [0, 1, 2]
    assert [sm.kv_range(15, 5, 2, t) for t in range(2)] == [(0, 3), (2, 5)]
    assert [sm.head_runs(15, 5, 2, t) for t in range(2)] == [
        [(0, 6, 0, 2), (6, 8, 2, 3)], [(0, 1, 0, 1), (1, 7, 1, 3)]]
    assert sm.head_runs(24, 2, 4, 1) == [(0, 6, 0, 1)]
    assert sm.head_runs(16, 16, 2, 0) == [(0, 8, 0, 8)]
    g = sm.mesh_grid(policy(2, 2))
    loc = [sm.local_config(chk.config("h25", get_tiny), g, t)
           for t in range(2)]
    assert [(c.num_heads, c.num_kv_heads) for c in loc] == [(13, 3),
                                                             (12, 3)]


def test_overlapping_kv_parts_cut_into_pieces():
    """``wk`` at (1, 2): parts of KV heads [0, 3) and [2, 5) give three
    disjoint pieces, KV head 2 held by both; ``sum_replicas`` adds the
    two ranks' pieces of it into copies of the parts (both ranks end
    with the same bits), leaves the rest, and ``unshard`` and the
    gradient norm count every head once."""
    cfg = chk.config("h25", get_tiny)
    pol = policy(1, 2, DEVICES["two_names"])
    wk = shard_params(cfg, weights("h25"), pol)["blocks"]["attn"]["wk"]
    pieces = wk.slices()
    assert [(idx[2].start, idx[2].stop, holders)
            for idx, holders in pieces] == [
        (0, 2, [(0, 0)]), (2, 3, [(0, 0), (0, 1)]), (3, 5, [(0, 1)])]
    g = wk.map(lambda p: torch.rand(p.shape, generator=torch.Generator()
                                    .manual_seed(p.shape[2])))
    s = sm.sum_replicas(g)
    a, b = s.parts[0, 0][:, :, 2], s.parts[0, 1][:, :, 0]
    assert torch.equal(a, b)
    assert torch.equal(a, g.parts[0, 0][:, :, 2] + g.parts[0, 1][:, :, 0])
    assert torch.equal(s.parts[0, 0][:, :, :2], g.parts[0, 0][:, :, :2])
    assert torch.equal(s.parts[0, 1][:, :, 1:], g.parts[0, 1][:, :, 1:])
    whole = s.unshard()
    assert whole.shape == wk.shape
    assert torch.allclose(global_norm({"wk": s}), whole.norm(), rtol=1e-6)


@pytest.mark.parametrize("case", ["h25_1x2", "h25_1x4", "h25_2x2",
                                  "h25_1x2_seq"])
def test_prefill_past_the_ring_matches_one_device(case):
    """A 20-position prefill into the 16-slot ring (it wraps in the
    prefill, the reference's cases do not) and 4 decode steps: one
    device's logits and caches (under ``shard_cache_seq`` each rank's
    slots of the ring)."""
    cfg, pol, sp = sharded(case)
    batch = case_batch(cfg, seq=20)
    name = chk.SERVE_CASES[case][0]
    want = run(cfg, weights(name), None, batch, max_seq=24)
    got = run(cfg, sp, pol, batch, tokens=want[3], max_seq=24)
    scale = float(want[0].abs().max())
    assert close(got[0], want[0], LOGIT_TOL * scale)
    for a, b in zip(got[2], want[2]):
        assert close(a, b, LOGIT_TOL * scale)
    for c_got, c_want in ((got[1], want[1]), (got[4], want[4])):
        for k in c_want:
            assert close(c_got[k][:, :4], c_want[k], KV_TOL * max(
                1.0, float(c_want[k].abs().max()))), k


def serve_prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = "is the review positive product winter garden yes no".split()
    return [" ".join(rng.choice(words, int(rng.integers(3, 20))))
            for _ in range(n)]


@pytest.mark.parametrize("case", ["h25_1x2", "h25_1x4", "h25_1x2_seq"])
def test_mesh_engine_answers_as_one_device(case):
    """Continuous, drained and two waves a round apart: the mesh
    engine's token ids equal the single-device engine's (max_seq 24
    keeps the 16-slot ring wrapping)."""
    cfg, pol, sp = sharded(case)
    kw = dict(batch_size=4, max_seq=24, max_new_tokens=3, device="cpu",
              attn_impl="ref", ssd_impl="ref")
    prompts = serve_prompts(13)
    one = ServingEngine(cfg, weights(chk.SERVE_CASES[case][0]), **kw)
    eng = ServingEngine(cfg, sp, policy=pol, **kw)
    assert eng.answer(prompts) == one.answer(prompts)
    assert eng.answer_drained(prompts) == one.answer_drained(prompts)
    for e in (one, eng):
        head = e.submit(prompts[:3])
        e.poll()
        tail = e.submit(prompts[3:])
        e.drain()
        e.out = e.answers(head) + e.answers(tail)
    assert eng.out == one.out


@pytest.fixture
def glue(monkeypatch):
    """K7, K8 and K9's plain versions in the kernels' places at their
    call sites, counting the calls (``test_torch_tp_families.py``'s
    fixture): ``attn_impl="kernel"`` then runs the kernel path's layout,
    its runs included, on the CPU."""
    calls = {"flash": 0, "decode": 0, "ssd": 0}
    fa, dec = fa_ops.flash_attention, dec_ops.decode_attention

    def flash(q, k, v, *, causal=True, window=0, impl="auto", out=None):
        assert impl == "kernel"
        calls["flash"] += 1
        return fa(q, k, v, causal=causal, window=window, impl="ref",
                  out=out)

    def decode(q, k, v, lengths=None, *, slot_pos=None, pos=None, window=0,
               impl="auto", return_lse=False):
        assert impl == "kernel"
        calls["decode"] += 1
        return dec(q, k, v, lengths, slot_pos=slot_pos, pos=pos,
                   window=window, impl="ref", return_lse=return_lse)

    def chunk(x, dt, A, B, C, *, chunk):
        calls["ssd"] += 1
        return ssd_chunk_ref(x, dt, A, B, C, chunk)

    monkeypatch.setattr(fa_ops, "flash_attention", flash)
    monkeypatch.setattr(port_layers, "flash_attention", flash)
    monkeypatch.setattr(port_layers, "decode_attention", decode)
    monkeypatch.setattr(ssd_ops, "ssd_chunk_kernel", chunk)
    return calls


# case -> K7 (and K8) calls a layer over the positions: each rank's runs
# (25 over 2: 2 + 2; over 4: 2 + 2 + 3 + 1; the padded 26 over 2 and the
# stock 5 over 5: one a rank); under shard_cache_seq K8 runs once a rank
# with every head (its log-sum-exp route over the rank's ring slots)
GLUE_CASES = {"h25_1x2": (4, 4), "h25_1x4": (8, 8), "h25_2x2": (8, 8),
              "h25_1x2_seq": (4, 2), "h25pad_1x2": (2, 2),
              "stock_1x2": (2, 2)}


@pytest.mark.parametrize("case", sorted(GLUE_CASES))
def test_kernel_path_runs_over_the_mesh(glue, case):
    """The kernel path with the kernels' plain versions in their places:
    the plain path's logits, greedy ids and caches, K7 and K8 called
    once a run at every position and layer, K9 once a data rank (its
    replicas over the tensor ranks share one call on one device)."""
    cfg, pol, sp = sharded(case)
    batch = case_batch(cfg)
    plain = run(cfg, sp, pol, batch)
    kern = run(cfg, sp, pol, batch, impl="kernel")
    scale = float(plain[0].abs().max())
    assert close(kern[0], plain[0], LOGIT_TOL * scale)
    for a, b in zip(kern[3], plain[3]):
        assert torch.equal(a, b)
    for a, b in zip(kern[2], plain[2]):
        assert close(a, b, LOGIT_TOL * scale)
    for k in plain[4]:
        assert close(kern[4][k], plain[4][k], KV_TOL), k
    f7, f8 = GLUE_CASES[case]
    L, S = cfg.num_layers, fam.DECODE_STEPS
    dp = sm.mesh_grid(pol).dp
    assert glue == {"flash": f7 * L, "decode": f8 * L * S,
                    "ssd": dp * L}, glue


def _serve(argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_launch.main(argv)
    return [ln for ln in buf.getvalue().splitlines() if "->" in ln]


@pytest.mark.parametrize("tp", [2, 4])
def test_launch_serve_tp(tp):
    """``launch/serve --arch hymba-1.5b --tiny --device cpu --tp`` answers
    as ``--tp 1``."""
    prompts = ["is product 3 electronics?", "hello world", "a b c"]
    base = ["--arch", "hymba-1.5b", "--tiny", "--device", "cpu", "--batch",
            "2", "--prompts", *prompts]
    mesh = _serve(["--tp", str(tp), *base])
    assert len(mesh) == 3 and mesh == _serve(base)


# --- held to the reference's run: last, so that the tests above run
# while its subprocess compiles ---


def hold_cache(got, ref, prefix, B):
    assert set(got) == {k.split("/")[-1] for k in ref
                        if k.startswith(prefix)}
    for name, leaf in got.items():
        want = ref[f"{prefix}{name}"]
        have = leaf[:, :B].numpy()
        assert have.shape == want.shape, (name, have.shape, want.shape)
        if name == "slot_pos":
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(have, want, atol=KV_TOL * scale,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("names", sorted(DEVICES))
@pytest.mark.parametrize("case", sorted(chk.SERVE_CASES))
def test_prefill_and_decode_match_the_reference_mesh(ref, case, names):
    """Prefill logits and every cache leaf, then 4 decode steps past the
    ring's wrap fed the reference's greedy tokens: each step's logits,
    the port's own greedy ids equal to the reference's, the final
    cache."""
    cfg, pol, sp = sharded(case, DEVICES[names])
    batch = case_batch(cfg)
    fed = [torch.as_tensor(ref[f"{case}/tokens/{s}"])
           for s in range(fam.DECODE_STEPS)]
    logits, first, steps, _, last = run(cfg, sp, pol, batch, fed)
    want = ref[f"{case}/prefill"]
    scale = np.abs(want).max()
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_TOL * scale,
                               rtol=0)
    B = fam.PROMPT[0]
    hold_cache(first, ref, f"{case}/cache/", B)
    assert torch.equal(logits.argmax(-1).int(), fed[0])
    for s, lg in enumerate(steps):
        np.testing.assert_allclose(lg.numpy(), ref[f"{case}/decode/{s}"],
                                   atol=LOGIT_TOL * scale, rtol=0)
        np.testing.assert_array_equal(
            lg.argmax(-1).int().numpy(), ref[f"{case}/tokens/{s + 1}"])
    hold_cache(last, ref, f"{case}/final_cache/", B)


@pytest.mark.parametrize("names", sorted(DEVICES))
@pytest.mark.parametrize("case", sorted(chk.TRAIN_CASES))
def test_train_steps_match_the_reference_mesh(ref, case, names):
    """3 fp32 steps of ``build_train_step(policy=)`` at (1, 2): the
    losses within 1e-5 and every parameter within 1e-4 of the
    reference's mesh run (the KV head both ranks hold summed by
    ``sum_replicas``, equal at both after every step)."""
    name, (dp, tp), rep, rows = chk.TRAIN_CASES[case]
    cfg = chk.config(name, get_tiny)
    pol = policy(dp, tp, DEVICES[names], rep)
    params = shard_params(cfg, weights(name), pol)
    opt = AdamWConfig(lr=fam.LR)
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, num_microbatches=1, remat=None,
                            policy=pol)
    batch = case_batch(cfg, rows, fam.SEQ, seed=1)
    for s in range(chk.TRAIN_STEPS):
        params, state, m = step(params, state, batch)
        assert abs(float(m["loss"]) - float(
            ref[f"train/{case}/loss/{s}"])) <= LOSS_TOL
    wk = params["blocks"]["attn"]["wk"]
    assert torch.equal(wk.parts[0, 0][:, :, 2], wk.parts[0, 1][:, :, 0])
    for k, v in fam.flat(sm.unshard(params)).items():
        np.testing.assert_allclose(v.numpy(), ref[f"train/{case}/param/{k}"],
                                   atol=PARAM_TOL, rtol=0, err_msg=k)
