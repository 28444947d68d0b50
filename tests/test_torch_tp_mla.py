"""MLA and the ``shard_cache_seq`` knob over the port's model mesh (the
mesh branches of ``models.layers``' ``mla_block``, ``mla_decode`` and
``attention_decode``, ``sharding.model``'s ``seq_slice``,
``gather_ranks`` and ``combine_partials``, ``init_cache(policy=)``
over the sequence, the mesh ``ServingEngine`` for deepseek and
starcoder2) on meshes of repeated CPU devices, held to the reference's
jitted mesh runs on forced host devices (one subprocess for the module,
``tests/torch_tp_mla_check.py serve``) on the reference's weights.

Tolerances as ``tests/test_torch_tp_families.py``'s: logits 1e-4 of
the reference's max|logit| (prefill and every decode step), float
cache leaves 1e-5 of max(1, max|leaf|), ``slot_pos`` and greedy token
ids exact. The reference's ``device_put`` refuses a dimension its mesh
axis does not divide, so its cases keep cache lengths that divide tp;
the uneven slices (the engines' 131 slots over 2 and 4 ranks, and 28
over 4 here) are held to the port's own one-device run, at the same
tolerances."""
import contextlib
import io

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_families_check as fam  # noqa: E402
import torch_tp_mla_check as chk  # noqa: E402
from repro.configs import get_tiny as ref_tiny  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.params import shard_params  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import ShardingPolicy  # noqa: E402

LOGIT_TOL = 1e-4  # of max|logit|
KV_TOL = 1e-5
# device names of a mesh's positions: one name repeated (every part
# shared where it can be) or two names of the CPU (parts copied)
DEVICES = {"shared": ("cpu",), "two_names": ("cpu", "cpu:0")}
SEQ = {"shard_cache_seq": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The mesh code runs many small ops per position: on a host whose
    cores other test workers share, one intra-op thread keeps them from
    spinning against each other (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module: the tests
    that need no reference (listed first) run while it compiles."""
    out = tmp_path_factory.mktemp("tp_mla") / "ref.npz"
    proc = chk.start_reference("serve", str(out))
    yield proc, out
    proc.kill()


@pytest.fixture(scope="module")
def ref(reference_run):
    proc, out = reference_run
    chk.finish_reference(proc, str(out))
    return dict(np.load(out))


def policy(dp, tp, names=("cpu",), kw=None, rep=None):
    devs = [names[i % len(names)] for i in range(dp * tp)]
    return ShardingPolicy.for_mesh(make_mesh(dp, tp, devices=devs),
                                   **(kw or {})).replace(**(rep or {}))


_WEIGHTS: dict = {}


def weights(arch):
    """The reference's tiny weights of ``arch``, as port tensors."""
    if arch not in _WEIGHTS:
        p = ref_init(ref_tiny(arch), jax.random.PRNGKey(0))
        _WEIGHTS[arch] = pm.params_from_numpy(jax.tree.map(np.asarray, p),
                                              "cpu")
    return _WEIGHTS[arch]


def case_batch(cfg, rows=fam.PROMPT[0], seq=fam.PROMPT[1]):
    return {k: torch.as_tensor(v)
            for k, v in fam.cfg_batch(cfg, rows, seq).items()}


def run(cfg, params, pol, batch, tokens=None, impl="ref", max_seq=None):
    """Prefill (cache length ``max_seq``, default the reference cases'),
    then DECODE_STEPS decode steps fed ``tokens[s]`` (greedy when None):
    (prefill logits, cache after prefill (unsharded), each step's
    logits, the fed tokens, final cache (unsharded))."""
    P = cfg.num_image_tokens
    S = batch["tokens"].shape[1]
    logits, cache = pm.prefill(cfg, params, batch,
                               max_seq=max_seq or fam.max_seq(P),
                               attn_impl=impl, ssd_impl=impl, policy=pol)
    first = sm.unshard(cache) if pol is not None else {
        k: v.clone() for k, v in cache.items()}
    B = batch["tokens"].shape[0]
    pos = torch.full((B,), P + S, dtype=torch.int32)
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


def sharded(case, names=("cpu",)):
    arch, (dp, tp), kw, rep = chk.SERVE_CASES[case]
    cfg = get_tiny(arch)
    pol = policy(dp, tp, names, kw, rep)
    return cfg, pol, shard_params(cfg, weights(arch), pol)


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


def hold_runs(a, b):
    """Two ``run`` results agree: logits within LOGIT_TOL of max|logit|,
    greedy ids exact, every cache leaf within KV_TOL."""
    scale = float(b[0].abs().max())
    assert float((a[0] - b[0]).abs().max()) <= LOGIT_TOL * scale
    for x, y in zip(a[2], b[2]):
        assert float((x - y).abs().max()) <= LOGIT_TOL * scale
    for x, y in zip(a[3], b[3]):
        assert torch.equal(x, y)
    for c1, c2 in ((a[1], b[1]), (a[4], b[4])):
        assert set(c1) == set(c2)
        for k in c1:
            assert float((c1[k].float() - c2[k].float()).abs().max()) \
                <= KV_TOL, k


# --- no reference needed: these run while its subprocess compiles ---


@pytest.mark.parametrize("names", sorted(DEVICES))
def test_seq_cache_layout(names):
    """Under ``shard_cache_seq`` at (1, 4) rank t holds positions
    [t·c, (t+1)·c) of every KV head, c = ceil(T / 4) (131 slots: 33,
    33, 33, 32); without it the KV heads follow ``kv_range``. MLA's
    latent cache is one tensor a device without the knob (a copy a
    device name), each rank's slice with it."""
    T = 131
    for arch in ("starcoder2-3b", "deepseek-v3-671b"):
        cfg = get_tiny(arch)
        for rep in ({}, SEQ):
            pol = policy(1, 4, DEVICES[names], rep=rep)
            g = sm.mesh_grid(pol)
            cache = pm.init_cache(cfg, 4, T, policy=pol)
            for name, leaf in cache.items():
                for t in range(4):
                    part = leaf.parts[0, t]
                    if rep and name in ("k", "v", "slot_pos", "ckv",
                                        "krope"):
                        lo, n = sm.seq_slice(T, 4, t)
                        assert (lo, n) == (33 * t, 33 if t < 3 else 32)
                        assert part.shape[2] == n
                        assert leaf.index[0, t][2] == slice(lo, lo + n)
                        if name in ("k", "v"):
                            assert part.shape[3] == cfg.num_kv_heads
                    elif name in ("k", "v"):
                        lo, hi = sm.kv_range(cfg.num_heads,
                                             cfg.num_kv_heads, 4, t)
                        assert part.shape[2:4] == (T, hi - lo)
                    else:
                        assert part.shape[2] == T
            if cfg.use_mla and not rep:
                ids = {id(p) for p in cache["ckv"].parts.flat}
                assert len(ids) == len({str(d) for d in g.devices.flat})


def test_seq_slice_and_kv_owners():
    assert [sm.seq_slice(131, 2, t) for t in range(2)] == [(0, 66),
                                                           (66, 65)]
    assert [sm.seq_slice(5, 4, t) for t in range(4)] == [(0, 2), (2, 2),
                                                         (4, 1), (5, 0)]
    # starcoder2's 24 query heads over 2 KV heads at tp = 4: ranks 0 and
    # 2 start a KV range; qwen's 8 over 2 at tp = 2: both
    assert sm.kv_owners(24, 2, 4) == [0, 2]
    assert sm.kv_owners(8, 2, 2) == [0, 1]
    assert sm.kv_owners(4, 4, 4) == [0, 1, 2, 3]


@pytest.mark.parametrize("arch,mesh,T,S", [
    ("deepseek-v3-671b", (1, 2), 131, 16),
    ("deepseek-v3-671b", (1, 4), 131, 16),
    ("starcoder2-3b", (1, 4), 131, 16), ("starcoder2-3b", (2, 2), 131, 16),
    ("starcoder2-3b", (1, 4), 21, 16), ("paligemma-3b", (1, 2), 29, 16),
    ("starcoder2-3b", (1, 4), 9, 4), ("deepseek-v3-671b", (1, 4), 9, 4)])
def test_uneven_slices_match_one_device(arch, mesh, T, S):
    """Cache lengths that do not divide tp (the engines' 131; 21 over 4,
    where the decode steps move slot ``pos`` from the third rank's slice
    into the fourth's; 9 over 4, whose last slice is empty) for a
    prompt of S tokens: prefill, four decode steps and the caches,
    against the port's one-device run."""
    cfg = get_tiny(arch)
    batch = case_batch(cfg, seq=S)
    pol = policy(*mesh, rep=SEQ)
    sp = shard_params(cfg, weights(arch), pol)
    hold_runs(run(cfg, sp, pol, batch, max_seq=T),
              run(cfg, weights(arch), None, batch, max_seq=T))


@pytest.fixture
def lse_glue(monkeypatch):
    """K7's and K8's plain versions in the kernels' places at their call
    sites, counting K8's calls by route (as ``test_torch_serving.py``'s
    ``TestKernelPathGlue``): ``attn_impl="kernel"`` then runs the
    kernel path's layout on the CPU."""
    calls = {"lse": 0, "plain": 0}
    fa, dec = fa_ops.flash_attention, dec_ops.decode_attention

    def flash(q, k, v, *, causal=True, window=0, impl="auto", out=None):
        assert impl == "kernel"
        return fa(q, k, v, causal=causal, window=window, impl="ref",
                  out=out)

    def decode(q, k, v, lengths=None, *, slot_pos=None, pos=None, window=0,
               impl="auto", return_lse=False):
        assert impl == "kernel"
        calls["lse" if return_lse else "plain"] += 1
        return dec(q, k, v, lengths, slot_pos=slot_pos, pos=pos,
                   window=window, impl="ref", return_lse=return_lse)

    monkeypatch.setattr(fa_ops, "flash_attention", flash)
    monkeypatch.setattr(port_layers, "flash_attention", flash)
    monkeypatch.setattr(port_layers, "decode_attention", decode)
    return calls


@pytest.mark.parametrize("arch,mesh,T", [("starcoder2-3b", (1, 4), 131),
                                         ("whisper-small", (1, 2), 20),
                                         ("starcoder2-3b", (2, 2), 20)])
def test_kernel_path_layout_over_seq_slices(lse_glue, arch, mesh, T):
    """The kernel path over caches split over the sequence, K8's plain
    version in its place: the plain path's logits, ids and caches, and
    K8's log-sum-exp route once a position and layer a step (whisper's
    cross decode keeps its lengths route)."""
    cfg = get_tiny(arch)
    batch = case_batch(cfg)
    pol = policy(*mesh, rep=SEQ)
    sp = shard_params(cfg, weights(arch), pol)
    plain = run(cfg, sp, pol, batch, max_seq=T)
    kern = run(cfg, sp, pol, batch, impl="kernel", max_seq=T)
    hold_runs(kern, plain)
    n = mesh[0] * mesh[1]
    steps = cfg.num_layers * fam.DECODE_STEPS * n
    want = {"lse": steps, "plain": steps if cfg.family == "encdec" else 0}
    assert lse_glue == want


def serve_prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = "is the review positive product winter garden yes no".split()
    return [" ".join(rng.choice(words, int(rng.integers(3, 20))))
            for _ in range(n)]


@pytest.mark.parametrize("arch,mesh", [("deepseek-v3-671b", (1, 2)),
                                       ("deepseek-v3-671b", (2, 2)),
                                       ("starcoder2-3b", (1, 4)),
                                       ("starcoder2-3b", (2, 2))])
def test_mesh_engine_answers_as_one_device(arch, mesh):
    """Continuous (admission widths 4, 2 and 1), drained and two waves a
    round apart under ``shard_cache_seq``: the mesh engine's token ids
    equal the single-device engine's. The engine's 28 slots split into
    14 a rank at tp = 2 and 7 at tp = 4, so slots cross from one rank's
    slice into the next while they decode (checked on the prompts'
    lengths), and admissions refill slots mid-decode."""
    cfg = get_tiny(arch)
    kw = dict(batch_size=4, max_seq=24, max_new_tokens=3, device="cpu",
              attn_impl="ref")
    prompts = serve_prompts(23)
    p = weights(arch)
    one = ServingEngine(cfg, p, **kw)
    pol = policy(*mesh, rep=SEQ)
    eng = ServingEngine(cfg, shard_params(cfg, p, pol), policy=pol, **kw)
    leaf = eng.scheduler._cache["ckv" if cfg.use_mla else "k"]
    c = -(-eng.cache_len // mesh[1])
    assert leaf.parts[0, 0].shape[2] == c
    lens = [eng.encode_row(q)[1] for q in prompts]
    assert any((n - 1) // c != (n - 1 + kw["max_new_tokens"]) // c
               for n in lens)
    assert eng.answer(prompts) == one.answer(prompts)
    assert eng.answer_drained(prompts) == one.answer_drained(prompts)
    for e in (one, eng):
        head = e.submit(prompts[:3])
        e.poll()
        tail = e.submit(prompts[3:])
        e.drain()
        e.out = e.answers(head) + e.answers(tail)
    assert eng.out == one.out


def test_mla_latent_is_shared_on_a_card(monkeypatch):
    """deepseek at (1, 2) on one device name: the query's
    down-projection and the latent run once a layer for both
    tensor-parallel ranks (one dict of their leaves), and a decode
    step writes the one latent cache part once."""
    cfg = get_tiny("deepseek-v3-671b")
    pol = policy(1, 2)
    sp = shard_params(cfg, weights("deepseek-v3-671b"), pol)
    seen = []
    shared = port_layers._mla_shared

    def count(*a, **k):
        seen.append(1)
        return shared(*a, **k)

    monkeypatch.setattr(port_layers, "_mla_shared", count)
    batch = case_batch(cfg)
    _, cache = pm.prefill(cfg, sp, batch, max_seq=20, attn_impl="ref",
                          policy=pol)
    assert len(seen) == cfg.num_layers
    assert cache["ckv"].parts[0, 0] is cache["ckv"].parts[0, 1]
    pm.decode_step(cfg, sp, cache, batch["tokens"][:, -1],
                   torch.full((4,), 16, dtype=torch.int32),
                   attn_impl="ref", policy=pol)
    assert len(seen) == 2 * cfg.num_layers


def test_shard_params_consume_frees_each_leaf():
    """``shard_params(consume=True)`` takes every leaf out of the tree
    it splits (its dicts left empty) and lays it out as without it."""
    cfg = get_tiny("deepseek-v3-671b")
    pol = policy(2, 2)
    p = pm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = sm.unshard(shard_params(cfg, p, pol))
    copy = {k: v for k, v in p.items()}
    got = shard_params(cfg, copy, pol, consume=True)
    assert copy == {}
    flat = fam.flat(sm.unshard(got))
    for k, v in fam.flat(want).items():
        assert torch.equal(flat[k], v), k


def test_launch_serve_mla_dp_tp():
    """``launch/serve --arch deepseek-v3-671b --tiny --device cpu --dp 2
    --tp 2`` answers as one device does."""
    prompts = ["is product 3 electronics?", "hello world", "a b c"]
    base = ["--arch", "deepseek-v3-671b", "--tiny", "--device", "cpu",
            "--batch", "2", "--prompts", *prompts]

    def serve(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_launch.main(argv)
        return [ln for ln in buf.getvalue().splitlines() if "->" in ln]

    mesh = serve(["--dp", "2", "--tp", "2", *base])
    assert len(mesh) == 3 and mesh == serve(base)


# --- held to the reference's run: last, so that the tests above run
# while its subprocess compiles ---


@pytest.mark.parametrize("case", sorted(chk.SERVE_CASES))
def test_prefill_and_decode_match_the_reference_mesh(ref, case):
    """Prefill logits and every cache leaf, then DECODE_STEPS decode
    steps fed the reference's greedy tokens: each step's logits, the
    port's own greedy ids equal to the reference's, and the final
    cache."""
    cfg, pol, sp = sharded(case)
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
    for s, lg in enumerate(steps):
        np.testing.assert_allclose(lg.numpy(), ref[f"{case}/decode/{s}"],
                                   atol=LOGIT_TOL * scale, rtol=0)
        if s + 1 < fam.DECODE_STEPS:
            np.testing.assert_array_equal(
                lg.argmax(-1).int().numpy(), ref[f"{case}/tokens/{s + 1}"])
    hold_cache(last, ref, f"{case}/final_cache/", B)


@pytest.mark.parametrize("case", ["deepseek_2x2_seq", "starcoder2_1x4_seq"])
def test_two_device_names_match_the_reference_mesh(ref, case):
    """The same on two device names, where every part is a copy and
    each collective moves its values: the reference's logits."""
    cfg, pol, sp = sharded(case, DEVICES["two_names"])
    fed = [torch.as_tensor(ref[f"{case}/tokens/{s}"])
           for s in range(fam.DECODE_STEPS)]
    logits, _, steps, _, last = run(cfg, sp, pol, case_batch(cfg), fed)
    scale = np.abs(ref[f"{case}/prefill"]).max()
    np.testing.assert_allclose(logits.numpy(), ref[f"{case}/prefill"],
                               atol=LOGIT_TOL * scale, rtol=0)
    for s, lg in enumerate(steps):
        np.testing.assert_allclose(lg.numpy(), ref[f"{case}/decode/{s}"],
                                   atol=LOGIT_TOL * scale, rtol=0)
    hold_cache(last, ref, f"{case}/final_cache/", fam.PROMPT[0])
