"""The SSM, hybrid, encoder-decoder and VLM families and the
``dp_over_tp`` and ``seq_parallel`` knobs over the port's model mesh
(the mesh branches of ``models.lm``: ``_block_mesh``, ``_encode_mesh``,
``_prepare_mesh``, ``init_cache(policy=)``; ``attention_block`` /
``attention_decode`` in every mode; ``_moe_dp_over_tp``; the mesh
``ServingEngine`` for mamba2 and hymba; ``launch/serve --dp``) on
meshes of repeated CPU devices, held to the reference's jitted mesh
runs on forced host devices (one subprocess for the module,
``tests/torch_tp_families_check.py serve``) on the reference's weights.

Tolerances as ``tests/test_torch_tp.py``'s: logits 1e-4 of the
reference's max|logit| (prefill and every decode step), float cache
leaves 1e-5 of max(1, max|leaf|) (the keys and values lie within 1;
the SSM state reaches a few units, where the reference's and the
port's float32 SSD sums part by 1.3e-5 on hymba, 4.6e-6 relative),
``slot_pos`` and greedy token ids exact. ``seq_parallel``
changes no reference function (no reference model code constrains an
activation to 'seq'), so the port's answers under it are bit for bit
those without it."""
import contextlib
import io

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_families_check as chk  # noqa: E402
from repro.configs import get_tiny as ref_tiny  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.lm import _layers  # noqa: E402
from repro_torch.models.params import shard_params  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import ShardingPolicy  # noqa: E402

LOGIT_TOL = 1e-4  # of max|logit|
KV_TOL = 1e-5
# device names of a mesh's positions: one name repeated (every part
# shared where it can be) or two names of the CPU (parts copied)
DEVICES = {"shared": ("cpu",), "two_names": ("cpu", "cpu:0")}


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
    out = tmp_path_factory.mktemp("tp_families") / "ref.npz"
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


def case_batch(cfg):
    return {k: torch.as_tensor(v)
            for k, v in chk.cfg_batch(cfg, *chk.PROMPT).items()}


def run(cfg, params, pol, batch, tokens=None, impl="ref"):
    """Prefill, then DECODE_STEPS decode steps fed ``tokens[s]`` (greedy
    from the prefill when None): (prefill logits, cache after prefill
    (unsharded), each step's logits, the fed tokens, final cache)."""
    P = cfg.num_image_tokens
    logits, cache = pm.prefill(cfg, params, batch,
                               max_seq=chk.max_seq(P), attn_impl=impl,
                               ssd_impl=impl, policy=pol)
    first = sm.unshard(cache) if pol is not None else {
        k: v.clone() for k, v in cache.items()}
    B = batch["tokens"].shape[0]
    pos = torch.full((B,), P + chk.PROMPT[1], dtype=torch.int32)
    tok = logits.argmax(-1).int()
    steps, fed = [], []
    for s in range(chk.DECODE_STEPS):
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


# --- no reference needed: these run while its subprocess compiles ---


@pytest.mark.parametrize("case", ["mamba2_2x2", "hymba_2x2_dp_over_tp",
                                  "whisper_1x2", "paligemma_2x2"])
def test_forward_matches_one_device(case):
    """``forward`` over the mesh against the port's own one-device
    forward (every layout of these families gives one device's
    function)."""
    cfg, pol, sp = sharded(case)
    batch = case_batch(cfg)
    want, hw = pm.forward(cfg, weights(cfg_arch(case)), batch,
                          attn_impl="ref")
    got, h = pm.forward(cfg, sp, batch, attn_impl="ref", policy=pol)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= LOGIT_TOL * scale
    assert float((h - hw).abs().max()) <= 1e-4


def cfg_arch(case):
    return chk.SERVE_CASES[case][0]


@pytest.mark.parametrize("names", sorted(DEVICES))
def test_seq_parallel_changes_no_bit(names):
    """stablelm at (1, 2) with and without ``seq_parallel``: the same
    logits and caches bit for bit."""
    cfg, pol, sp = sharded("stablelm_1x2_seq_parallel", DEVICES[names])
    assert pol.seq_parallel
    plain = pol.replace(seq_parallel=False)
    batch = case_batch(cfg)
    a = run(cfg, sp, pol, batch)
    b = run(cfg, shard_params(cfg, weights("stablelm-3b"), plain), plain,
            batch)
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)
    for c1, c2 in ((a[1], b[1]), (a[4], b[4])):
        assert all(torch.equal(c1[k], c2[k]) for k in c1)


def test_dp_over_tp_replicates_every_parameter():
    """Under ``dp_over_tp`` the grid is dp·tp data ranks by one: every
    leaf whole at every position (one tensor on a shared device), the
    batch's rows over the four ranks."""
    cfg, pol, sp = sharded("hymba_2x2_dp_over_tp")
    g = sm.mesh_grid(pol)
    assert (g.dp, g.tp) == (4, 1)
    for leaf in _flat(sp):
        assert leaf.parts.shape == (4, 1)
        assert len({id(p) for p in leaf.parts.flat}) == 1
        assert tuple(leaf.parts[0, 0].shape) == leaf.shape
    rows = sm.scatter_rows(torch.arange(8), g)
    assert [rows.grid[i, 0].tolist() for i in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("names,calls", [(("cpu",), 2),
                                         (("cpu", "cpu:0"), 4)])
def test_ssm_runs_once_a_device_over_the_tensor_ranks(monkeypatch, names,
                                                      calls):
    """mamba2 at (2, 2) on one device name: the SSM's weights are the
    same tensors at (i, 0) and (i, 1), so each layer's ``ssm_block``
    runs once a data rank; on two names each position runs its own."""
    from repro_torch.models import lm

    cfg, pol, sp = sharded("mamba2_2x2", names)
    seen = []

    def count(*a, **k):
        seen.append(1)
        return port_layers.ssm_block(*a, **k)

    monkeypatch.setattr(lm, "ssm_block", count)
    pm.prefill(cfg, sp, case_batch(cfg), attn_impl="ref", policy=pol)
    assert len(seen) == calls * cfg.num_layers


def test_moe_dp_over_tp_raises_where_shard_map_raises():
    """Under ``dp_over_tp`` the tokens split over the data axes alone:
    3 x 5 tokens do not split over 2."""
    cfg = get_tiny("olmoe-1b-7b")
    pol = policy(2, 2, rep={"dp_over_tp": True})
    p0 = _layers(shard_params(cfg, weights("olmoe-1b-7b"), pol)["blocks"],
                 cfg.num_layers)[0]["moe"]
    x = torch.zeros(3, 5, cfg.d_model)
    with pytest.raises(ValueError, match="do not split"):
        pm.moe_block(cfg, p0, sm.scatter_rows(x, sm.mesh_grid(pol)), pol)


def test_still_refused():
    """``ep_over_dp`` with ``dp_over_tp`` (MLA and ``shard_cache_seq``
    run: ``test_torch_tp_mla.py``; the hybrid at tp > 1 without
    ``dp_over_tp``: ``test_torch_tp_hybrid.py``)."""
    toks = {"tokens": torch.ones(2, 4, dtype=torch.int64)}
    for arch, pol, match in (
            ("olmoe-1b-7b", policy(2, 2, rep={"dp_over_tp": True,
                                              "ep_over_dp": True}),
             "ep_over_dp"),
            ("hymba-1.5b", policy(2, 2, rep={"dp_over_tp": True,
                                             "ep_over_dp": True}),
             "ep_over_dp")):
        with pytest.raises(sm.MeshNotPorted, match=match):
            pm.prefill(get_tiny(arch), {}, toks, attn_impl="ref",
                       policy=pol)


def serve_prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = "is the review positive product winter garden yes no".split()
    return [" ".join(rng.choice(words, int(rng.integers(3, 20))))
            for _ in range(n)]


@pytest.mark.parametrize("case", ["mamba2_2x2", "hymba_2x1",
                                  "hymba_2x2_dp_over_tp"])
def test_mesh_engine_answers_as_one_device(case):
    """Continuous (admission widths 4, 2 and 1 pad over the data
    ranks), drained and two waves a round apart: the mesh engine's
    token ids equal the single-device engine's; the SSM state and conv
    tail and the hybrid's ring go into the shards that hold the slots.
    max_seq 24 keeps the hybrid's 16-slot ring wrapping."""
    cfg, pol, sp = sharded(case)
    p = weights(cfg_arch(case))
    kw = dict(batch_size=4, max_seq=24, max_new_tokens=3, device="cpu",
              attn_impl="ref", ssd_impl="ref")
    prompts = serve_prompts(23)
    one = ServingEngine(cfg, p, **kw)
    eng = ServingEngine(cfg, sp, policy=pol, **kw)
    assert isinstance(eng.scheduler._cache["state"], sm.Sharded)
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
    call sites, counting the calls (as ``test_torch_serving.py``'s
    ``TestKernelPathGlue``): ``attn_impl="kernel"`` then runs the
    kernel path's layout on the CPU."""
    calls = {"flash": 0, "decode": 0, "ssd": 0}
    fa, dec = fa_ops.flash_attention, dec_ops.decode_attention

    def flash(q, k, v, *, causal=True, window=0, impl="auto", out=None):
        assert impl == "kernel"
        calls["flash"] += 1
        return fa(q, k, v, causal=causal, window=window, impl="ref",
                  out=out)

    def decode(q, k, v, lengths=None, *, slot_pos=None, pos=None, window=0,
               impl="auto"):
        assert impl == "kernel"
        calls["decode"] += 1
        return dec(q, k, v, lengths, slot_pos=slot_pos, pos=pos,
                   window=window, impl="ref")

    def chunk(x, dt, A, B, C, *, chunk):
        calls["ssd"] += 1
        return ssd_chunk_ref(x, dt, A, B, C, chunk)

    monkeypatch.setattr(fa_ops, "flash_attention", flash)
    monkeypatch.setattr(port_layers, "flash_attention", flash)
    monkeypatch.setattr(port_layers, "decode_attention", decode)
    monkeypatch.setattr(ssd_ops, "ssd_chunk_kernel", chunk)
    return calls


# case -> the kernel path's calls (K7, K8, K9) a position and layer of a
# prefill and DECODE_STEPS decode steps: whisper's encoder layers add one
# bidir K7 call each, its decoder layers a causal and a cross K7 call,
# and a self and a cross K8 call a step; paligemma's prefix route is two
# K7 calls
GLUE_CASES = {"mamba2_2x2": (0, 0, 1), "hymba_2x2_dp_over_tp": (1, 1, 1),
              "whisper_1x2": (2, 2, 0), "paligemma_2x2": (2, 1, 0)}


@pytest.mark.parametrize("case", sorted(GLUE_CASES))
def test_kernel_path_layout_over_the_mesh(glue, case):
    """The kernel path over the mesh with the kernels' plain versions in
    their places: the plain path's logits, greedy ids and caches, and
    K7/K8/K9 called once a layer at every distinct position (the SSM's
    tensor-parallel replicas share one call on one device)."""
    cfg, pol, sp = sharded(case)
    batch = case_batch(cfg)
    plain = run(cfg, sp, pol, batch)
    kern = run(cfg, sp, pol, batch, impl="kernel")
    scale = float(plain[0].abs().max())
    assert float((kern[0] - plain[0]).abs().max()) <= LOGIT_TOL * scale
    for a, b in zip(kern[3], plain[3]):
        assert torch.equal(a, b)
    for a, b in zip(kern[2], plain[2]):
        assert float((a - b).abs().max()) <= LOGIT_TOL * scale
    for k in plain[4]:
        assert float((kern[4][k].float() - plain[4][k].float()).abs()
                     .max()) <= KV_TOL, k
    g = sm.mesh_grid(pol)
    f7, f8, f9 = GLUE_CASES[case]
    L, S = cfg.num_layers, chk.DECODE_STEPS
    n = g.dp * g.tp
    ssd_positions = g.dp  # the tensor ranks share one call on one device
    enc7 = cfg.encoder_layers * n
    assert glue == {"flash": f7 * L * n + enc7, "decode": f8 * L * n * S,
                    "ssd": f9 * L * ssd_positions}, glue


def _serve(argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_launch.main(argv)
    return [ln for ln in buf.getvalue().splitlines() if "->" in ln]


@pytest.mark.parametrize("arch,dp,tp", [("mamba2-370m", 2, 2),
                                        ("hymba-1.5b", 2, 1)])
def test_launch_serve_dp_tp(arch, dp, tp):
    prompts = ["is product 3 electronics?", "hello world", "a b c"]
    base = ["--arch", arch, "--tiny", "--device", "cpu", "--batch", "2",
            "--prompts", *prompts]
    mesh = _serve(["--dp", str(dp), "--tp", str(tp), *base])
    assert len(mesh) == 3 and mesh == _serve(base)


# --- held to the reference's run: last, so that the tests above run
# while its subprocess compiles ---


@pytest.mark.parametrize("names", sorted(DEVICES))
def test_moe_block_dp_over_tp_matches_the_reference(ref, names):
    """olmoe's ``moe_block`` at (2, 2) under ``dp_over_tp`` at capacity
    factor 1.0: the reference's answer, where experts drop rows by the
    capacity of n·S / (dp·tp) tokens; the default branch's capacity
    (n·S / dp) drops others."""
    arch, (dp, tp), _ = chk.MOE_CASE
    cfg = get_tiny(arch).replace(
        moe_capacity_factor=chk.MOE_CAPACITY_FACTOR)
    x = torch.as_tensor(chk.moe_input(cfg.d_model))
    out = {}
    for rep in ({"dp_over_tp": True}, {}):
        pol = policy(dp, tp, DEVICES[names], rep=rep)
        p0 = _layers(shard_params(cfg, weights(arch), pol)["blocks"],
                     cfg.num_layers)[0]["moe"]
        out[bool(rep)] = pm.moe_block(
            cfg, p0, sm.scatter_rows(x, sm.mesh_grid(pol)), pol).gather()
    np.testing.assert_allclose(out[True].numpy(), ref["moe"], atol=1e-5,
                               rtol=0)
    assert float((out[True] - out[False]).abs().max()) > 1e-2


@pytest.mark.parametrize("names", sorted(DEVICES))
@pytest.mark.parametrize("case", sorted(chk.SERVE_CASES))
def test_prefill_and_decode_match_the_reference_mesh(ref, case, names):
    """Prefill logits and every cache leaf, then DECODE_STEPS decode
    steps fed the reference's greedy tokens: each step's logits, the
    port's own greedy ids equal to the reference's, and the final
    cache."""
    cfg, pol, sp = sharded(case, DEVICES[names])
    batch = case_batch(cfg)
    fed = [torch.as_tensor(ref[f"{case}/tokens/{s}"])
           for s in range(chk.DECODE_STEPS)]
    logits, first, steps, mine, last = run(cfg, sp, pol, batch, fed)
    want = ref[f"{case}/prefill"]
    scale = np.abs(want).max()
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_TOL * scale,
                               rtol=0)
    B = chk.PROMPT[0]
    hold_cache(first, ref, f"{case}/cache/", B)
    assert torch.equal(logits.argmax(-1).int(), fed[0])
    for s, lg in enumerate(steps):
        np.testing.assert_allclose(lg.numpy(), ref[f"{case}/decode/{s}"],
                                   atol=LOGIT_TOL * scale, rtol=0)
        np.testing.assert_array_equal(
            lg.argmax(-1).int().numpy(), ref[f"{case}/tokens/{s + 1}"])
    hold_cache(last, ref, f"{case}/final_cache/", B)
