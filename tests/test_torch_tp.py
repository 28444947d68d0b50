"""The port's model-parallel mesh (``repro_torch.sharding.model``,
``models.params.shard_params``, the mesh branches of ``models.layers``
and ``models.lm``, the mesh ``ServingEngine`` and ``launch/serve --dp
--tp``) on meshes of repeated CPU devices, held to the reference's
sharded functions on forced host devices (one subprocess for the
module, ``tests/torch_tp_check.py``) on the reference's weights.

Tolerances: ``moe_block`` 1e-5 absolute (the partial sums over the
expert-parallel ranks add in another order than the reference's psum);
logits 1e-4 of the reference's max|logit| (prefill and every decode
step); the cache's keys and values 1e-5, ``slot_pos`` exact. Capacity
is per data-parallel token chunk under a mesh, so the MoE cases run at
capacity factor 1.0, where experts drop rows, and are held to the
reference's mesh run, not to one device's."""
import contextlib
import io

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_check as chk  # noqa: E402
from repro.configs import get_tiny as ref_tiny  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models.layers import moe_reference as ref_moe_dense  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.lm import _layers  # noqa: E402
from repro_torch.models.params import shard_params  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import ShardingPolicy  # noqa: E402

MOE_TOL = 1e-5
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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp") / "ref.npz"
    chk.run_reference(str(out))
    return dict(np.load(out))


def policy(dp, tp, names=("cpu",), **kw):
    devs = [names[i % len(names)] for i in range(dp * tp)]
    return ShardingPolicy.for_mesh(make_mesh(dp, tp, devices=devs), **kw)


@pytest.fixture(scope="module")
def weights():
    """The reference's tiny weights per arch, as port tensors."""
    cache = {}

    def get(arch):
        if arch not in cache:
            p = ref_init(ref_tiny(arch), jax.random.PRNGKey(0))
            cache[arch] = pm.params_from_numpy(
                jax.tree.map(np.asarray, p), "cpu")
        return cache[arch]
    return get


@pytest.mark.parametrize("case", sorted(chk.MOE_CASES))
def test_moe_block_matches_the_reference_mesh(ref, weights, case):
    arch, (dp, tp), ep, _ = chk.MOE_CASES[case]
    cfg = get_tiny(arch).replace(moe_capacity_factor=chk.MOE_CAPACITY_FACTOR)
    pol = policy(dp, tp).replace(ep_over_dp=ep)
    sp = shard_params(cfg, weights(arch), pol)
    p0 = _layers(sp["blocks"], cfg.num_layers)[0]["moe"]
    x = torch.as_tensor(chk.moe_input(case, cfg.d_model))
    g = sm.mesh_grid(pol)
    y = pm.moe_block(cfg, p0, sm.scatter_rows(x, g), pol)
    assert isinstance(y, sm.Rows) and y.n == x.shape[0]
    want = ref[f"moe/{case}"]
    np.testing.assert_allclose(y.gather().numpy(), want, atol=MOE_TOL,
                               rtol=0)
    # rows were dropped: the dense mixture differs
    pfull = jax.tree.map(lambda a: np.asarray(a[0]), ref_init(
        ref_tiny(arch), jax.random.PRNGKey(0))["blocks"]["moe"])
    dense = np.asarray(ref_moe_dense(ref_tiny(arch), pfull, x.numpy()))
    assert np.abs(want - dense).max() > 1e-2
    if case == "olmoe_2x2":  # capacity per token chunk changes the answer
        single = pm.moe_block(cfg, _layers(weights(arch)["blocks"],
                                           cfg.num_layers)[0]["moe"], x)
        assert (single - y.gather()).abs().max() > 1e-2


def test_moe_mesh_raises_where_shard_map_raises(weights):
    """The default branch splits the flattened tokens over the data
    ranks: 3 x 5 tokens do not split over 2."""
    cfg = get_tiny("olmoe-1b-7b")
    pol = policy(2, 2)
    p0 = _layers(shard_params(cfg, weights("olmoe-1b-7b"), pol)["blocks"],
                 cfg.num_layers)[0]["moe"]
    x = torch.zeros(3, 5, cfg.d_model)
    with pytest.raises(ValueError, match="do not split"):
        pm.moe_block(cfg, p0, sm.scatter_rows(x, sm.mesh_grid(pol)), pol)


@pytest.mark.parametrize("names", sorted(DEVICES))
@pytest.mark.parametrize("case", sorted(chk.MODEL_CASES))
def test_prefill_and_decode_match_the_reference_mesh(ref, weights, case,
                                                     names):
    arch, (dp, tp), kw = chk.MODEL_CASES[case]
    cfg = get_tiny(arch)
    pol = policy(dp, tp, DEVICES[names], **kw)
    sp = shard_params(cfg, weights(arch), pol)
    toks = torch.as_tensor(chk.prompt_tokens(cfg.vocab_size))
    logits, cache = pm.prefill(cfg, sp, {"tokens": toks},
                               max_seq=chk.MAX_SEQ, attn_impl="ref",
                               policy=pol)
    want = ref[f"model/{case}/prefill"]
    scale = np.abs(want).max()
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_TOL * scale,
                               rtol=0)
    whole = sm.unshard(cache)
    B = toks.shape[0]
    for name in ("k", "v"):
        np.testing.assert_allclose(
            whole[name][:, :B].numpy(), ref[f"model/{case}/cache/{name}"],
            atol=KV_TOL, rtol=0)
    np.testing.assert_array_equal(whole["slot_pos"][:, :B].numpy(),
                                  ref[f"model/{case}/cache/slot_pos"])
    pos = torch.full((B,), chk.PROMPT[1], dtype=torch.int32)
    for s in range(chk.DECODE_STEPS):
        tok = torch.as_tensor(ref[f"model/{case}/tokens/{s}"])
        logits, cache = pm.decode_step(cfg, sp, cache, tok, pos,
                                       attn_impl="ref", policy=pol)
        np.testing.assert_allclose(
            logits.numpy(), ref[f"model/{case}/decode/{s}"],
            atol=LOGIT_TOL * scale, rtol=0)
        pos = pos + 1


@pytest.mark.parametrize("mesh", ((2, 2), (1, 4), (4, 1), (2, 4)))
def test_forward_matches_one_device(weights, mesh):
    """``forward`` over the mesh against the port's own forward on one
    device, at capacity factor E/k (no row drops, so the capacity
    split does not change the answer)."""
    arch = "olmoe-1b-7b"
    cfg = get_tiny(arch)
    cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                      / cfg.experts_per_tok)
    p = weights(arch)
    toks = torch.as_tensor(chk.prompt_tokens(cfg.vocab_size))
    want, hw = pm.forward(cfg, p, {"tokens": toks}, attn_impl="ref")
    pol = policy(*mesh)
    got, h = pm.forward(cfg, shard_params(cfg, p, pol), {"tokens": toks},
                        attn_impl="ref", policy=pol)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= LOGIT_TOL * scale
    assert float((h - hw).abs().max()) <= 1e-4


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "starcoder2-3b",
                                  "qwen2.5-32b", "deepseek-v3-671b",
                                  "mamba2-370m"))
@pytest.mark.parametrize("mesh", ((2, 2), (1, 4), (2, 1, 2)))
def test_shard_unshard_round_trip(weights, arch, mesh):
    """``shard_params`` then ``unshard`` gives every leaf back bit for
    bit; parts that share a device and a slice share one tensor."""
    cfg = get_tiny(arch)
    p = pm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    if len(mesh) == 3:
        m = make_mesh(mesh[1], mesh[2], pods=mesh[0], devices=["cpu"] * 4)
        pol = ShardingPolicy.for_mesh(m)
    else:
        pol = policy(*mesh)
    sp = shard_params(cfg, p, pol)
    back = sm.unshard(sp)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        else:
            assert torch.equal(a, b)

    same(back, p)
    ln = sp["final_ln"]  # replicated: one tensor on the shared CPU
    assert len({id(x) for x in ln.parts.flat}) == 1
    if cfg.family in ("dense", "moe") and not cfg.use_mla:
        # each rank holds exactly the KV heads its query heads read, and
        # the widths of local_config
        g = sm.mesh_grid(pol)
        loc = sm.local_config(cfg, g)
        blk = sp["blocks"]
        for i, t in g.coords():
            lo, hi = sm.kv_range(cfg.num_heads, cfg.num_kv_heads, g.tp, t)
            assert blk["attn"]["wk"].parts[i, t].shape[2] == hi - lo
            assert hi - lo == loc.num_kv_heads
            assert blk["attn"]["wq"].parts[i, t].shape[2] == loc.num_heads
            if cfg.num_experts:
                assert blk["moe"]["w_in"].parts[i, t].shape[1] == \
                    loc.num_experts
            else:
                assert blk["mlp"]["w_in"].parts[i, t].shape[2] == loc.d_ff


def test_single_policy_is_the_plain_tree(weights):
    p = weights("starcoder2-3b")
    assert shard_params(get_tiny("starcoder2-3b"), p,
                        ShardingPolicy.single()) is p


def serve_prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = "is the review positive product winter garden yes no".split()
    return [" ".join(rng.choice(words, int(rng.integers(3, 20))))
            for _ in range(n)]


@pytest.mark.parametrize("mesh", ((2, 2), (1, 4)))
@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "starcoder2-3b"))
def test_mesh_engine_answers_as_one_device(weights, arch, mesh):
    """Continuous (with admission widths 4, 2 and 1, so a width-1
    admission pads over two data ranks), drained and two waves a round
    apart: the mesh engine's token ids equal the single-device
    engine's, at capacity factor E/k for the MoE (no row drops)."""
    cfg = get_tiny(arch)
    if cfg.num_experts:
        cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                          / cfg.experts_per_tok)
    p = weights(arch)
    kw = dict(batch_size=4, max_seq=24, max_new_tokens=3, device="cpu",
              attn_impl="ref")
    prompts = serve_prompts(23)
    one = ServingEngine(cfg, p, **kw)
    pol = policy(*mesh)
    eng = ServingEngine(cfg, shard_params(cfg, p, pol), policy=pol, **kw)
    assert eng.device == torch.device("cpu")
    assert isinstance(eng.scheduler._cache["k"], sm.Sharded)
    assert eng.answer(prompts) == one.answer(prompts)
    assert eng.answer_drained(prompts) == one.answer_drained(prompts)
    for e in (one, eng):
        head = e.submit(prompts[:3])
        e.poll()
        tail = e.submit(prompts[3:])
        e.drain()
        e.out = e.answers(head) + e.answers(tail)
    assert eng.out == one.out
    assert eng.stats.batches == one.stats.batches


def test_mesh_engine_requires_sharded_params(weights):
    cfg = get_tiny("starcoder2-3b")
    with pytest.raises(ValueError, match="shard_params"):
        ServingEngine(cfg, weights("starcoder2-3b"), device="cpu",
                      policy=policy(1, 2))


@pytest.mark.parametrize("arch", ("hymba-1.5b",))
def test_other_families_refuse_the_mesh(arch):
    """Every family runs over a mesh now, the hybrid at tp > 1 without
    ``dp_over_tp`` too (``test_torch_tp_hybrid.py``): only the policy
    ``ep_over_dp`` with ``dp_over_tp`` is refused, for any family. The
    hybrid at (1, 2) lays its cache out by ``kv_range`` and prefills
    as one device."""
    cfg = get_tiny(arch)
    p = pm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.ones(2, 4, dtype=torch.int64)
    bad = policy(2, 2).replace(dp_over_tp=True, ep_over_dp=True)
    with pytest.raises(sm.MeshNotPorted, match="ep_over_dp"):
        pm.prefill(cfg, p, {"tokens": toks}, attn_impl="ref", policy=bad)
    with pytest.raises(sm.MeshNotPorted, match="ep_over_dp"):
        pm.init_cache(cfg, 2, 8, policy=bad)
    pol = policy(1, 2)
    cache = pm.init_cache(cfg, 2, 8, policy=pol)
    for t in range(2):
        lo, hi = sm.kv_range(cfg.num_heads, cfg.num_kv_heads, 2, t)
        assert cache["k"].parts[0, t].shape[3] == hi - lo
    want, _ = pm.prefill(cfg, p, {"tokens": toks}, attn_impl="ref")
    got, _ = pm.prefill(cfg, shard_params(cfg, p, pol), {"tokens": toks},
                        attn_impl="ref", policy=pol)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def _serve(argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_launch.main(argv)
    return [ln for ln in buf.getvalue().splitlines() if "->" in ln]


def test_launch_serve_dp_tp_on_the_cpu():
    prompts = ["is product 3 electronics?", "hello world", "a b c"]
    base = ["--tiny", "--device", "cpu", "--batch", "2", "--prompts",
            *prompts]
    out = _serve(["--dp", "2", "--tp", "2", *base])
    assert len(out) == 3
    one = _serve(["--arch", "starcoder2-3b", *base])
    mesh = _serve(["--arch", "starcoder2-3b", "--dp", "2", "--tp", "2",
                   *base])
    assert mesh == one


def test_launch_serve_ckpt_over_the_mesh(tmp_path):
    """``serve --ckpt`` over a (1, 2) mesh: the backend's 8 experts and 4
    heads split over two tensor-parallel ranks, the answers those of
    one device (one data rank: the same capacity)."""
    from repro_torch.training.backend import backend_config
    from repro_torch.training.checkpoint import CheckpointManager

    cfg = backend_config()
    params = pm.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(1, {"params": params})
    base = ["--ckpt", ckpt, "--device", "cpu", "--batch", "2", "--prompts",
            "is product 3 electronics?", "a toys item", "review 7"]
    one = _serve(base)
    assert len(one) == 3
    assert _serve(["--dp", "1", "--tp", "2", *base]) == one


def test_mesh_model_leaves_no_tensor_in_a_reference_cycle(weights):
    """A mesh prefill and decode step free every tensor they make (the
    FSDP gathers above all) without the cycle collector: none is left
    in a reference cycle, where a layer's gathered weights would
    outlive it until the collector ran."""
    import gc

    cfg = get_tiny("olmoe-1b-7b")
    pol = policy(2, 2)
    sp = shard_params(cfg, weights("olmoe-1b-7b"), pol)
    toks = torch.as_tensor(chk.prompt_tokens(cfg.vocab_size))
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        _, cache = pm.prefill(cfg, sp, {"tokens": toks}, max_seq=20,
                              attn_impl="ref", policy=pol)
        pm.decode_step(cfg, sp, cache, toks[:, -1],
                       torch.full((4,), 16, dtype=torch.int32),
                       attn_impl="ref", policy=pol)
        del cache
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, [tuple(t.shape) for t in cyclic[:5]]
