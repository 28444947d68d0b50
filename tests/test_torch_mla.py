"""The port's DeepSeek-V3 pieces against the reference's on the same
weights: multi-head latent attention (``_mla_q``, ``_mla_kv_latent``,
``mla_block``, the absorbed ``mla_decode`` over several steps with its
in-place latent cache) and multi-token prediction (``_mtp_loss`` and
``forward_loss`` with it, values and the gradient of every leaf), on
deepseek-tiny's parameters (``repro.models.init_params`` carried across
with ``params_from_numpy``) and inputs from a numpy seed.

Tolerances: 1e-4 absolute and relative, port against reference, layer
for layer (float32 products summed in other orders); the absorbed decode
against the materialised form within 2e-3, the reference's own
decode-matches-forward tolerance (``tests/test_models_smoke.py``): the
two forms contract the latent in different orders. Gradients rtol 1e-4,
atol 1e-5, as ``test_torch_training.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, get_tiny  # noqa: E402
from repro.models import count_params, forward_loss, init_params  # noqa
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.sharding import ShardingPolicy  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.training.optimizer import leaves  # noqa: E402

ARCH = "deepseek-v3-671b"
POLICY = ShardingPolicy.single()
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ABSORBED_TOL = dict(atol=2e-3, rtol=2e-3)
_CACHE: dict = {}


def setup():
    """(cfg, reference params, reference params as numpy, port params)."""
    if not _CACHE:
        cfg = get_tiny(ARCH)
        ref = init_params(cfg, jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, ref)
        _CACHE["v"] = (cfg, ref, host, pm.params_from_numpy(host, "cpu"))
    return _CACHE["v"]


def layer0(tree):
    """Layer 0 of the stacked MLA parameters."""
    return {k: v[0] for k, v in tree["blocks"]["mla"].items()}


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def hidden(cfg, seed, shape=(2, 9)):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def tokens(cfg, seed, shape=(4, 12)):
    """Ids in [1, vocab) with padding zeros at the ends of two rows."""
    t = np.random.default_rng(seed).integers(1, cfg.vocab_size, shape)
    t[0, -3:] = 0
    t[2, -1:] = 0
    return t.astype(np.int32)


def test_mla_q_and_latent():
    cfg, ref, _, port = setup()
    x = hidden(cfg, 0)
    B, S = x.shape[:2]
    pos = np.broadcast_to(np.arange(S)[None], (B, S)) + 3  # off zero
    pr, pp = layer0(ref), layer0(port)
    want = ref_layers._mla_q(cfg, pr, jnp.asarray(x), jnp.asarray(pos))
    got = port_layers._mla_q(cfg, pp, torch.as_tensor(x),
                             torch.as_tensor(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)
    want = ref_layers._mla_kv_latent(cfg, pr, jnp.asarray(x),
                                     jnp.asarray(pos))
    got = port_layers._mla_kv_latent(cfg, pp, torch.as_tensor(x),
                                     torch.as_tensor(pos))
    assert tuple(got[0].shape) == (B, S, cfg.kv_lora_rank)
    assert tuple(got[1].shape) == (B, S, cfg.qk_rope_head_dim)
    for g, w in zip(got, want):
        close(g, w)


def test_mla_block():
    cfg, ref, _, port = setup()
    x = hidden(cfg, 1)
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    want = ref_layers.mla_block(cfg, POLICY, layer0(ref), jnp.asarray(x),
                                pos)
    ckv, krope = ref_layers._mla_kv_latent(cfg, layer0(ref), jnp.asarray(x),
                                           pos)
    out, ckv_p, krope_p = port_layers.mla_block(cfg, layer0(port),
                                                torch.as_tensor(x))
    close(out, want)
    close(ckv_p, ckv)
    close(krope_p, krope)


def test_mla_decode_steps_update_the_cache_in_place():
    """Four absorbed decode steps over one latent cache, rows at
    different positions (append, overwrite an earlier slot, the last
    slot): every output and both cache leaves equal the reference's
    after every step, and the port's caches are the tensors it was
    given."""
    cfg, ref, _, port = setup()
    rng = np.random.default_rng(2)
    B, T = 3, 14
    ckv = rng.standard_normal((B, T, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((B, T, cfg.qk_rope_head_dim)).astype(
        np.float32)
    rc, rk = jnp.asarray(ckv), jnp.asarray(krope)
    pc, pk = torch.as_tensor(ckv.copy()), torch.as_tensor(krope.copy())
    pc0, pk0 = pc, pk
    pos = np.array([6, 2, T - 4], np.int32)
    for step in range(4):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, rc, rk = ref_layers.mla_decode(cfg, POLICY, layer0(ref),
                                             jnp.asarray(x), rc, rk,
                                             jnp.asarray(pos))
        got = port_layers.mla_decode(cfg, layer0(port), torch.as_tensor(x),
                                     pc, pk, torch.as_tensor(pos))
        assert pc is pc0 and pk is pk0
        close(got, want)
        close(pc, rc)
        close(pk, rk)
        pos = pos + 1


def test_absorbed_decode_matches_materialised():
    """``mla_decode`` at position t over the latent of positions 0..t
    equals ``mla_block``'s output at t (the materialised form), within
    the reference's 2e-3, in the port and in the reference."""
    cfg, ref, _, port = setup()
    x = hidden(cfg, 3, (2, 8))
    B, S = x.shape[:2]
    pp = layer0(port)
    full, ckv, krope = port_layers.mla_block(cfg, pp, torch.as_tensor(x))
    pos_r = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    full_r = ref_layers.mla_block(cfg, POLICY, layer0(ref), jnp.asarray(x),
                                  pos_r)
    T = S + 2
    for t in (0, 4, S - 1):
        c = torch.zeros(B, T, cfg.kv_lora_rank)
        k = torch.zeros(B, T, cfg.qk_rope_head_dim)
        c[:, :t] = ckv[:, :t]
        k[:, :t] = krope[:, :t]
        pos = torch.full((B,), t, dtype=torch.int32)
        got = port_layers.mla_decode(cfg, pp, torch.as_tensor(x[:, t:t + 1]),
                                     c, k, pos)
        close(got[:, 0], full[:, t].detach().numpy(), **ABSORBED_TOL)
        close(c[:, :t + 1], ckv[:, :t + 1].numpy())
        want, _, _ = ref_layers.mla_decode(
            cfg, POLICY, layer0(ref), jnp.asarray(x[:, t:t + 1]),
            jnp.asarray(c.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(pos.numpy()))
        np.testing.assert_allclose(np.asarray(want)[:, 0],
                                   np.asarray(full_r)[:, t], **ABSORBED_TOL)
        close(got, want)


def grads_of(fn, tree):
    """(value, {dotted path: grad}) of ``fn(tree)`` over every leaf of
    the port tree ``tree``."""
    flat = [v for _, v in leaves(tree)]
    for v in flat:
        v.requires_grad_(True)
    try:
        val = fn(tree)
        gs = torch.autograd.grad(val, flat)
    finally:
        for v in flat:
            v.requires_grad_(False)
    return float(val.detach()), {k: g.numpy() for (k, _), g in
                                 zip(leaves(tree), gs)}


def ref_grads(fn, host):
    val, g = jax.value_and_grad(fn)(jax.tree.map(jnp.asarray, host))
    return float(val), {".".join(k.key for k in path): np.asarray(v)
                        for path, v in jax.tree_util.tree_leaves_with_path(g)}


def same_grads(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **GRAD_TOL)


def test_mtp_loss_alone():
    """``_mtp_loss`` over given hidden states: the value and the
    gradients of the hidden states, the embedding, the LM head and every
    ``mtp`` leaf."""
    cfg, _, host, _ = setup()
    toks = tokens(cfg, 4)
    h = hidden(cfg, 5, toks.shape)
    sub = {k: host[k] for k in ("embed", "lm_head", "mtp")}
    want_v, want = ref_grads(lambda q: ref_lm._mtp_loss(
        cfg, POLICY, {**q, "blocks": None}, q["h"], jnp.asarray(toks), 0),
        {**sub, "h": h})
    got_v, got = grads_of(lambda q: port_lm._mtp_loss(
        cfg, q, q["h"], torch.as_tensor(toks)),
        {**pm.params_from_numpy(sub, "cpu"), "h": torch.as_tensor(h)})
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    assert {k.split(".")[0] for k in got} == {"embed", "lm_head", "mtp", "h"}
    same_grads(got, want)


def test_forward_loss_with_mtp():
    """``forward_loss`` (0.3 x the MTP loss added) under remat "full"
    (without remat: ``test_torch_training.py``): its value equals the
    next-token loss plus 0.3 x ``_mtp_loss`` on the final hidden states,
    and the value and the gradient of every leaf (``mtp/*`` included)
    equal the reference's under the same remat, whose MTP block takes
    no checkpoint of its own."""
    remat = "full"
    cfg, _, host, port = setup()
    toks = tokens(cfg, 6)
    batch = {"tokens": torch.as_tensor(toks)}
    want_v, want = ref_grads(lambda q: forward_loss(
        cfg, POLICY, q, {"tokens": jnp.asarray(toks)}, remat=remat), host)
    got_v, got = grads_of(lambda q: pm.forward_loss(cfg, q, batch,
                                                    remat=remat), port)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    assert any(k.startswith("mtp.") for k in got)
    same_grads(got, want)
    with torch.no_grad():
        no_mtp = {k: v for k, v in port.items() if k != "mtp"}
        base = pm.forward_loss(cfg.replace(mtp_depth=0), no_mtp, batch)
        _, h = pm.forward(cfg, port, batch)
        mtp = port_lm._mtp_loss(cfg, port, h, batch["tokens"])
    np.testing.assert_allclose(got_v, float(base + 0.3 * mtp), rtol=1e-6)


def test_cache_holds_only_the_latent():
    cfg, *_ = setup()
    spec = pm.build_cache_spec(cfg, 3, 17)
    assert spec == {"ckv": (cfg.num_layers, 3, 17, cfg.kv_lora_rank),
                    "krope": (cfg.num_layers, 3, 17, cfg.qk_rope_head_dim)}
    assert set(spec) == set(ref_lm.build_cache_spec(cfg, 3, 17))
    cache = pm.init_cache(cfg, 3, 17, device="cpu")
    assert set(cache) == {"ckv", "krope"}
    assert all(not v.any() for v in cache.values())


def test_kernel_impl_raises_on_mla():
    """MLA has no kernel path (the reference runs it outside any Pallas
    kernel): the engine refuses ``attn_impl="kernel"`` at construction,
    and so do prefill and decode; "auto" and "ref" run."""
    cfg, _, _, port = setup()
    with pytest.raises(ValueError, match="MLA"):
        ServingEngine(cfg, port, batch_size=2, max_seq=8, device="cpu",
                      attn_impl="kernel")
    toks = torch.ones(2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="MLA"):
        pm.prefill(cfg, port, {"tokens": toks}, attn_impl="kernel")
    _, cache = pm.prefill(cfg, port, {"tokens": toks}, max_seq=8)
    with pytest.raises(ValueError, match="MLA"):
        pm.decode_step(cfg, port, cache, toks[:, 0],
                       torch.full((2,), 5, dtype=torch.int32),
                       attn_impl="kernel")
    for impl in ("auto", "ref"):
        ServingEngine(cfg, port, batch_size=2, max_seq=8, device="cpu",
                      attn_impl=impl)


def test_count_params_full_width():
    """704,150,155,264 at full width, as the reference counts; 13.7 B at
    one layer (the card's cut); the MTP subtree carried across with
    ``params_from_numpy`` leaf for leaf."""
    full = port_config(ARCH)
    assert pm.count_params(full) == count_params(get_config(ARCH)) \
        == 704_150_155_264
    one = full.replace(num_layers=1)
    assert pm.count_params(one) == count_params(
        get_config(ARCH).replace(num_layers=1)) == 13_712_994_304
    shapes = pm.build_params(full, lambda path, shape, scale: shape)
    D = full.d_model
    assert shapes["mtp"]["proj"] == (2 * D, D)
    attn = shapes["mtp"]["blocks"]["attn"]
    assert attn["wq"] == (1, D, 128, 56) and "mla" not in shapes["mtp"][
        "blocks"] and "mlp" in shapes["mtp"]["blocks"]
    cfg, _, host, port = setup()
    for (k, v), (_, w) in zip(leaves(port["mtp"]), leaves(host["mtp"])):
        assert v.dtype == torch.float32 and tuple(v.shape) == w.shape, k
        np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
