"""The port's encoder-decoder (whisper) against the reference's on the
same weights: whisper-tiny's parameters (``repro.models.init_params``
carried across with ``params_from_numpy``), 32 stub frames of embeddings
and token ids from a numpy seed. Held layer for layer: ``_mask_bias``
in all three modes, ``attention_block`` bidirectional (the encoder) and
as cross-attention (``kv_override``), ``_cross_kv``, cross decode,
``encode``, ``forward``, ``forward_loss`` with the gradient of every
leaf, every ``prefill`` cache leaf (``k``, ``v``, ``slot_pos``, ``xk``,
``xv``), four ``decode_step``s, decode-matches-forward, three train
steps at 2 microbatches (frames split with the tokens) and
``count_params`` at full width; K7's bidirectional route with Sq != Sk
through its plain version (``impl="ref"``), as the card runs it through
the kernel.

Tolerances: 1e-4 absolute and relative, port against reference
(float32 products summed in other orders); decode against forward
within the reference's own 2e-3 (``tests/test_models_smoke.py``);
gradients rtol 1e-4, atol 1e-5, as ``test_torch_training.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, get_tiny  # noqa: E402
from repro.models import (  # noqa: E402
    count_params,
    decode_step,
    forward,
    forward_loss,
    init_params,
    prefill,
)
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.sharding import ShardingPolicy  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training.train_step import build_train_step as ref_step  # noqa
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    init_state,
    leaves,
)
from repro_torch.training.train_step import build_train_step  # noqa: E402

ARCH = "whisper-small"
POLICY = ShardingPolicy.single()
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
_CACHE: dict = {}


def setup():
    """(cfg, reference params, port params), whisper-tiny."""
    if not _CACHE:
        cfg = get_tiny(ARCH)
        ref = init_params(cfg, jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, ref)
        _CACHE["v"] = (cfg, ref, pm.params_from_numpy(host, "cpu"))
    return _CACHE["v"]


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def batch(cfg, seed, B=4, S=10, frames=None):
    """Tokens in [1, vocab) with padding zeros at the end of two rows,
    and ``frames`` (default encoder_seq) unit-normal frame
    embeddings."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    t[0, -3:] = 0
    t[2, -1:] = 0
    f = rng.standard_normal((B, frames or cfg.encoder_seq, cfg.d_model))
    return {"tokens": t, "frames": f.astype(np.float32)}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def layer0(tree, name):
    """Layer 0 of a stacked subtree of the decoder's blocks."""
    return {k: v[0] for k, v in tree["blocks"][name].items()}


def hidden(cfg, seed, S):
    return np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("mode", ("causal", "bidir", "prefix"))
@pytest.mark.parametrize("window", (0, 3))
def test_mask_bias_modes(mode, window):
    q = np.arange(7)[None].repeat(2, 0) + np.array([[0], [2]])
    k = np.arange(9)
    want = ref_layers._mask_bias(mode, jnp.asarray(q), jnp.asarray(k),
                                 window, 4)
    got = port_layers._mask_bias(torch.as_tensor(q), torch.as_tensor(k),
                                 window, mode, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encoder_attention_block_bidir():
    cfg, ref, port = setup()
    x = hidden(cfg, 0, cfg.encoder_seq)
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    pr = {k: v[0] for k, v in ref["encoder"]["blocks"]["attn"].items()}
    pp = {k: v[0] for k, v in port["encoder"]["blocks"]["attn"].items()}
    want = ref_layers.attention_block(cfg, POLICY, pr, jnp.asarray(x), pos,
                                      mode="bidir")
    got, k, v = port_layers.attention_block(cfg, pp, torch.as_tensor(x),
                                            mode="bidir")
    close(got, want)
    assert k.shape == (B, S, cfg.num_kv_heads, cfg.resolved_head_dim)


def test_cross_kv_and_cross_attention_block():
    cfg, ref, port = setup()
    enc = hidden(cfg, 1, cfg.encoder_seq)
    x = hidden(cfg, 2, 7)
    B, S = x.shape[:2]
    pr, pp = layer0(ref, "xattn"), layer0(port, "xattn")
    epos = jnp.broadcast_to(jnp.arange(enc.shape[1])[None],
                            (B, enc.shape[1]))
    rk, rv, _ = ref_lm._cross_kv(cfg, pr, jnp.asarray(enc), epos)
    pk, pv = port_lm._cross_kv(pp, torch.as_tensor(enc))
    close(pk, rk)
    close(pv, rv)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    want = ref_layers.attention_block(cfg, POLICY, pr, jnp.asarray(x), pos,
                                      mode="bidir",
                                      kv_override=(rk, rv, epos))
    got, k, v = port_layers.attention_block(
        cfg, pp, torch.as_tensor(x), mode="bidir", kv_override=(pk, pv))
    close(got, want)
    assert k is None and v is None


def test_cross_decode_reads_every_slot_and_writes_nothing():
    cfg, ref, port = setup()
    pr, pp = layer0(ref, "xattn"), layer0(port, "xattn")
    x = hidden(cfg, 3, 1)
    T = cfg.encoder_seq
    shape = (2, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    rng = np.random.default_rng(4)
    xk, xv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    pos = np.array([3, 11], np.int32)
    want, *_ = ref_layers.attention_decode(
        cfg, POLICY, pr, jnp.asarray(x), jnp.asarray(xk), jnp.asarray(xv),
        jnp.zeros((2, T), jnp.int32), jnp.asarray(pos), cross=True)
    tk, tv = torch.as_tensor(xk), torch.as_tensor(xv)
    got = port_layers.attention_decode(cfg, pp, torch.as_tensor(x), tk, tv,
                                       None, torch.as_tensor(pos),
                                       cross=True)
    close(got, want)
    np.testing.assert_array_equal(tk.numpy(), xk)
    np.testing.assert_array_equal(tv.numpy(), xv)


@pytest.mark.parametrize("Sq", (1, 7, 33))
@pytest.mark.parametrize("Sk", (5, 32))
def test_k7_bidir_route_with_unequal_lengths(Sq, Sk):
    """The kernel path's route for the encoder and for cross-attention
    (K7 ``causal=False``, Sq != Sk), on K7's plain version, against the
    reference's grouped einsum under its "bidir" mask."""
    rng = np.random.default_rng(Sq * 100 + Sk)
    B, H, K, hd = 2, 6, 2, 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
            for _ in range(2))
    bias = ref_layers._mask_bias("bidir", jnp.arange(Sq)[None],
                                 jnp.arange(Sk), 0, 0)
    bias = jnp.broadcast_to(bias, (B, Sq, Sk))
    want = ref_layers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), bias, POLICY)
    got = port_layers.k7_attention(*map(torch.as_tensor, (q, k, v)),
                                   mode="bidir", impl="ref")
    close(got, want)


def test_encode():
    cfg, ref, port = setup()
    b = batch(cfg, 5)
    want, _ = ref_lm.encode(cfg, POLICY, ref, jnp.asarray(b["frames"]))
    got = port_lm.encode(cfg, port, torch.as_tensor(b["frames"]))
    close(got, want)
    # fewer frames than encoder_seq: the first positions of pos_embed
    f = b["frames"][:, :20]
    want, _ = ref_lm.encode(cfg, POLICY, ref, jnp.asarray(f))
    close(port_lm.encode(cfg, port, torch.as_tensor(f)), want)


def test_forward():
    cfg, ref, port = setup()
    b = batch(cfg, 6)
    want, hw, n_img = forward(cfg, POLICY, ref, to_jax(b))
    got, h = pm.forward(cfg, port, to_torch(b))
    assert n_img == 0 and got.shape == (4, 10, cfg.vocab_size)
    close(got, want)
    close(h, hw)


def test_forward_loss_and_every_gradient():
    cfg, ref, port = setup()
    b = batch(cfg, 7)
    loss, grads = jax.value_and_grad(
        lambda p: forward_loss(cfg, POLICY, p, to_jax(b)))(ref)
    flat = [v for _, v in leaves(port)]
    for v in flat:
        v.requires_grad_(True)
    got = pm.forward_loss(cfg, port, to_torch(b))
    raw = torch.autograd.grad(got, flat)
    for v in flat:
        v.requires_grad_(False)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in leaves_of(grads)}
    have = {k: g.numpy() for (k, _), g in zip(leaves(port), raw)}
    assert set(have) == set(want)
    assert any(k.startswith("encoder.") for k in have)
    for k, v in want.items():
        np.testing.assert_allclose(have[k], v, err_msg=k, **GRAD_TOL)


def leaves_of(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_of(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("frames", (None, 20))
def test_prefill_fills_every_cache_leaf(frames):
    """Every leaf; with fewer frames than encoder_seq the cross K/V
    hold the frames given, as the reference's."""
    cfg, ref, port = setup()
    b = batch(cfg, 8, frames=frames)
    want_l, want_c = prefill(cfg, POLICY, ref, to_jax(b), max_seq=16)
    got_l, got_c = pm.prefill(cfg, port, to_torch(b), max_seq=16)
    close(got_l, want_l)
    assert set(got_c) == set(want_c) == {"k", "v", "slot_pos", "xk", "xv"}
    assert got_c["xk"].shape == (cfg.num_layers, 4,
                                 frames or cfg.encoder_seq,
                                 cfg.num_kv_heads, cfg.resolved_head_dim)
    for k, v in got_c.items():
        assert tuple(v.shape) == want_c[k].shape, k
        if k == "slot_pos":
            np.testing.assert_array_equal(v.numpy(), np.asarray(want_c[k]))
        else:
            close(v, want_c[k])


def test_four_decode_steps():
    cfg, ref, port = setup()
    b = batch(cfg, 9)
    _, cr = prefill(cfg, POLICY, ref, to_jax(b), max_seq=16)
    _, cp = pm.prefill(cfg, port, to_torch(b), max_seq=16)
    xk = cp["xk"].clone()
    pos = np.full(4, 10, np.int32)
    rng = np.random.default_rng(10)
    for _ in range(4):
        t = rng.integers(1, cfg.vocab_size, 4).astype(np.int32)
        lr, cr = decode_step(cfg, POLICY, ref, cr, jnp.asarray(t),
                             jnp.asarray(pos))
        lp, cp2 = pm.decode_step(cfg, port, cp, torch.as_tensor(t),
                                 torch.as_tensor(pos))
        assert cp2 is cp  # in place
        close(lp, lr)
        for k, v in cp.items():
            if k == "slot_pos":
                np.testing.assert_array_equal(v.numpy(), np.asarray(cr[k]))
            else:
                close(v, cr[k])
        pos = pos + 1
    assert torch.equal(cp["xk"], xk)  # decode writes no cross K/V


def test_decode_matches_forward():
    cfg, ref, port = setup()
    S = 8
    full = batch(cfg, 11, S=S + 1)
    full["tokens"][:] = np.abs(full["tokens"]) + 1  # no padding
    short = dict(full, tokens=full["tokens"][:, :S])
    _, cache = pm.prefill(cfg, port, to_torch(short), max_seq=S + 4)
    got, _ = pm.decode_step(cfg, port, cache,
                            torch.as_tensor(full["tokens"][:, S]),
                            torch.full((4,), S, dtype=torch.int32))
    logits, _ = pm.forward(cfg, port, to_torch(full))
    close(got, logits[:, S].detach().numpy(), **DECODE_TOL)
    want, _, _ = forward(cfg, POLICY, ref, to_jax(full))
    close(got, np.asarray(want)[:, S], **DECODE_TOL)


def test_train_steps_split_frames_into_microbatches():
    """Three steps at 2 microbatches: ``_split_batch`` splits the frames
    with the tokens, as the reference's does."""
    cfg, ref, _ = setup()
    host = jax.tree.map(np.asarray, ref)
    step = jax.jit(ref_step(cfg, POLICY, ref_opt.AdamWConfig(lr=1e-3),
                            num_microbatches=2))
    rp = ref
    rs = ref_opt.init_state(rp, ref_opt.AdamWConfig(lr=1e-3))
    opt = AdamWConfig(lr=1e-3)
    params = pm.params_from_numpy(host, "cpu")
    state = init_state(params, opt)
    port_step = build_train_step(cfg, opt, num_microbatches=2)
    for i in range(3):
        b = batch(cfg, 20 + i)
        rp, rs, m = step(rp, rs, to_jax(b))
        params, state, mp = port_step(params, state, to_torch(b))
        np.testing.assert_allclose(
            [float(mp["loss"]), float(mp["grad_norm"])],
            [float(m["loss"]), float(m["grad_norm"])], **TOL)


def test_count_params_full_width():
    cfg = port_config(ARCH)
    assert pm.count_params(cfg) == count_params(get_config(ARCH)) \
        == 363_998_208
    # the tree itself: the reference's count makes the decoder's blocks
    # twice (without, then with cross-attention)
    tree = pm.build_params(cfg, lambda p, s, c: torch.empty(s,
                                                            device="meta"))
    assert "xattn" in tree["blocks"] and "encoder" in tree
    assert sum(v.numel() for _, v in leaves_of(tree)) == 279_045_120
