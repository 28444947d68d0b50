"""The port's VLM (paligemma) against the reference's on the same
weights: paligemma-tiny's parameters (``repro.models.init_params``
carried across with ``params_from_numpy``), 8 stub patch embeddings and
token ids from a numpy seed. Held layer for layer: ``attention_block``
under the prefix-LM mask, ``forward`` (logits over the 8 image and the
text positions, ``img_proj`` included), ``forward_loss`` with the
gradient of every leaf (the reference's ``n_img`` offset), every
``prefill`` cache leaf (``k``, ``v``, ``slot_pos`` over image and text
positions), four ``decode_step``s from ``pos = n_img + S``,
decode-matches-forward, three train steps at 2 microbatches (patches
split with the tokens) and ``count_params`` at full width; K7's prefix
route (causal over all rows, then the prefix rows without the mask,
written into the same output) through its plain version
(``impl="ref"``), as the card runs it through the kernel.

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
from repro.sharding import ShardingPolicy  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training.train_step import build_train_step as ref_step  # noqa
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    prefix_attention,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_prefix_ref,
)
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    init_state,
    leaves,
)
from repro_torch.training.train_step import build_train_step  # noqa: E402

ARCH = "paligemma-3b"
POLICY = ShardingPolicy.single()
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)
_CACHE: dict = {}


def setup():
    """(cfg, reference params, port params), paligemma-tiny."""
    if not _CACHE:
        cfg = get_tiny(ARCH)
        ref = init_params(cfg, jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, ref)
        _CACHE["v"] = (cfg, ref, pm.params_from_numpy(host, "cpu"))
    return _CACHE["v"]


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def batch(cfg, seed, B=4, S=10):
    """Tokens in [1, vocab) with padding zeros at the end of two rows,
    and num_image_tokens unit-normal patch embeddings."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    t[0, -3:] = 0
    t[2, -1:] = 0
    p = rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model))
    return {"tokens": t, "patches": p.astype(np.float32)}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def leaves_of(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_of(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("prefix", (0, 3, 8, 14))
def test_attention_block_prefix(prefix):
    cfg, ref, port = setup()
    x = np.random.default_rng(prefix).standard_normal(
        (2, 14, cfg.d_model)).astype(np.float32)
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    pr = {k: v[0] for k, v in ref["blocks"]["attn"].items()}
    pp = {k: v[0] for k, v in port["blocks"]["attn"].items()}
    want = ref_layers.attention_block(cfg, POLICY, pr, jnp.asarray(x), pos,
                                      mode="prefix", prefix=prefix)
    got, k, v = port_layers.attention_block(
        cfg, pp, torch.as_tensor(x), mode="prefix", prefix=prefix)
    close(got, want)


@pytest.mark.parametrize("S,prefix", ((1, 1), (9, 4), (14, 8), (40, 33),
                                      (20, 25)))
def test_k7_prefix_route(S, prefix):
    """The kernel path's prefix route on K7's plain version against the
    reference's grouped einsum under its "prefix" mask, and against the
    plain prefix-mask attention the card holds the kernel to."""
    rng = np.random.default_rng(S * 10 + prefix)
    B, H, K, hd = 2, 8, 1, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, hd)).astype(np.float32)
            for _ in range(2))
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    bias = ref_layers._mask_bias("prefix", pos, pos, 0, prefix)
    want = ref_layers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), bias, POLICY)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = port_layers.k7_attention(tq, tk, tv, mode="prefix", prefix=prefix,
                                   impl="ref")
    close(got, want)
    views = [t.transpose(1, 2) for t in (tq, tk, tv)]
    close(prefix_attention(*views, prefix, impl="ref").transpose(1, 2), want)
    close(attention_prefix_ref(*views, prefix).transpose(1, 2), want)


def test_forward_covers_image_and_text_positions():
    cfg, ref, port = setup()
    b = batch(cfg, 1)
    want, hw, n_img = forward(cfg, POLICY, ref, to_jax(b))
    got, h = pm.forward(cfg, port, to_torch(b))
    assert n_img == cfg.num_image_tokens
    assert got.shape == (4, n_img + 10, cfg.vocab_size)
    close(got, want)
    close(h, hw)


def test_forward_loss_and_every_gradient():
    cfg, ref, port = setup()
    b = batch(cfg, 2)
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
    assert set(have) == set(want) and "img_proj" in have
    for k, v in want.items():
        np.testing.assert_allclose(have[k], v, err_msg=k, **GRAD_TOL)


def test_prefill_fills_every_cache_leaf():
    cfg, ref, port = setup()
    b = batch(cfg, 3)
    T = cfg.num_image_tokens + 10 + 4
    want_l, want_c = prefill(cfg, POLICY, ref, to_jax(b), max_seq=T)
    got_l, got_c = pm.prefill(cfg, port, to_torch(b), max_seq=T)
    close(got_l, want_l)
    assert set(got_c) == set(want_c) == {"k", "v", "slot_pos"}
    for k, v in got_c.items():
        assert tuple(v.shape) == want_c[k].shape, k
        if k == "slot_pos":
            np.testing.assert_array_equal(v.numpy(), np.asarray(want_c[k]))
        else:
            close(v, want_c[k])
    # the image positions are in the cache before the text
    assert got_c["slot_pos"][0, 0, cfg.num_image_tokens + 9] == \
        cfg.num_image_tokens + 9


def test_four_decode_steps():
    cfg, ref, port = setup()
    b = batch(cfg, 4)
    T = cfg.num_image_tokens + 10 + 4
    _, cr = prefill(cfg, POLICY, ref, to_jax(b), max_seq=T)
    _, cp = pm.prefill(cfg, port, to_torch(b), max_seq=T)
    pos = np.full(4, cfg.num_image_tokens + 10, np.int32)
    rng = np.random.default_rng(5)
    for _ in range(4):
        t = rng.integers(1, cfg.vocab_size, 4).astype(np.int32)
        lr, cr = decode_step(cfg, POLICY, ref, cr, jnp.asarray(t),
                             jnp.asarray(pos))
        lp, _ = pm.decode_step(cfg, port, cp, torch.as_tensor(t),
                               torch.as_tensor(pos))
        close(lp, lr)
        for k, v in cp.items():
            if k == "slot_pos":
                np.testing.assert_array_equal(v.numpy(), np.asarray(cr[k]))
            else:
                close(v, cr[k])
        pos = pos + 1


def test_decode_matches_forward():
    cfg, ref, port = setup()
    S, n_img = 8, cfg.num_image_tokens
    full = batch(cfg, 6, S=S + 1)
    full["tokens"][:] = np.abs(full["tokens"]) + 1  # no padding
    short = dict(full, tokens=full["tokens"][:, :S])
    _, cache = pm.prefill(cfg, port, to_torch(short), max_seq=n_img + S + 4)
    got, _ = pm.decode_step(cfg, port, cache,
                            torch.as_tensor(full["tokens"][:, S]),
                            torch.full((4,), n_img + S, dtype=torch.int32))
    logits, _ = pm.forward(cfg, port, to_torch(full))
    close(got, logits[:, n_img + S].detach().numpy(), **DECODE_TOL)
    want, _, _ = forward(cfg, POLICY, ref, to_jax(full))
    close(got, np.asarray(want)[:, n_img + S], **DECODE_TOL)


def test_train_steps_split_patches_into_microbatches():
    """Three steps at 2 microbatches: ``_split_batch`` splits the
    patches with the tokens, as the reference's does."""
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
        == 3_039_635_456
    tree = pm.build_params(cfg, lambda p, s, c: torch.empty(s,
                                                            device="meta"))
    assert tree["img_proj"].shape == (cfg.d_model, cfg.d_model)
    assert tree["blocks"]["attn"]["wk"].shape[-2:] == (1, 256)
