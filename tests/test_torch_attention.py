"""K7/K8 plain versions of the port against the reference: the port's
``attention_ref``/``decode_attention_ref`` against the reference's
``attention_ref``, its Pallas ``flash_attention``/``decode_attention``
in interpret mode and its ``decode_attention_ref``, on inputs made from
a numpy seed. GQA groups 1, 2 and 4, sequence lengths that are not a
block multiple, rows of unequal cache length. Tolerance: 1e-5 absolute
and relative, float32 (the sums over <= 200 keys differ only in order).

The hybrid's additions: K7's plain version with a sliding window and
K8's with the reference's slot mask over a wrapped ring, against the
reference model's grouped einsum with its ``_mask_bias`` window bound
and its ``attention_decode`` mask (``repro.models.layers``).

Length 0: the port's kernel and plain version both follow the plain
softmax over T equal masked scores (the mean of V); the Pallas kernel
averages over its padded cache instead. The serving path never passes
0 (``lengths = pos + 1``).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here ``impl="kernel"`` on a CPU tensor must raise."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as ref_decode,
)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as ref_decode_oracle,
)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as ref_flash,
)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as ref_oracle,
)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
)
from repro.models import layers as ref_layers  # noqa: E402
from repro.sharding import ShardingPolicy  # noqa: E402
from repro_torch.kernels import attention_cases as AC  # noqa: E402
from repro_torch.models.layers import _mask_bias, gqa_attention  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("B,H,K,S,d", [
    (1, 4, 4, 50, 16),    # group 1
    (2, 4, 2, 33, 32),    # group 2, S not a block multiple
    (1, 8, 2, 70, 16),    # group 4
    (1, 2, 1, 1, 8),      # one query
])
def test_attention_ref_matches_reference(B, H, K, S, d, causal):
    rng = np.random.default_rng(S * 7 + d)
    q, k, v = normal(rng, B, H, S, d), normal(rng, B, K, S, d), \
        normal(rng, B, K, S, d)
    got = attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), causal=causal)
    close(got, ref_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal))
    assert torch.equal(got, flash_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        causal=causal))  # impl="auto" on the CPU is the plain version
    if causal:
        pallas = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, block_q=32, block_k=32,
                           impl="interpret")
        close(got, pallas)


@pytest.mark.parametrize("B,H,K,T,d", [
    (4, 4, 4, 40, 16),    # group 1
    (4, 4, 2, 131, 32),   # group 2, T not a block multiple
    (3, 8, 2, 65, 16),    # group 4
])
def test_decode_ref_matches_reference(B, H, K, T, d):
    rng = np.random.default_rng(T + d)
    q, k, v = normal(rng, B, H, d), normal(rng, B, K, T, d), \
        normal(rng, B, K, T, d)
    lengths = np.array([1, 2, T - 1, T][:B], np.int32)  # unequal rows
    got = decode_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), torch.as_tensor(lengths))
    close(got, ref_decode_oracle(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lengths)))
    close(got, ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(lengths), block_k=32,
                          impl="interpret"))
    assert torch.equal(got, decode_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(lengths)))


def test_decode_length_zero_is_the_mean_of_v():
    rng = np.random.default_rng(5)
    q, k, v = normal(rng, 2, 4, 8), normal(rng, 2, 2, 10, 8), \
        normal(rng, 2, 2, 10, 8)
    lengths = np.array([0, 3], np.int32)
    got = decode_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), torch.as_tensor(lengths))
    close(got, ref_decode_oracle(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lengths)))
    mean_v = np.repeat(v.mean(axis=2), 2, axis=1)[0]
    np.testing.assert_allclose(got[0].numpy(), mean_v, **TOL)


def test_masked_tail_has_no_influence():
    rng = np.random.default_rng(6)
    q, k, v = normal(rng, 1, 4, 16), normal(rng, 1, 2, 64, 16), \
        normal(rng, 1, 2, 64, 16)
    lengths = torch.tensor([40], dtype=torch.int32)
    a = decode_attention_ref(*map(torch.as_tensor, (q, k, v)), lengths)
    k[:, :, 40:], v[:, :, 40:] = 99.0, -99.0
    b = decode_attention_ref(*map(torch.as_tensor, (q, k, v)), lengths)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_strided_model_layout_matches_grouped_einsum():
    """The model's (B, S, H, d) projections as transposed views through
    the kernel's plain version equal the reference-shaped grouped einsum
    with its causal mask — the two prefill paths of attention_block."""
    rng = np.random.default_rng(7)
    B, S, H, K, d = 2, 37, 6, 2, 16
    q = torch.as_tensor(normal(rng, B, S, H, d))
    k = torch.as_tensor(normal(rng, B, S, K, d))
    v = torch.as_tensor(normal(rng, B, S, K, d))
    pos = torch.arange(S)[None].expand(B, S)
    want = gqa_attention(q, k, v, _mask_bias(pos, pos))
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True,
                          impl="ref").transpose(1, 2)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("which", ("flash", "decode"))
def test_kernel_impl_raises_on_cpu(which):
    q = torch.zeros(1, 2, 4, 8)
    k = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        if which == "flash":
            flash_attention(q, k, k, impl="kernel")
        else:
            decode_attention(q[:, :, 0], k, k,
                             torch.ones(1, dtype=torch.int32),
                             impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        flash_attention(q, k, k, impl="host")


@pytest.mark.parametrize("window", (1, 5, 17, 64))
@pytest.mark.parametrize("B,H,K,S,d", [(1, 4, 4, 50, 16),
                                       (2, 6, 2, 70, 32)])
def test_window_ref_matches_reference_mask(B, H, K, S, d, window):
    """K7's plain version with ``window`` equals the reference model's
    grouped einsum under ``_mask_bias("causal", ..., window)``, and the
    port's own model-side bias; the (B, S, H, d) layout goes in as
    transposed views, as ``attention_block`` passes it."""
    rng = np.random.default_rng(window * 10 + S)
    q, k, v = normal(rng, B, S, H, d), normal(rng, B, S, K, d), \
        normal(rng, B, S, K, d)
    pos = np.tile(np.arange(S)[None], (B, 1))
    want = ref_layers.gqa_attention(
        *map(jnp.asarray, (q, k, v)),
        ref_layers._mask_bias("causal", jnp.asarray(pos), jnp.asarray(pos),
                              window, 0), ShardingPolicy.single())
    qt, kt, vt = (torch.as_tensor(a).transpose(1, 2) for a in (q, k, v))
    got = flash_attention(qt, kt, vt, causal=True, window=window,
                          impl="ref").transpose(1, 2)
    close(got, want)
    tp = torch.as_tensor(pos)
    torch.testing.assert_close(
        got, gqa_attention(*map(torch.as_tensor, (q, k, v)),
                           _mask_bias(tp, tp, window)), **TOL)


@pytest.mark.parametrize("W", AC.RING_WINDOWS)
def test_slot_mask_ref_matches_reference_decode_mask(W):
    """K8's plain version over a wrapped ring (``attention_cases``'
    rows: slot entries above pos, entries too old for the window, empty
    slots) equals the reference model's masked grouped einsum of
    ``attention_decode``; every row keeps its own slot live."""
    rows = AC.ring_rows(W)
    sp = np.asarray(AC.ring_slot_pos(W, rows), np.int32)
    pos = np.asarray([p for _, p in rows], np.int32)
    B, H, K, d = len(rows), 4, 2, 16
    rng = np.random.default_rng(W)
    q, k, v = normal(rng, B, H, d), normal(rng, B, W, K, d), \
        normal(rng, B, W, K, d)
    ok = (sp >= 0) & (sp <= pos[:, None]) & (pos[:, None] - sp < W)
    assert ok[np.arange(B), pos % W].all()
    assert (ok.sum(1) < W).any() and (sp > pos[:, None]).any()
    bias = jnp.where(jnp.asarray(ok), 0.0, -1e30)[:, None, :]
    want = ref_layers.gqa_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v), bias,
        ShardingPolicy.single())[:, 0]
    kt, vt = (torch.as_tensor(a).permute(0, 2, 1, 3) for a in (k, v))
    got = decode_attention(torch.as_tensor(q), kt, vt,
                           slot_pos=torch.as_tensor(sp),
                           pos=torch.as_tensor(pos), window=W)
    close(got, want)
    # the length form is the slot form on an in-order cache whose slot t
    # holds position t up to pos (the dense model's invariant)
    pos_in = np.minimum(pos, W - 1)
    flat = np.where(np.arange(W)[None] <= pos_in[:, None],
                    np.arange(W)[None], -1).astype(np.int32)
    torch.testing.assert_close(
        decode_attention(torch.as_tensor(q), kt, vt,
                         torch.as_tensor(pos_in + 1)),
        decode_attention(torch.as_tensor(q), kt, vt,
                         slot_pos=torch.as_tensor(flat),
                         pos=torch.as_tensor(pos_in)), **TOL)
