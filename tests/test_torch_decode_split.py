"""The arithmetic of K8's split over the cache (``csrc/decode_attention.cu``),
emulated in float32 torch on the CPU: each (row, KV head) cache is cut
into chunks of ``attention_cases.DECODE_CHUNK`` positions; a chunk with
live positions gives its group's partial softmax state (m, the max
score; l, the sum of exp(s - m); acc, the unnormalised P.V), a chunk
with none gives (-inf, 0) and adds nothing; the partials are combined in
chunk order (M = max m, L = sum l e^(m - M), o = sum acc e^(m - M) / L);
a row with nothing live gives the mean of V over all T, as the plain
version's softmax over T equal masked scores does.

The emulation lives here, beside nothing on the main path, and is held
to the reference: under lengths to its Pallas ``decode_attention_kernel``
in interpret mode (``block_k=32``, as ``tests/test_torch_attention.py``
runs it) and its ``decode_attention_ref``; under the slot mask to the
reference model's masked grouped einsum of ``attention_decode``. Cases:
unequal lengths, lengths at the chunk edges, rings whose live chunks
have all-dead chunks between them, a full 2048-slot ring, and rows with
nothing live. Tolerance 1e-5 absolute and relative, float32."""
import math

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
from repro.models import layers as ref_layers  # noqa: E402
from repro.sharding import ShardingPolicy  # noqa: E402
from repro_torch.kernels import attention_cases as AC  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
C = AC.DECODE_CHUNK


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def chunk_state(qg, kc, vc, scale):
    """One chunk's partial state for a group's queries qg (G, d) over its
    live rows kc/vc (n, d): (m, l, acc), or (-inf, 0, 0) for n = 0."""
    G, d = qg.shape
    if kc.shape[0] == 0:
        return (torch.full((G,), -math.inf), torch.zeros(G),
                torch.zeros(G, d))
    s = (qg @ kc.T) * scale
    m = s.max(dim=1).values
    p = torch.exp(s - m[:, None])
    return m, p.sum(dim=1), p @ vc


def combine(states):
    """The partial states combined in chunk order; None when no chunk
    has anything live."""
    live = [st for st in states if bool((st[1] > 0).all())]
    if not live:
        return None
    M = torch.stack([m for m, _, _ in live]).max(dim=0).values
    L = torch.zeros_like(M)
    acc = torch.zeros_like(live[0][2])
    for m, l, a in live:  # chunk order
        w = torch.exp(m - M)
        L = L + l * w
        acc = acc + a * w[:, None]
    return acc / L[:, None]


def split_decode(q, k, v, live, chunk=C):
    """K8's split-and-combine: q (B, H, d), k/v (B, K, T, d), live (B, T)
    bool, all float32 torch. Returns (B, H, d)."""
    B, H, d = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for b in range(B):
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G]
            states = []
            for t0 in range(0, T, chunk):
                t = torch.arange(t0, min(t0 + chunk, T))
                t = t[live[b, t]]
                states.append(chunk_state(qg, k[b, kh, t], v[b, kh, t],
                                          scale))
            o = combine(states)
            out[b, kh * G:(kh + 1) * G] = (v[b, kh].mean(dim=0)
                                           if o is None else o)
    return out


def lengths_live(lengths, T):
    return torch.arange(T)[None, :] < torch.as_tensor(lengths)[:, None]


def slots_live(sp, pos, window):
    sp, pos = torch.as_tensor(sp), torch.as_tensor(pos)[:, None]
    ok = (sp >= 0) & (sp <= pos)
    return ok & (pos - sp < window) if window > 0 else ok


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T", (131, 300))
@pytest.mark.parametrize("B,H,K,d", [
    (5, 4, 4, 16),    # group 1
    (5, 12, 1, 32),   # starcoder2-3b's group of 12
    (5, 10, 2, 64),   # hymba-1.5b's group of 5
])
def test_split_over_lengths_matches_pallas_kernel(B, H, K, d, T):
    """Unequal lengths at the chunk edges (C - 1, C, C + 1, 2C + 1, T)
    against the reference's Pallas kernel in interpret mode."""
    lens = AC.chunk_lengths(T)
    assert len(lens) == B
    rng = np.random.default_rng(T * 7 + H + d)
    q, k, v = normal(rng, B, H, d), normal(rng, B, K, T, d), \
        normal(rng, B, K, T, d)
    got = split_decode(*map(torch.as_tensor, (q, k, v)),
                       lengths_live(lens, T))
    lengths = jnp.asarray(np.asarray(lens, np.int32))
    close(got, ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          lengths, block_k=32, impl="interpret"))
    close(got, ref_decode_oracle(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), lengths))


def test_split_over_long_cache_matches_reference():
    """long_prefill's 4104-position lengths cache, 129 chunks, lengths
    at its chunk edges and its end."""
    T = AC.LONG_CACHE
    lens = [C + 1, 2049, T - 1, T]
    rng = np.random.default_rng(4104)
    q, k, v = normal(rng, 4, 10, 16), normal(rng, 4, 2, T, 16), \
        normal(rng, 4, 2, T, 16)
    got = split_decode(*map(torch.as_tensor, (q, k, v)),
                       lengths_live(lens, T))
    close(got, ref_decode_oracle(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 jnp.asarray(np.asarray(lens, np.int32))))


def reference_slot_attention(q, k, v, live):
    """The reference model's decode attention (``attention_decode``'s
    masked grouped einsum) over the live slots: q (B, H, d), k/v
    (B, T, K, d) numpy, live (B, T) bool."""
    bias = jnp.where(jnp.asarray(live), 0.0, -1e30)[:, None, :]
    return ref_layers.gqa_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v), bias,
        ShardingPolicy.single())[:, 0]


def slot_case(rows, pos, window, H, K, d, seed):
    B, T = len(rows), len(rows[0])
    rng = np.random.default_rng(seed)
    q, k, v = normal(rng, B, H, d), normal(rng, B, T, K, d), \
        normal(rng, B, T, K, d)
    live = slots_live(np.asarray(rows, np.int32), np.asarray(pos, np.int32),
                      window)
    got = split_decode(torch.as_tensor(q),
                       torch.as_tensor(k).permute(0, 2, 1, 3),
                       torch.as_tensor(v).permute(0, 2, 1, 3), live)
    return got, reference_slot_attention(q, k, v, live.numpy()), live


@pytest.mark.parametrize("H,K,d", [(4, 2, 16), (10, 2, 64)])
def test_split_over_gapped_ring_matches_reference_mask(H, K, d):
    """Rings whose live chunks have all-dead chunks between them (empty
    slots, positions above pos, positions too old for the window), and
    a row with one live slot."""
    rows, pos, W = AC.gapped_ring()
    got, want, live = slot_case(rows, pos, W, H, K, d, seed=W + d)
    chunks = live.reshape(len(rows), -1, C).any(dim=2)
    assert (~chunks[:, 1:-1]).any() and chunks.any(dim=1).all()
    close(got, want)


def test_split_over_full_ring_matches_reference_mask():
    """long_prefill's 2048-slot ring with every slot live: 64 chunks."""
    sp, pos = AC.full_ring()
    got, want, live = slot_case([sp], [pos], AC.FULL_RING, 10, 2, 16,
                                seed=2048)
    assert bool(live.all())
    close(got, want)


@pytest.mark.parametrize("T", (C - 1, 3 * C + 5))
def test_split_with_nothing_live_is_the_mean_of_v(T):
    """A length of 0 and a row with no live slot: the mean of V over all
    T positions, as the reference's plain version gives (the Pallas
    kernel averages over its padded cache instead)."""
    rng = np.random.default_rng(T)
    q, k, v = normal(rng, 2, 4, 8), normal(rng, 2, 2, T, 8), \
        normal(rng, 2, 2, T, 8)
    lens = [0, T]
    got = split_decode(*map(torch.as_tensor, (q, k, v)),
                       lengths_live(lens, T))
    close(got, ref_decode_oracle(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 jnp.asarray(np.asarray(lens, np.int32))))
    close(got[0], np.repeat(v.mean(axis=2), 2, axis=1)[0])
    empty = np.full((2, T), -1, np.int32)
    got0 = split_decode(*map(torch.as_tensor, (q, k, v)),
                        slots_live(empty, np.asarray([5, 5]), 0))
    close(got0, np.repeat(v.mean(axis=2), 2, axis=1))


def test_empty_chunk_state_adds_nothing():
    """A chunk with nothing live is (-inf, 0, 0), and combining it with
    live chunks in any position leaves their result as it was."""
    rng = np.random.default_rng(1)
    qg = torch.as_tensor(normal(rng, 3, 8))
    kc, vc = torch.as_tensor(normal(rng, 5, 8)), torch.as_tensor(
        normal(rng, 5, 8))
    m, l, acc = chunk_state(qg, kc[:0], vc[:0], 0.5)
    assert bool(torch.isinf(m).all()) and not bool(l.any()) \
        and not bool(acc.any())
    a = chunk_state(qg, kc[:2], vc[:2], 0.5)
    b = chunk_state(qg, kc[2:], vc[2:], 0.5)
    empty = (m, l, acc)
    want = combine([a, b])
    for states in ([empty, a, b], [a, empty, b], [a, b, empty]):
        torch.testing.assert_close(combine(states), want, atol=0, rtol=0)
    assert combine([empty, empty]) is None
