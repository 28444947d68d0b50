"""K8's log-sum-exp route on the CPU: the plain version
(``kernels/decode_attention/ref.py::decode_attention_ref(return_lse=
True)``), the model's grouped einsum with its log-sum-exp
(``models/layers.py::gqa_decode_lse``) and the combine of a cache's
sequence slices (``sharding/model.py::combine_partials``), as
``shard_cache_seq`` decodes: each slice [lo, lo + n) of T positions
attends with lengths clamp(pos + 1 - lo, 0, n).

Tolerances: lse within 1e-5 of ``torch.logsumexp`` of the plain scores
(float32, values of order 10), outputs within 1e-5 of the reference's
``decode_attention_ref`` and of the whole cache's attention; a row with
nothing live exactly 0 and -inf."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jax_decode_ref,
)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention,
)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.layers import gqa_decode_lse  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import ShardingPolicy  # noqa: E402

TOL = 1e-5
# (B, H, K, T, d): starcoder2's rank slice at a tiny width, group 1,
# whisper's and paligemma's groups
SHAPES = [(4, 12, 2, 33, 16), (3, 4, 4, 20, 8), (2, 8, 1, 29, 32)]


def inputs(B, H, K, T, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, d), (B, K, T, d), (B, K, T, d)))
    return q, k, v


def scores(q, k):
    """(B, H, T) scaled scores of the plain version, KV heads repeated."""
    G = q.shape[1] // k.shape[1]
    kk = torch.repeat_interleave(k, G, dim=1)
    return torch.einsum("bhd,bhtd->bht", q, kk) / np.sqrt(q.shape[-1])


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_is_the_logsumexp_of_the_plain_scores(shape):
    B, H, K, T, d = shape
    q, k, v = inputs(*shape)
    lengths = torch.tensor([T, 1, T // 2, 3][:B], dtype=torch.int32)
    out, lse = decode_attention(q, k, v, lengths, impl="ref",
                                return_lse=True)
    s = scores(q, k)
    live = torch.arange(T)[None, None] < lengths[:, None, None]
    want = torch.logsumexp(torch.where(live, s, -torch.inf), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(lse, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_decode_ref(q.numpy(), k.numpy(),
                                               v.numpy(), lengths.numpy())),
        atol=TOL, rtol=0)
    # the slot mask route: the same slots live
    sp = torch.where(live[:, 0], torch.arange(T)[None], -1).int()
    pos = (lengths - 1).int()
    o2, l2 = decode_attention(q, k, v, slot_pos=sp, pos=pos, impl="ref",
                              return_lse=True)
    torch.testing.assert_close(o2, out, atol=TOL, rtol=0)
    torch.testing.assert_close(l2, lse, atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_model_einsum_matches_the_plain_version(shape):
    """``gqa_decode_lse`` over a (B, T, K, d) cache and its live mask:
    K8's plain version's output and lse."""
    B, H, K, T, d = shape
    q, k, v = inputs(*shape, seed=1)
    lengths = torch.tensor([5, T, 0, 2][:B], dtype=torch.int32)
    ok = torch.arange(T)[None] < lengths[:, None]
    out, lse = gqa_decode_lse(q, k.transpose(1, 2), v.transpose(1, 2), ok)
    want, wlse = decode_attention(q, k, v, lengths, impl="ref",
                                  return_lse=True)
    torch.testing.assert_close(out, want, atol=TOL, rtol=0)
    torch.testing.assert_close(lse, wlse, atol=TOL, rtol=0)


def test_empty_row_gives_zero_and_minus_inf():
    q, k, v = inputs(3, 4, 2, 10, 8)
    lengths = torch.tensor([0, 4, 0], dtype=torch.int32)
    out, lse = decode_attention(q, k, v, lengths, impl="ref",
                                return_lse=True)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    for b in (0, 2):
        assert torch.equal(out[b], torch.zeros_like(out[b]))
        assert torch.isneginf(lse[b]).all()
    assert torch.isfinite(lse[1]).all()
    ok = torch.zeros(3, 10, dtype=torch.bool)
    o2, l2 = gqa_decode_lse(q, k.transpose(1, 2), v.transpose(1, 2), ok)
    assert torch.equal(o2, torch.zeros_like(o2)) and torch.isneginf(l2).all()


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_slices_combine_to_the_whole_cache(shape, tp):
    """The cache cut into tp slices of ceil(T / tp) (``seq_slice``; some
    rows' positions end before a slice, which then holds nothing live
    for them): each slice's output and lse merged by
    ``combine_partials`` in rank order is the whole cache's attention."""
    B, H, K, T, d = shape
    q, k, v = inputs(*shape, seed=2)
    pos = torch.tensor([T - 1, 0, T // 3, 7][:B])
    whole = decode_attention(q, k, v, (pos + 1).int(), impl="ref")
    g = sm.mesh_grid(ShardingPolicy.for_mesh(make_mesh(
        1, tp, devices=["cpu"] * tp)))
    outs, lses = sm._grid(g), sm._grid(g)
    for t in range(tp):
        lo, n = sm.seq_slice(T, tp, t)
        lengths = (pos + 1 - lo).clamp(0, n).int()
        outs[0, t], lses[0, t] = decode_attention(
            q, k[:, :, lo:lo + n], v[:, :, lo:lo + n], lengths, impl="ref",
            return_lse=True)
    got = sm.combine_partials(outs, lses, g)
    for t in range(tp):
        torch.testing.assert_close(got[0, t], whole, atol=TOL, rtol=0)
