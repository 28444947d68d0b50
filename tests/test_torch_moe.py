"""The port's mixture of experts (``repro_torch.models.layers``) against
the reference's on the same weights: ``moe_block`` held to the
reference's ``moe_block`` under ``ShardingPolicy.single()`` and
``moe_reference`` to the reference's dense oracle, for olmoe-tiny
without drops (capacity factor 8), olmoe-tiny at capacity factor 1.0
over 64 tokens, where experts drop rows (a different drop set would miss
the tolerance by O(1), so the kept (token, expert) set must be the
reference's, recomputed here in numpy from its arithmetic), and
deepseek-v3-tiny's ``moe`` subtree, which has a shared expert. The
reference's parameters come from ``repro.models.init_params`` and are
carried across with ``params_from_numpy``. Tolerance: 1e-4 absolute
and relative (float32 products summed in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, get_tiny  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models.layers import moe_block, moe_reference  # noqa: E402
from repro.sharding import ShardingPolicy  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402
from repro_torch.models.layers import moe_capacity, moe_route  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
POLICY = ShardingPolicy.single()
# (arch, capacity factor or None for the config's, (B, S), seed)
CASES = {"no_drops": ("olmoe-1b-7b", None, (2, 8), 3),
         "drops": ("olmoe-1b-7b", 1.0, (2, 32), 5),
         "shared_expert": ("deepseek-v3-671b", None, (1, 8), 4)}


def setup(case):
    """(port cfg, reference cfg, reference layer-0 ``moe`` params as
    numpy, port params, x (B, S, D) float32)."""
    arch, cf, shape, seed = CASES[case]
    ref_cfg, cfg = get_tiny(arch), port_tiny(arch)
    if cf is not None:
        ref_cfg = ref_cfg.replace(moe_capacity_factor=cf)
        cfg = cfg.replace(moe_capacity_factor=cf)
    params = init_params(ref_cfg, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["blocks"]["moe"])
    x = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, p, pm.params_from_numpy(p, "cpu"), x


def kept_numpy(x, router, cap: int, k: int) -> set:
    """The reference's kept (token, expert) pairs, from its arithmetic in
    numpy: float32 router logits, softmax, the k largest probabilities
    (ties to the lower expert, as ``lax.top_k``), then each expert keeps
    the first ``cap`` of its rows in (token, choice) order — the stable
    argsort of the flattened expert ids."""
    logits = x.astype(np.float32) @ router.astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    kept, seen = set(), {}
    for row in order:
        e = int(flat[row])
        if seen.get(e, 0) < cap:
            kept.add((int(row // k), e))
        seen[e] = seen.get(e, 0) + 1
    return kept


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_block_matches_reference(case):
    cfg, ref_cfg, p, port_p, x = setup(case)
    rp = jax.tree.map(jnp.asarray, p)
    want = np.asarray(moe_block(ref_cfg, POLICY, rp, jnp.asarray(x)))
    got = pm.moe_block(cfg, port_p, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = np.asarray(moe_reference(ref_cfg, rp, jnp.asarray(x)))
    np.testing.assert_allclose(
        pm.moe_reference(cfg, port_p, torch.as_tensor(x)).numpy(), dense,
        **TOL)
    if case == "shared_expert":
        assert "shared" in p
    if case != "drops":  # capacity covers every row: the dense mixture
        np.testing.assert_allclose(got.numpy(), dense, **TOL)


def test_capacity_drops_keep_the_reference_set():
    """At capacity factor 1.0 over 64 tokens some expert is routed more
    rows than it keeps: the port keeps exactly the reference's (token,
    expert) pairs, and the outputs differ from the dense oracle by O(1)
    where rows were dropped, so a different drop set could not pass."""
    cfg, ref_cfg, p, port_p, x = setup("drops")
    xt = x.reshape(-1, cfg.d_model)
    T, k = xt.shape[0], cfg.experts_per_tok
    cap = moe_capacity(cfg, T)
    assert cap == 16  # ceil(64 * 2 / 8 * 1.0)
    want = kept_numpy(xt, p["router"], cap, k)
    _, rows, valid, toks = moe_route(torch.as_tensor(xt),
                                     port_p["router"], cap, k)
    got = {(int(t), e) for e in range(cfg.num_experts)
           for t, ok in zip(toks[e].tolist(), valid[e].tolist()) if ok}
    assert got == want
    assert len(got) < T * k  # rows were dropped
    rows_kept = rows[valid]
    assert len(set(rows_kept.tolist())) == len(rows_kept)  # distinct
    y = pm.moe_block(cfg, port_p, torch.as_tensor(x)).numpy()
    dense = np.asarray(moe_reference(ref_cfg, jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x)))
    assert np.abs(y - dense).max() > 0.1


def test_capacity_at_the_served_shapes():
    """olmoe-1b-7b (64 experts, top 8, capacity factor 1.25): 320 rows an
    expert at a 16 x 128 admission, 3 at a 16-row decode step (so a
    decode round reads every expert); the formula is the reference's."""
    cfg = port_config("olmoe-1b-7b")
    assert (moe_capacity(cfg, 16 * 128), moe_capacity(cfg, 16)) == (320, 3)
    ref = get_config("olmoe-1b-7b")
    for n in (1, 7, 16, 2048):
        assert moe_capacity(cfg, n) == max(int(np.ceil(
            n * ref.experts_per_tok / ref.num_experts
            * ref.moe_capacity_factor)), 1)


def tie_router(kind: str, d: int, e: int) -> np.ndarray:
    """A router whose probabilities tie: ``"zero"`` ties all ``e``
    experts; ``"kth"`` (x positive, so expert e's logit is w_e·sum(x))
    ties the 2nd to 4th largest (experts 3, 4 and 5), so with k = 2 the
    tie straddles the k-th and (k+1)-th place."""
    if kind == "zero":
        return np.zeros((d, e), np.float32)
    w = np.array([0.1, 0.9, 0.1, 0.5, 0.5, 0.5, 0.2, 0.3], np.float32)
    return np.repeat(w[None, :e], d, axis=0) / np.float32(np.sqrt(d))


@pytest.mark.parametrize("cf", (None, 1.0), ids=("no_drops", "drops"))
@pytest.mark.parametrize("kind", ("zero", "kth"))
def test_moe_top_k_ties_go_to_the_lower_expert(kind, cf):
    """Tied router probabilities go to the lower expert index, as
    ``jax.lax.top_k`` sends them: the selected set, and at capacity
    factor 1.0 the rows each expert keeps, are the reference's.
    ``torch.topk`` may pick any tied index (on eight equal
    probabilities, k = 2, it gave experts 6 and 5), and then
    ``moe_block`` missed by O(1)."""
    cfg, ref_cfg, p, _, _ = setup("no_drops")
    if cf is not None:
        cfg = cfg.replace(moe_capacity_factor=cf)
        ref_cfg = ref_cfg.replace(moe_capacity_factor=cf)
    assert (cfg.num_experts, cfg.experts_per_tok) == (8, 2)
    p = dict(p, router=tie_router(kind, cfg.d_model, cfg.num_experts))
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    if kind == "kth":
        x = np.abs(x)
    rp = jax.tree.map(jnp.asarray, p)
    port_p = pm.params_from_numpy(p, "cpu")
    xt = torch.as_tensor(x)
    want = np.asarray(moe_block(ref_cfg, POLICY, rp, jnp.asarray(x)))
    np.testing.assert_allclose(pm.moe_block(cfg, port_p, xt).numpy(), want,
                               **TOL)
    dense = np.asarray(moe_reference(ref_cfg, rp, jnp.asarray(x)))
    np.testing.assert_allclose(pm.moe_reference(cfg, port_p, xt).numpy(),
                               dense, **TOL)
    T, k = 32, cfg.experts_per_tok
    cap = moe_capacity(cfg, T)
    _, _, valid, toks = moe_route(xt.reshape(T, -1), port_p["router"],
                                  cap, k)
    got = {(int(t), e) for e in range(cfg.num_experts)
           for t, ok in zip(toks[e].tolist(), valid[e].tolist()) if ok}
    assert got == kept_numpy(x.reshape(T, -1), p["router"], cap, k)
    first = {e for t, e in got if t == 0}
    assert first == ({0, 1} if kind == "zero" else {1, 3})
