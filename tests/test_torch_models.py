"""The port's LM (dense, MoE, SSM, hybrid and MLA/MTP) against the
reference's on the same weights: the reference's parameters
(``repro.models.init_params``) carried across with
``params_from_numpy``, the same token ids from a numpy seed, and
``prefill`` logits and every cache leaf (K/V, ``slot_pos`` in ring
layout, the SSM ``state`` and ``conv`` tail), ``decode_step`` and
decode-matches-forward compared, including a hybrid prefill longer
than its window, so that the ring wraps. Tolerance: 1e-4 absolute and
relative on float32 logits, K/V, the MLA latent and SSM state (the two
frameworks sum and round matrix products and the SSD's chunk sums in
different orders; logits here are O(1–10)); ``slot_pos`` exact. The
encoder-decoder and VLM families are held in their own files
(``test_torch_encdec.py``, ``test_torch_vlm.py``); here only the
token-only entry points' refusal of them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_tiny  # noqa: E402
from repro.models import (  # noqa: E402
    count_params,
    decode_step,
    forward,
    init_params,
    prefill,
)
from repro.sharding import ShardingPolicy  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import all_arch_ids  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402

DENSE = ("stablelm-3b", "starcoder2-3b", "qwen2.5-32b", "internlm2-20b")
ARCHS = DENSE + ("olmoe-1b-7b", "mamba2-370m", "hymba-1.5b",
                 "deepseek-v3-671b")
TOL = dict(atol=1e-4, rtol=1e-4)
POLICY = ShardingPolicy.single()
_CACHE: dict = {}


def setup(arch):
    """(cfg, reference params, port params) for ``arch``'s tiny config."""
    if arch not in _CACHE:
        cfg = get_tiny(arch)
        ref = init_params(cfg, jax.random.PRNGKey(0))
        port = pm.params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
        assert same_config(port_tiny(arch), cfg)
        _CACHE[arch] = (cfg, ref, port)
    return _CACHE[arch]


def same_config(a, b) -> bool:
    """Field-for-field equality of the port's and the reference's
    ``ModelConfig`` (two classes, so ``==`` is always False)."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def same_cache(got: dict, want: dict) -> None:
    """Every leaf: ``slot_pos`` exactly, the float leaves within TOL."""
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        if k == "slot_pos":
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
        else:
            close(v, want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_layout(arch):
    cfg, ref, port = setup(arch)
    assert pm.count_params(cfg) == count_params(cfg)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(jax.tree_util.tree_leaves(port))
    shapes = pm.build_params(cfg, lambda path, shape, scale: shape)
    for path, leaf in leaves:
        keys = [p.key for p in path]
        node, want = port, shapes
        for k in keys:
            node, want = node[k], want[k]
        assert tuple(node.shape) == leaf.shape == tuple(want), keys
        assert node.dtype == torch.float32
    gen = torch.Generator().manual_seed(0)
    rand = pm.init_params(cfg, gen, device="cpu")
    blocks = rand["blocks"]
    assert torch.equal(blocks["ln1"], torch.ones_like(blocks["ln1"]))
    if "attn" in blocks:
        w = blocks["attn"]["wq"]
        assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1) < 0.1
    if cfg.qkv_bias:
        assert not blocks["attn"]["bq"].any()
    if "ssm" in blocks:  # A = exp(A_log) in [1, 16], as the reference
        a = torch.exp(blocks["ssm"]["A_log"])
        assert float(a.min()) >= 1 and float(a.max()) <= 16
        assert not blocks["ssm"]["dt_bias"].any()
        w = blocks["ssm"]["w_in"]
        assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1) < 0.1
    assert ("mlp" in blocks) == (cfg.family in ("dense", "hybrid"))
    assert ("moe" in blocks) == (cfg.family == "moe")
    if "moe" in blocks:  # the router and experts at normal / sqrt(fan_in)
        for name, fan_in in (("router", cfg.d_model), ("w_in", cfg.d_model),
                             ("w_out", cfg.moe_d_ff)):
            w = blocks["moe"][name]
            assert abs(float(w.std()) * np.sqrt(fan_in) - 1) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch):
    cfg, ref, port = setup(arch)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 13)).astype(np.int32)
    lr, cr = prefill(cfg, POLICY, ref, {"tokens": jnp.asarray(toks)},
                     max_seq=17)
    lp, cp = pm.prefill(port_tiny(arch), port,
                        {"tokens": torch.as_tensor(toks)}, max_seq=17)
    close(lp, lr)
    same_cache(cp, cr)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(arch):
    cfg, ref, port = setup(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    _, cr = prefill(cfg, POLICY, ref, {"tokens": jnp.asarray(toks)},
                    max_seq=14)
    _, cp = pm.prefill(cfg, port, {"tokens": torch.as_tensor(toks)},
                       max_seq=14)
    nxt = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    pos = np.array([10, 3, 13], np.int32)  # append, overwrite, last slot
    ld, cr2 = decode_step(cfg, POLICY, ref, cr, jnp.asarray(nxt),
                          jnp.asarray(pos))
    lp, cp2 = pm.decode_step(cfg, port, cp, torch.as_tensor(nxt),
                             torch.as_tensor(pos))
    assert cp2 is cp  # updated in place
    close(lp, ld)
    same_cache(cp, cr2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill S tokens, decode the next three one at a time: each step's
    logits equal the full forward's at that position, in both packages."""
    cfg, ref, port = setup(arch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    S = 6
    full_r, _, _ = forward(cfg, POLICY, ref, {"tokens": jnp.asarray(toks)})
    full_p, _ = pm.forward(cfg, port, {"tokens": torch.as_tensor(toks)})
    close(full_p, full_r)
    _, cache = pm.prefill(cfg, port, {"tokens": torch.as_tensor(toks[:, :S])},
                          max_seq=toks.shape[1])
    for t in range(S, toks.shape[1]):
        lg, cache = pm.decode_step(
            cfg, port, cache, torch.as_tensor(toks[:, t]),
            torch.full((2,), t, dtype=torch.int32))
        close(lg, full_r[:, t])


@pytest.mark.parametrize("S,max_seq", [(20, 24), (16, 30), (40, 41)])
def test_hybrid_ring_wraps(S, max_seq):
    """A hybrid prefill longer than its window (tiny hymba: 16) keeps
    the last 16 positions at slot ``pos % 16``; decode steps past the
    wrap overwrite the ring. Every leaf and every step's logits equal
    the reference's."""
    cfg, ref, port = setup("hymba-1.5b")
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    lr, cr = prefill(cfg, POLICY, ref, {"tokens": jnp.asarray(toks)},
                     max_seq=max_seq)
    lp, cp = pm.prefill(cfg, port, {"tokens": torch.as_tensor(toks)},
                        max_seq=max_seq)
    assert cp["slot_pos"].shape[2] == min(max_seq, cfg.attn_window)
    close(lp, lr)
    same_cache(cp, cr)
    pos = np.array([S - 1, S // 2], np.int32)  # re-feed the last, rewind
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        ld, cr = decode_step(cfg, POLICY, ref, cr, jnp.asarray(nxt),
                             jnp.asarray(pos))
        lp, cp = pm.decode_step(cfg, port, cp, torch.as_tensor(nxt),
                                torch.as_tensor(pos))
        close(lp, ld)
        same_cache(cp, cr)
        pos = pos + 1


MULTIMODAL = ("whisper-small", "paligemma-3b")


def test_every_configuration_builds():
    """Every configuration of the repo builds in the port; the
    encoder-decoder and VLM families are held in
    ``test_torch_encdec.py`` and ``test_torch_vlm.py``."""
    assert set(all_arch_ids()) == set(ARCHS) | set(MULTIMODAL)
    for arch in all_arch_ids():
        for cfg in (port_config(arch), port_tiny(arch)):
            pm.check_supported(cfg)
            pm.build_cache_spec(cfg, 1, 4)


@pytest.mark.parametrize("arch", MULTIMODAL)
def test_token_only_entry_points_refuse_multimodal_families(arch):
    """``ServingEngine``, ``launch/serve`` and ``launch/train`` feed
    tokens only, as the reference's, which cannot run these families
    (its ``_prepare_inputs`` reads frames / patches): each refuses them
    with its own error before building any weights."""
    from repro_torch.launch import serve, train
    from repro_torch.serving import ServingEngine

    cfg = port_tiny(arch)
    want = "frames" if cfg.family == "encdec" else "patches"
    with pytest.raises(NotImplementedError, match=f"ServingEngine.*{want}"):
        ServingEngine(cfg, None, device="cpu")
    with pytest.raises(NotImplementedError, match=f"launch/serve.*{want}"):
        serve.main(["--arch", arch, "--tiny", "--device", "cpu",
                    "--prompts", "x"])
    with pytest.raises(NotImplementedError, match=f"launch/train.*{want}"):
        train.main(["--arch", arch, "--tiny", "--device", "cpu",
                    "--steps", "1"])


def test_full_configs_are_the_references():
    from repro.configs import get_config

    for arch in all_arch_ids():
        assert same_config(port_config(arch), get_config(arch))
        assert same_config(port_tiny(arch), get_tiny(arch))
    cfg = port_config("starcoder2-3b")
    assert pm.count_params(cfg) == count_params(cfg)
    assert cfg.param_count() == 3_180_515_328  # without the final norm
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim) == \
        (12, 128)
    cfg = port_config("olmoe-1b-7b")
    assert pm.count_params(cfg) == count_params(cfg) == 6_919_096_320
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim) == \
        (1, 128)
