"""The port's training tier (``repro_torch.models.forward_loss``,
``repro_torch.training``) against the reference's single-device one on
the same weights (``repro.models.init_params`` carried across with
``params_from_numpy``) and the same seeded numpy batches.

Tolerances: the loss within 1e-5 relative; gradients, train-step losses
and grad norms within rtol 1e-4, atol 1e-5 (the reference's remat
tolerance; float32 sums in other orders); the parameters after three
steps within the same, except at most 0.01% of their elements (the
count is reported; 0 to 1 element per case here), each still within
6 lr: Adam's first step moves an element by ±lr whatever its gradient,
so an element whose gradient is float noise can take the other sign;
``apply_updates``
on identical inputs within rtol 1e-6 (1e-5 with the clip active, whose
scale inherits the global norm's float32 sum order; parameters also
atol 1e-8, a few float32 ulps of a 1e-2 step, near zero; float32
moments also 1e-6 of the leaf's largest, an ulp of the addends where
they cancel), its int8 ``q`` equal except ±1
where the float32 moment lands on a rounding boundary (the count is
reported), its bf16 moments within one bf16 step (rtol 2^-7, and 1e-6
of the leaf's largest where the addends cancel);
``quantize_i8``/``dequantize_i8`` bit for bit. Checkpoints, the data
streams and the launchers are in ``test_torch_train_launch.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_tiny  # noqa: E402
from repro.models import forward_loss, init_params  # noqa: E402
from repro.sharding import ShardingPolicy  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training.train_step import build_train_step as ref_step  # noqa
import repro_torch.models as pm  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    apply_updates,
    build_train_step,
    dequantize_i8,
    init_state,
    quantize_i8,
)
from repro_torch.training.optimizer import leaves  # noqa: E402
from repro_torch.training.train_step import value_and_grad  # noqa: E402

POLICY = ShardingPolicy.single()
TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("stablelm-3b", "olmoe-1b-7b", "mamba2-370m", "hymba-1.5b",
         "deepseek-v3-671b")
_CACHE: dict = {}


def setup(arch):
    """(reference cfg, reference params as numpy)."""
    if arch not in _CACHE:
        cfg = get_tiny(arch)
        _CACHE[arch] = (cfg, jax.tree.map(
            np.asarray, init_params(cfg, jax.random.PRNGKey(0))))
    return _CACHE[arch]


def tokens(cfg, seed: int, shape=(4, 16)) -> np.ndarray:
    """Seeded ids in [1, vocab) with padding (id 0) at some row ends,
    which the loss weights out."""
    t = np.random.default_rng(seed).integers(1, cfg.vocab_size, shape)
    t[0, -3:] = 0
    return t.astype(np.int32)


def ref_leaves(tree) -> dict:
    """{dotted path: numpy} in the reference's leaf order."""
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def port_leaves(tree) -> dict:
    return {k: v.detach().numpy() for k, v in leaves(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    """The loss and the gradient of every leaf; every leaf gets a
    gradient through autograd except the SSM family's ``ln2``, which
    feeds nothing, where the reference's gradient is exactly zero."""
    cfg, p = setup(arch)
    toks = tokens(cfg, 1)
    loss, grads = jax.jit(jax.value_and_grad(lambda q: forward_loss(
        cfg, POLICY, q, {"tokens": jnp.asarray(toks)})))(
        jax.tree.map(jnp.asarray, p))
    port = pm.params_from_numpy(p, "cpu")
    flat = [v for _, v in leaves(port)]
    for v in flat:
        v.requires_grad_(True)
    got = pm.forward_loss(cfg, port, {"tokens": torch.as_tensor(toks)})
    raw = torch.autograd.grad(got, flat, allow_unused=True)
    missing = {k for (k, _), g in zip(leaves(port), raw) if g is None}
    want = ref_leaves(grads)
    assert missing == ({"blocks.ln2"} if arch == "mamba2-370m" else set())
    for k in missing:
        assert not want[k].any()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    _, g = value_and_grad(cfg, pm.params_from_numpy(p, "cpu"),
                          {"tokens": torch.as_tensor(toks)})
    have = port_leaves(g)
    assert list(have) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(have[k], v, err_msg=k, **TOL)


def op_counts(cfg, params, toks, remat) -> tuple[int, int]:
    """(matrix products ``mm``, other ops) the forward and backward of
    one ``value_and_grad`` call run."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = [0, 0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[func is not torch.ops.aten.mm.default] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        value_and_grad(cfg, params, {"tokens": toks}, remat)
    return tuple(counts)


@pytest.mark.parametrize("arch", ("stablelm-3b", "olmoe-1b-7b"))
def test_remat_recomputes_and_keeps_the_gradients(arch):
    """"full" recomputes every layer's forward in the backward, matrix
    products included; "dots" recomputes the layer but takes the
    unbatched products (``mm``) from what it saved; the gradients are
    the same bit for bit."""
    cfg, p = setup(arch)
    params = pm.params_from_numpy(p, "cpu")
    toks = torch.as_tensor(tokens(cfg, 2))
    mm, other = zip(*(op_counts(cfg, params, toks, r)
                      for r in (None, "dots", "full")))
    assert mm[2] > mm[1] == mm[0], mm
    assert other[2] > other[0] and other[1] > other[0], other
    grads = {r: port_leaves(value_and_grad(cfg, params, {"tokens": toks},
                                           r)[1]) for r in (None, "full",
                                                            "dots")}
    for k, v in grads[None].items():
        np.testing.assert_array_equal(grads["full"][k], v, err_msg=k)
        np.testing.assert_array_equal(grads["dots"][k], v, err_msg=k)
    with pytest.raises(ValueError, match="remat"):
        pm.forward_loss(cfg, params, {"tokens": toks}, remat="some")


@pytest.mark.parametrize("shape", [(7,), (4, 130), (2, 3, 257)])
def test_quantize_i8_bit_identical(shape):
    x = (np.random.default_rng(0).standard_normal(shape) * 3.0).astype(
        np.float32)
    q, s = ref_opt.quantize_i8(jnp.asarray(x))
    q2, s2 = quantize_i8(torch.as_tensor(x))
    assert q2.dtype == torch.int8 and q2.shape == x.shape
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s))
    x2 = dequantize_i8(q2, s2).numpy()
    np.testing.assert_array_equal(x2, np.asarray(ref_opt.dequantize_i8(q, s)))
    # abs-max blockwise: the error is at most half a quantum
    assert np.abs(x2 - x).max() <= np.abs(x).max() / 127 + 1e-6


def carry(tree):
    """A reference tree (params or optimizer state) as port tensors."""
    if isinstance(tree, dict):
        return {k: carry(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:  # a copy: the port updates in place
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.tensor(a)


def opt_tree(seed: int) -> dict:
    """Leaves of every rank the model has, last axes on and off the
    int8 block (128), keys not in sorted order (the global norm sums in
    sorted order)."""
    rng = np.random.default_rng(seed)
    shapes = {"z": (64, 300), "b": {"w": (8, 130), "a": (5,)},
              "e": (2, 3, 257), "c": (40, 128)}

    def make(v):
        if isinstance(v, dict):
            return {k: make(x) for k, x in v.items()}
        return rng.standard_normal(v).astype(np.float32) * 0.2

    return make(shapes)


@pytest.mark.parametrize("clip", ("unclipped", "clipped"))
@pytest.mark.parametrize("moment_dtype", ("fp32", "bf16", "int8"))
def test_apply_updates_matches_reference(moment_dtype, clip):
    """Two reference steps from zero state, carried across, then one
    step of each package on identical params, grads and state (bias
    correction at step 3). Unclipped (global norm below 1), the clip
    scale is exactly 1 in both and the parameters agree within rtol
    1e-6; clipped (norm ~6.6), the scale carries the norm's float32
    sum-order difference (~2.5e-7 relative), which an update over a
    small second moment (an int8 ``v`` quantised to 0) carries into the
    parameters, held within rtol 1e-5 and 1e-5 of the 1e-2 step."""
    p = opt_tree(4)
    opt = dict(lr=1e-2, moment_dtype=moment_dtype)
    g_scale = 0.2 if clip == "clipped" else 5e-3
    grads = [jax.tree.map(lambda a: a * g_scale, opt_tree(5 + i))
             for i in range(3)]
    rp = jax.tree.map(jnp.asarray, p)
    rs = ref_opt.init_state(rp, ref_opt.AdamWConfig(**opt))
    for g in grads[:2]:
        rp, rs, _ = ref_opt.apply_updates(
            rp, jax.tree.map(jnp.asarray, g), rs, ref_opt.AdamWConfig(**opt))
    pp, ps = carry(rp), carry(rs)
    rp, rs, gn = ref_opt.apply_updates(
        rp, jax.tree.map(jnp.asarray, grads[2]), rs,
        ref_opt.AdamWConfig(**opt))
    pp, ps, gn2 = apply_updates(pp, carry(grads[2]), ps, AdamWConfig(**opt))
    assert (float(gn) > 1.0) == (clip == "clipped")
    np.testing.assert_allclose(float(gn2), float(gn), rtol=1e-6)
    assert int(ps["step"]) == int(rs["step"]) == 3
    want = ref_leaves(rp)
    # atol: ~5 float32 ulps of a 1e-2 step; clipped, 1e-5 of the step
    tol = (dict(rtol=1e-6, atol=1e-8) if clip == "unclipped"
           else dict(rtol=1e-5, atol=1e-7))
    for k, v in port_leaves(pp).items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **tol)
    boundary = 0
    for name in ("m", "v"):
        want = ref_leaves(rs[name])
        got = {k: v for k, v in leaves(ps[name])}
        if moment_dtype == "int8":
            for k, m in got.items():
                d = m["q"].numpy().astype(int) - want[k + ".q"]
                assert np.abs(d).max() <= 1, k
                boundary += int((d != 0).sum())
                np.testing.assert_allclose(m["s"].numpy(), want[k + ".s"],
                                           rtol=1e-6, err_msg=k)
        elif moment_dtype == "bf16":  # one bf16 step, or cancellation
            for k, m in got.items():
                w = want[k].astype(np.float32)
                np.testing.assert_allclose(
                    m.float().numpy(), w, rtol=2.0 ** -7,
                    atol=1e-6 * np.abs(w).max(), err_msg=k)
                boundary += int((m.float().numpy() != w).sum())
        else:  # atol: where m·b1 and (1 - b1)·g cancel, an ulp of either
            for k, m in got.items():
                np.testing.assert_allclose(
                    m.numpy(), want[k], rtol=1e-6,
                    atol=1e-6 * np.abs(want[k]).max(), err_msg=k)
    total = sum(v.size for v in ref_leaves(rp).values())
    print(f"{moment_dtype} {clip}: {boundary} of {2 * total} moment "
          f"elements one step apart at a rounding boundary")
    assert boundary <= 2 * total * 1e-2


def test_int8_adam_tracks_fp32():
    """int8-moment AdamW converges like fp32 on a quadratic."""
    target = torch.tensor([1.0, -2.0, 3.0, 0.5] * 64)
    results = {}
    for mdt in ("fp32", "int8"):
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0, moment_dtype=mdt)
        params = {"w": torch.zeros_like(target)}
        state = init_state(params, cfg)
        for _ in range(300):
            g = {"w": 2 * (params["w"] - target)}
            params, state, _ = apply_updates(params, g, state, cfg)
        results[mdt] = float(torch.sum((params["w"] - target) ** 2))
    assert results["fp32"] < 1e-3
    assert results["int8"] < 1e-2  # quantisation noise tolerated


# (arch, microbatches, remat): every microbatch count and remat on the
# dense config, one of each family beside it
STEP_CASES = ([("stablelm-3b", mb, r) for mb in (1, 2, 4)
               for r in (None, "full", "dots")]
              + [("olmoe-1b-7b", 2, None), ("olmoe-1b-7b", 2, "dots"),
                 ("mamba2-370m", 2, "full"), ("hymba-1.5b", 4, None),
                 ("deepseek-v3-671b", 2, "full")])
_REF_RUNS: dict = {}


def ref_run(arch, mb):
    """Losses, grad norms and final params of three reference steps."""
    if (arch, mb) not in _REF_RUNS:
        cfg, p = setup(arch)
        opt = ref_opt.AdamWConfig(lr=1e-3)
        step = jax.jit(ref_step(cfg, POLICY, opt, num_microbatches=mb,
                                remat=None))
        rp = jax.tree.map(jnp.asarray, p)
        rs, metrics = ref_opt.init_state(rp, opt), []
        for i in range(3):
            rp, rs, m = step(rp, rs, {"tokens": jnp.asarray(
                tokens(cfg, 10 + i))})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        _REF_RUNS[arch, mb] = (metrics, ref_leaves(rp))
    return _REF_RUNS[arch, mb]


@pytest.mark.parametrize("arch,mb,remat", STEP_CASES)
def test_train_step_matches_reference(arch, mb, remat):
    cfg, p = setup(arch)
    want_metrics, want_params = ref_run(arch, mb)
    opt = AdamWConfig(lr=1e-3)
    params = pm.params_from_numpy(p, "cpu")
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, num_microbatches=mb, remat=remat)
    metrics = []
    for i in range(3):
        params, state, m = step(params, state, {"tokens": torch.as_tensor(
            tokens(cfg, 10 + i))})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        assert int(m["step"]) == i + 1
    np.testing.assert_allclose(metrics, want_metrics, **TOL)
    assert not params_require_grad(params)
    outside = total = 0
    for k, v in port_leaves(params).items():
        d = np.abs(v - want_params[k])
        outside += int((d > TOL["atol"] + TOL["rtol"]
                        * np.abs(want_params[k])).sum())
        total += v.size
        # Adam moves an element by about ±lr a step whatever its
        # gradient: no element may be further off than three flips
        assert d.max() <= 6 * opt.lr, k
    print(f"{arch} mb={mb} remat={remat}: {outside} of {total} parameter "
          f"elements outside rtol 1e-4, atol 1e-5")
    assert outside <= 1e-4 * total


def params_require_grad(params) -> bool:
    return any(v.requires_grad for _, v in leaves(params))


def test_microbatches_must_divide_the_batch():
    cfg, p = setup("stablelm-3b")
    params = pm.params_from_numpy(p, "cpu")
    step = build_train_step(cfg, AdamWConfig(), num_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, init_state(params, AdamWConfig()),
             {"tokens": torch.as_tensor(tokens(cfg, 1))})


def test_kernel_wrappers_refuse_autograd():
    """K7, K8 and K9 launch on raw pointers, so their outputs carry no
    ``grad_fn``: with grad mode on and an input that requires grad they
    raise before anything else (here, before the check that the tensor
    is on the card); under ``torch.no_grad()`` that check is reached."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_kernel,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_kernel,
    )
    from repro_torch.kernels.ssd.ssd import ssd_chunk_kernel

    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    kv = torch.zeros(1, 2, 4, 8)
    x = torch.zeros(1, 4, 2, 8, requires_grad=True)
    dt, A, B = torch.zeros(1, 4, 2), torch.zeros(2), torch.zeros(1, 4, 8)
    calls = (lambda: flash_attention_kernel(q, kv, kv),
             lambda: decode_attention_kernel(q[:, :, 0], kv, kv,
                                             torch.ones(1, dtype=torch.int32)),
             lambda: ssd_chunk_kernel(x, dt, A, B, B, chunk=4))
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad(), pytest.raises((RuntimeError, ValueError)) as e:
            call()
        assert "no backward" not in str(e.value)
