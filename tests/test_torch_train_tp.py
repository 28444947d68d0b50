"""Training over the port's model-parallel mesh
(``build_train_step(policy=)``, ``forward_loss(policy=)``,
``sharding.model.sum_replicas``, the optimizer over ``Sharded`` leaves,
``CheckpointManager.restore(policy=, cfg=)``, ``launch/train --dp
--tp``) on meshes of repeated CPU devices, held to the reference's
sharded train step on forced host devices (one subprocess for the
module, ``tests/torch_train_tp_check.py``) on the reference's weights
and the same numpy-seeded tokens.

Tolerances: after three fp32 steps the losses within 1e-5 and every
parameter within 1e-4 of the reference's mesh run. Adam's first step
moves an element by about ±lr whatever its gradient, so an element
whose gradient is a few times ``eps`` moves by an amount that float32
noise in that gradient changes: compiled at XLA's default optimization
level the reference's own final parameters move by up to 6.1e-5 against
the same run at level 0 (float32 sums in another order; ``python
tests/torch_train_tp_check.py --levels``). The helper compiles at level
0 (also faster); each case prints how far the port lies from it. int8
moments: on identical gradients
the mesh's codes within one of one device's (a float32 moment on a
rounding boundary) and its scales within 1e-6 relative; over a whole
step the gradients are the mesh's own (float32 sums in another order;
the scales then lie 2.3e-6 and 4.3e-6 relative from one device's for m
and v), so the scales within 1e-5 relative."""
import contextlib
import io

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_train_tp_check as chk  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs import ARCHS, get_config  # noqa: E402
from repro.configs import get_tiny as ref_tiny  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro.sharding.policy import ShardingPolicy as RefPolicy  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import checkpoint as ref_ckpt  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.params import shard_params  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import ShardingPolicy  # noqa: E402
from repro_torch.training import CheckpointManager  # noqa: E402
from repro_torch.training import optimizer as port_opt  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    apply_updates,
    global_norm,
    init_state,
    leaves,
)
from repro_torch.training.train_step import (  # noqa: E402
    build_train_step,
    value_and_grad,
)

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
# device names of a mesh's positions: one name repeated (every part
# shared where it can be) or two names of the CPU (replicas copied, so
# their gradients are summed)
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


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module: the tests
    that need no reference (listed first) run while it compiles."""
    out = tmp_path_factory.mktemp("train_tp") / "ref.npz"
    proc = chk.start_reference(str(out))
    yield proc, out
    proc.kill()


@pytest.fixture(scope="module")
def ref(reference_run):
    proc, out = reference_run
    chk.finish_reference(proc, str(out))
    return dict(np.load(out))


@pytest.fixture(scope="module")
def weights():
    """The reference's tiny weights per arch, as numpy arrays."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = jax.tree.map(np.asarray, ref_init(
                ref_tiny(arch), jax.random.PRNGKey(0)))
        return pm.params_from_numpy(cache[arch], "cpu")
    return get


def policy(dp, tp, names=("cpu",), **kw):
    devs = [names[i % len(names)] for i in range(dp * tp)]
    return ShardingPolicy.for_mesh(make_mesh(dp, tp, devices=devs), **kw)


def train(cfg, params, pol, toks, steps=chk.STEPS, mb=1, remat=None,
          opt=AdamWConfig(lr=chk.LR)):
    """``steps`` steps on ``toks``; (losses, params, state)."""
    if pol is not None:
        params = shard_params(cfg, params, pol)
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, num_microbatches=mb, remat=remat,
                            policy=pol)
    losses = []
    for i in range(steps):
        params, state, m = step(params, state, {"tokens": toks})
        losses.append(float(m["loss"]))
        assert int(m["step"]) == i + 1
    return losses, params, state


def hold_to_ref(ref, case, losses, params):
    want = [float(ref[f"{case}/loss/{s}"]) for s in range(chk.STEPS)]
    np.testing.assert_allclose(losses, want, atol=LOSS_TOL, rtol=0)
    got = chk.flat(sm.unshard(params, "cpu"))
    assert {f"{case}/param/{k}" for k in got} == {
        k for k in ref if k.startswith(f"{case}/param/")}
    far = max(float(np.abs(v.numpy() - ref[f"{case}/param/{k}"]).max())
              for k, v in got.items())
    dl = max(abs(a - b) for a, b in zip(losses, want))
    print(f"{case}: max|dloss| {dl:.3g}, max|dparam| {far:.3g}")
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[f"{case}/param/{k}"],
                                   atol=PARAM_TOL, rtol=0, err_msg=k)


_RUNS: dict = {}


def run_case(weights, case, names=("cpu",), remat=None):
    """``train`` of ``chk.CASES[case]`` (each run once a module)."""
    key = (case, names, remat)
    if key not in _RUNS:
        arch, (dp, tp), kw, rep, rows, mb = chk.CASES[case]
        cfg = get_tiny(arch)
        pol = policy(dp, tp, names, **kw).replace(**rep)
        toks = torch.as_tensor(chk.batch(cfg.vocab_size, rows))
        _RUNS[key] = train(cfg, weights(arch), pol, toks, mb=mb,
                           remat=remat)
    return _RUNS[key]


def _i8_diff(one, mesh):
    """(largest code difference, largest relative scale difference) of
    two int8 moment trees (the mesh's unsharded)."""
    dq = ds = 0
    for (k, a), (_, b) in zip(leaves(one), leaves(mesh)):
        dq = max(dq, int((a["q"].int() - b["q"].int()).abs().max()))
        ds = max(ds, float(((a["s"] - b["s"]).abs() / a["s"]).max()))
    return dq, ds


@pytest.mark.parametrize("names", sorted(DEVICES))
def test_int8_blocks_are_global(weights, names):
    """qwen tiny at (2, 4): w_gate/w_in's 128-wide last axis is cut into
    32-wide parts, w_out's and wo's 64-wide one over the data ranks.
    Two int8 ``apply_updates`` on one device's gradients, laid out over
    the mesh: the mesh quantizes with the global blocks' scales."""
    arch = "qwen2.5-32b"
    cfg = get_tiny(arch)
    opt = AdamWConfig(lr=chk.LR, moment_dtype="int8")
    toks = torch.as_tensor(chk.batch(cfg.vocab_size, 4))
    one = weights(arch)
    _, grads = value_and_grad(cfg, one, {"tokens": toks})
    pol = policy(2, 4, DEVICES[names], shard_kv_heads=False)
    mesh = shard_params(cfg, weights(arch), pol)
    mgrads = _split_tree(grads, mesh)
    s1, s2 = init_state(one, opt), init_state(mesh, opt)
    for _ in range(2):
        apply_updates(one, grads, s1, opt)
        apply_updates(mesh, mgrads, s2, opt)
    s2 = sm.unshard(s2, "cpu")
    for mom in ("m", "v"):
        dq, ds = _i8_diff(s1[mom], s2[mom])
        print(f"int8 on one device's gradients, {names}, {mom}: codes "
              f"within {dq}, scales within {ds:.3g} relative")
        assert dq <= 1 and ds <= 1e-6, (mom, dq, ds)
    for (k, a), (_, b) in zip(leaves(one), leaves(sm.unshard(mesh, "cpu"))):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7,
                                   rtol=1e-6, err_msg=k)


def _split_tree(tree, like):
    if isinstance(tree, dict):
        return {k: _split_tree(v, like[k]) for k, v in tree.items()}
    return sm.split_like(tree, like)


def test_int8_train_step_over_the_mesh(weights):
    """One int8 train step at (2, 4) with replicated KV heads against
    one device's (only one: after it a moment that quantizes to 0
    moves a weight by m̂/eps, so later int8 steps part on any change of
    layout, on the reference too: ``torch_train_tp_check.py --drift``)."""
    arch = "qwen2.5-32b"
    cfg = get_tiny(arch)
    opt = AdamWConfig(lr=chk.LR, moment_dtype="int8")
    toks = torch.as_tensor(chk.batch(cfg.vocab_size, 4))
    l1, p1, s1 = train(cfg, weights(arch), None, toks, steps=1, opt=opt)
    l2, p2, s2 = train(cfg, weights(arch),
                       policy(2, 4, shard_kv_heads=False), toks, steps=1,
                       opt=opt)
    np.testing.assert_allclose(l2, l1, atol=LOSS_TOL, rtol=0)
    s2 = sm.unshard(s2, "cpu")
    for mom in ("m", "v"):
        dq, ds = _i8_diff(s1[mom], s2[mom])
        print(f"int8 step at (2, 4), {mom}: codes within {dq}, scales "
              f"within {ds:.3g} relative")
        assert dq <= 1 and ds <= 1e-5, (mom, dq, ds)
    for (k, a), (_, b) in zip(leaves(p1), leaves(sm.unshard(p2, "cpu"))):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=PARAM_TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("names", sorted(DEVICES))
def test_global_norm_counts_each_element_once(weights, names):
    """A tree with leaves replicated over every position (norms), over
    the tensor-parallel ranks (replicated KV heads) and split: the
    norm of its ``Sharded`` layout is the one-device norm."""
    cfg = get_tiny("qwen2.5-32b")
    one = weights("qwen2.5-32b")
    pol = policy(2, 4, DEVICES[names], shard_kv_heads=False)
    mesh = shard_params(cfg, one, pol)
    np.testing.assert_allclose(float(global_norm(mesh)),
                               float(global_norm(one)), rtol=1e-6)


STATE_POLICIES = ("single", "dp2_tp4", "ep_over_dp")


def _policies(variant):
    if variant == "single":
        return RefPolicy.single(), ShardingPolicy.single()
    ref = RefPolicy.for_mesh(AbstractMesh((2, 4), ("data", "model")))
    port = policy(2, 4)
    if variant == "ep_over_dp":
        ref, port = (p.replace(ep_over_dp=True) for p in (ref, port))
    return ref, port


ARCH_IDS = [a.replace("_", "-").replace("qwen2-5", "qwen2.5")
            .replace("hymba-1-5b", "hymba-1.5b") for a in ARCHS]


@pytest.mark.parametrize("variant", STATE_POLICIES)
@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_abstract_state_and_state_specs(variant, moments):
    """Every arch: ``abstract_state`` shapes and dtypes and
    ``state_specs`` entry for entry as the reference's."""
    rpol, ppol = _policies(variant)
    rcfg, pcfg = ref_opt.AdamWConfig(moment_dtype=moments), AdamWConfig(
        moment_dtype=moments)
    for arch in ARCH_IDS:
        ra = ref_opt.abstract_state(ref_params.abstract_params(
            get_config(arch)), rcfg)
        pa = port_opt.abstract_state(pm.abstract_params(port_config(arch)),
                                     pcfg)
        rs = ref_opt.state_specs(ref_params.param_specs(get_config(arch),
                                                        rpol), rcfg)
        ps = port_opt.state_specs(pm.param_specs(port_config(arch), ppol),
                                  pcfg)
        fa, fs = chk.flat(pa), chk.flat(ps)
        assert set(fa) == set(chk.flat(ra)) == set(fs), arch
        for k, r in chk.flat(ra).items():
            assert fa[k].device.type == "meta"
            assert tuple(fa[k].shape) == tuple(r.shape), (arch, k)
            assert str(fa[k].dtype).replace("torch.", "") == str(r.dtype)
        for k, r in chk.flat(rs).items():
            assert tuple(fs[k]) == tuple(r), (arch, k, fs[k], r)


def test_checkpoint_restores_under_another_mesh(tmp_path, weights):
    """A (2, 2) run's step-3 checkpoint (global arrays under the
    reference's keys): restored at (1, 4) and trained 2 more steps it
    ends where the (2, 2) run does; restored at (1, 1) and by the
    reference's ``CheckpointManager`` it is the (2, 2) tree."""
    arch = "qwen2.5-32b"
    cfg = get_tiny(arch)
    opt = AdamWConfig(lr=chk.LR)
    toks = torch.as_tensor(chk.batch(cfg.vocab_size, 4))
    pol = policy(2, 2, DEVICES["two_names"])
    params = shard_params(cfg, weights(arch), pol)
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, remat=None, policy=pol)
    for _ in range(3):
        params, state, m = step(params, state, {"tokens": toks})
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(3, {"params": params, "opt": state}, extra={"arch": 1})
    mgr.wait()
    want = chk.flat(sm.unshard({"params": params, "opt": state}, "cpu"))
    for _ in range(2):
        params, state, m = step(params, state, {"tokens": toks})
    cont = float(m["loss"])

    pol4 = policy(1, 4)
    tree, manifest = mgr.restore(policy=pol4, cfg=cfg)
    assert manifest["step"] == 3 and int(tree["opt"]["step"]) == 3
    assert isinstance(tree["params"]["embed"], sm.Sharded)
    assert tree["params"]["embed"].parts.shape == (1, 4)
    step4 = build_train_step(cfg, opt, remat=None, policy=pol4)
    p4, s4 = tree["params"], tree["opt"]
    for _ in range(2):
        p4, s4, m4 = step4(p4, s4, {"tokens": toks})
    assert abs(float(m4["loss"]) - cont) <= LOSS_TOL

    one, _ = mgr.restore(device="cpu")
    ref_tree, _ = ref_ckpt.CheckpointManager(tmp_path).restore(3)
    for k, v in want.items():
        assert torch.equal(chk.flat(one)[k], v), k
        np.testing.assert_array_equal(chk.flat(ref_tree)[k], v.numpy())
    # and under none: it trains on one device
    p1, s1 = one["params"], one["opt"]
    step1 = build_train_step(cfg, opt, remat=None)
    for _ in range(2):
        p1, s1, m1 = step1(p1, s1, {"tokens": toks})
    assert abs(float(m1["loss"]) - cont) <= LOSS_TOL


def test_reference_checkpoint_restores_over_the_mesh(tmp_path, weights):
    """The reference's checkpoint of its initial tree restores at
    (2, 2): the parameters are its arrays, the moments zero."""
    arch = "qwen2.5-32b"
    rp = ref_init(ref_tiny(arch), jax.random.PRNGKey(0))
    rs = ref_opt.init_state(rp, ref_opt.AdamWConfig())
    ref_ckpt.CheckpointManager(tmp_path).save(0, {"params": rp, "opt": rs})
    pol = policy(2, 2)
    tree, _ = CheckpointManager(tmp_path).restore(policy=pol,
                                                  cfg=get_tiny(arch))
    got = chk.flat(sm.unshard(tree, "cpu"))
    for k, v in chk.flat({"params": rp, "opt": rs}).items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)


def test_launch_train_resumes_under_another_mesh(tmp_path):
    """``launch/train --tiny --device cpu --dp 2 --tp 2`` killed after
    step 6 and resumed at ``--dp 1 --tp 4`` ends within 1e-5 of the
    uninterrupted (2, 2) run's loss."""
    common = ["--arch", "qwen2.5-32b", "--tiny", "--device", "cpu",
              "--steps", "9", "--batch", "4", "--seq", "16",
              "--ckpt-every", "3", "--log-every", "3"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        whole = train_launch.main(common + ["--dp", "2", "--tp", "2",
                                            "--ckpt-dir",
                                            str(tmp_path / "a")])
        with pytest.raises(SystemExit) as e:
            train_launch.main(common + ["--dp", "2", "--tp", "2",
                                        "--ckpt-dir", str(tmp_path / "b"),
                                        "--simulate-failure", "6"])
        assert e.value.code == 42
        resumed = train_launch.main(common + ["--dp", "1", "--tp", "4",
                                              "--ckpt-dir",
                                              str(tmp_path / "b")])
    assert "resumed from step 6" in out.getvalue()
    assert abs(resumed - whole) <= LOSS_TOL


TOKENS = {"tokens": torch.ones(4, 8, dtype=torch.int32)}


@pytest.mark.parametrize("arch", ["hymba-1.5b"])
def test_families_still_refused(arch):
    """Every family trains over a mesh, the hybrid at tp > 1 without
    ``dp_over_tp`` too (``test_torch_tp_hybrid.py``); the policy
    ``ep_over_dp`` with ``dp_over_tp`` is still refused, whatever the
    family."""
    bad = policy(2, 2).replace(dp_over_tp=True, ep_over_dp=True)
    with pytest.raises(sm.MeshNotPorted, match="ep_over_dp"):
        pm.forward_loss(get_tiny(arch), {}, TOKENS, policy=bad)


def test_layer_views_unbind_each_part_once(weights):
    """``Sharded.layers`` unbinds a stacked part once, so the backward
    stacks the L layers' gradients into it once; a view a layer would
    add a zero (L, ...) gradient a layer (2.2x one device's device time
    a step at (1, 2) on the card)."""
    cfg = get_tiny("qwen2.5-32b")
    sp = shard_params(cfg, weights("qwen2.5-32b"), policy(1, 2))
    w = sp["blocks"]["mlp"]["w_in"]
    w.parts[0, 0].requires_grad_(True)
    views = w.layers(cfg.num_layers)
    assert all(v.parts[0, 0].grad_fn.name() == "UnbindBackward0"
               for v in views)
    assert len({id(v.parts[0, 0]._base) for v in views}) == 1


# held to the reference's run: last, so that the tests above run while
# its subprocess compiles


@pytest.mark.parametrize("case", sorted(chk.CASES))
def test_train_step_matches_the_reference_mesh(ref, weights, case):
    losses, params, _ = run_case(weights, case)
    hold_to_ref(ref, case, losses, params)


def test_replicas_are_summed_and_stay_equal(ref, weights):
    """qwen tiny at (2, 4) with replicated KV heads on two device names:
    the norms, the KV heads that ranks share and every leaf the data
    ranks hold apart are summed over their holders; each slice's
    holders end bit for bit equal."""
    case = "qwen_2x4_kv_replicated"
    losses, params, state = run_case(weights, case, DEVICES["two_names"])
    hold_to_ref(ref, case, losses, params)
    summed = 0
    for tree in (params, state["m"], state["v"]):
        for _, leaf in leaves(tree):
            for _, holders in leaf.slices():
                parts = {id(leaf.parts[p]): leaf.parts[p] for p in holders}
                summed += len(parts) > 1
                first = leaf.parts[holders[0]]
                assert all(torch.equal(first, p) for p in parts.values())
    assert summed > 0


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_over_the_mesh(ref, weights, remat):
    """Each layer of the mesh recomputed in the backward (the FSDP
    gather inside it too): the reference's run, and the port's run
    without remat bit for bit."""
    case = "qwen_2x2"
    losses, params, _ = run_case(weights, case, remat=remat)
    hold_to_ref(ref, case, losses, params)
    plain_losses, plain, _ = run_case(weights, case)
    assert losses == plain_losses
    for (k, a), (_, b) in zip(leaves(sm.unshard(params, "cpu")),
                              leaves(sm.unshard(plain, "cpu"))):
        assert torch.equal(a, b), k
