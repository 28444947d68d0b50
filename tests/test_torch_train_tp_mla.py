"""MLA and the MTP loss trained over the port's model mesh
(``forward_loss(policy=)`` with ``_mtp_loss_mesh``,
``build_train_step(policy=)``, the optimizer over ``Sharded`` leaves,
``CheckpointManager.restore(policy=, cfg=)``, ``launch/train --dp
--tp`` for deepseek) on meshes of repeated CPU devices: the loss held
to the reference's jitted mesh ``forward_loss`` on forced host devices
(one subprocess for the module, ``tests/torch_tp_mla_check.py
train``), the steps to the port's own one-device run.

Tolerances: losses within 1e-5 (of the reference's mesh loss, and of
one device's after each of three fp32 steps), every parameter within
1e-4 of one device's, as ``tests/test_torch_train_tp.py`` holds
them."""
import contextlib
import io

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_families_check as fam  # noqa: E402
import torch_tp_mla_check as chk  # noqa: E402
from repro.configs import get_tiny as ref_tiny  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
import repro_torch.models as pm  # noqa: E402
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.params import shard_params  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import ShardingPolicy  # noqa: E402
from repro_torch.training import CheckpointManager  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    init_state,
    leaves,
)
from repro_torch.training.train_step import build_train_step  # noqa: E402

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STEPS = 3
LR = 1e-3
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
    out = tmp_path_factory.mktemp("train_tp_mla") / "ref.npz"
    proc = chk.start_reference("train", str(out))
    yield proc, out
    proc.kill()


@pytest.fixture(scope="module")
def ref(reference_run):
    proc, out = reference_run
    chk.finish_reference(proc, str(out))
    return dict(np.load(out))


_WEIGHTS: dict = {}


def weights(case):
    """The reference's tiny weights of a loss case's configuration, as
    port tensors (a fresh tree each call: training updates it)."""
    cfg = chk.loss_config(ref_tiny, case)
    if case not in _WEIGHTS:
        _WEIGHTS[case] = jax.tree.map(np.asarray, ref_init(
            cfg, jax.random.PRNGKey(0)))
    return pm.params_from_numpy(_WEIGHTS[case], "cpu")


def policy(dp, tp, names=("cpu",), **kw):
    devs = [names[i % len(names)] for i in range(dp * tp)]
    return ShardingPolicy.for_mesh(make_mesh(dp, tp, devices=devs), **kw)


def case_setup(case, names=("cpu",)):
    _, (dp, tp), kw, _ = chk.LOSS_CASES[case]
    cfg = chk.loss_config(get_tiny, case)
    batch = {k: torch.as_tensor(v) for k, v in fam.cfg_batch(
        cfg, chk.LOSS_ROWS, fam.SEQ, seed=1).items()}
    return cfg, policy(dp, tp, names, **kw), batch


def train(cfg, params, pol, batch, steps=STEPS):
    """``steps`` fp32 steps on ``batch``; (losses, params, state)."""
    opt = AdamWConfig(lr=LR)
    if pol is not None:
        params = shard_params(cfg, params, pol)
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, remat=None, policy=pol)
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return losses, params, state


def hold_params(mesh, one):
    for (k, a), (_, b) in zip(leaves(one), leaves(sm.unshard(mesh, "cpu"))):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=k)


# --- no reference needed: these run while its subprocess compiles ---


@pytest.mark.parametrize("names", sorted(DEVICES))
@pytest.mark.parametrize("case", sorted(chk.LOSS_CASES))
def test_train_steps_match_one_device(case, names):
    """Three fp32 steps of MLA with its MTP loss (deepseek-tiny at
    (2, 2) and (1, 2)) and of qwen-tiny with an MTP block at (2, 4)
    with replicated KV heads: the losses and every parameter against
    one device's."""
    cfg, pol, batch = case_setup(case, DEVICES[names])
    lm, pmesh, _ = train(cfg, weights(case), pol, batch)
    lo, pone, _ = train(cfg, weights(case), None, batch)
    np.testing.assert_allclose(lm, lo, atol=LOSS_TOL, rtol=0)
    hold_params(pmesh, pone)


def test_mtp_loss_adds_to_the_mesh_loss():
    """deepseek-tiny at (2, 2): the mesh loss is the main loss plus 0.3
    times the MTP block's, each as one device computes it (the MTP
    block's gradients reach its parts)."""
    case = "deepseek_2x2"
    cfg, pol, batch = case_setup(case)
    p = weights(case)
    sp = shard_params(cfg, p, pol)
    whole = pm.forward_loss(cfg, sp, batch, policy=pol)
    main = pm.forward_loss(cfg.replace(mtp_depth=0), sp, batch, policy=pol)
    one_main = pm.forward_loss(cfg.replace(mtp_depth=0), p, batch)
    assert abs(float(main) - float(one_main)) <= LOSS_TOL
    assert abs(float(whole) - float(pm.forward_loss(cfg, p, batch))) \
        <= LOSS_TOL
    assert float(whole - main) > 0.1
    for _, part in sp["mtp"]["proj"].distinct():
        part.requires_grad_(True)
    pm.forward_loss(cfg, sp, batch, policy=pol).backward()
    for _, part in sp["mtp"]["proj"].distinct():
        assert part.grad is not None and float(part.grad.abs().max()) > 0


def test_checkpoint_restores_under_another_mesh(tmp_path):
    """deepseek-tiny with its MTP block: a (2, 2) run's step-3
    checkpoint restored at (1, 4) and trained 2 more steps ends where
    the (2, 2) run does."""
    case = "deepseek_2x2"
    cfg, pol, batch = case_setup(case)
    opt = AdamWConfig(lr=LR)
    params = shard_params(cfg, weights(case), pol)
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, remat=None, policy=pol)
    for _ in range(3):
        params, state, m = step(params, state, batch)
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, {"params": params, "opt": state})
    for _ in range(2):
        params, state, m = step(params, state, batch)
    pol4 = policy(1, 4)
    tree, manifest = mgr.restore(policy=pol4, cfg=cfg)
    assert manifest["step"] == 3
    assert tree["params"]["mtp"]["proj"].parts.shape == (1, 4)
    step4 = build_train_step(cfg, opt, remat=None, policy=pol4)
    p4, s4 = tree["params"], tree["opt"]
    for _ in range(2):
        p4, s4, m4 = step4(p4, s4, batch)
    assert abs(float(m4["loss"]) - float(m["loss"])) <= LOSS_TOL


def test_launch_train_mla_over_the_mesh():
    """``launch/train --arch deepseek-v3-671b --tiny --device cpu --dp 2
    --tp 2`` ends within 1e-5 of the same run on one device."""
    common = ["--arch", "deepseek-v3-671b", "--tiny", "--device", "cpu",
              "--steps", "3", "--batch", "4", "--seq", "16",
              "--log-every", "3"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mesh = train_launch.main(common + ["--dp", "2", "--tp", "2"])
        one = train_launch.main(common)
    assert abs(mesh - one) <= LOSS_TOL


# --- held to the reference's run: last, so that the tests above run
# while its subprocess compiles ---


@pytest.mark.parametrize("case", sorted(chk.LOSS_CASES))
def test_forward_loss_matches_the_reference_mesh(ref, case):
    """The mesh ``forward_loss`` (the MTP loss included) against the
    reference's jitted one under the same mesh."""
    cfg, pol, batch = case_setup(case)
    got = pm.forward_loss(cfg, shard_params(cfg, weights(case), pol),
                          batch, policy=pol)
    assert abs(float(got) - float(ref[f"{case}/loss"])) <= LOSS_TOL
