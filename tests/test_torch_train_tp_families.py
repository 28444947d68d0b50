"""Training of the SSM, hybrid, encoder-decoder and VLM families over
the port's model mesh (``build_train_step(policy=)`` with frames and
patches split into microbatches with their rows,
``forward_loss(policy=)``'s ``_prepare_mesh`` and ``_encode_mesh``, the
VLM's loss over its text positions, ``dp_over_tp``,
``CheckpointManager.restore(policy=, cfg=)`` of their leaves,
``launch/train --dp --tp`` for mamba2 and hymba) on meshes of repeated
CPU devices, held to the reference's jitted train step on forced host
devices (one subprocess for the module, ``tests/torch_tp_families_check.py
train``) on the reference's weights and the same numpy-seeded batches.

Tolerances: after three fp32 steps the losses within 1e-5 and the
parameters within 1e-4 of the reference's mesh run (compiled at XLA's
level 0), as ``tests/test_torch_train_tp.py`` holds its cases, except
at most 0.01% of the elements, each still within 6 lr, as
``tests/test_torch_training.py`` holds one device to the reference:
Adam's first step moves an element by about ±lr whatever its gradient,
so an element whose gradient is a few times ``eps`` moves by an amount
that float32 noise in that gradient changes (hymba's ``ssm.w_in`` has
one, of gradient -3.2e-8 at the first step, where the port's mesh and
its one device both lie about 1.1e-4 from the reference's mesh; the
count is printed)."""
import contextlib
import io

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_families_check as chk  # noqa: E402
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
)
from repro_torch.training.train_step import build_train_step  # noqa: E402

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
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
    out = tmp_path_factory.mktemp("train_tp_families") / "ref.npz"
    proc = chk.start_reference("train", str(out))
    yield proc, out
    proc.kill()


@pytest.fixture(scope="module")
def ref(reference_run):
    proc, out = reference_run
    chk.finish_reference(proc, str(out))
    return dict(np.load(out))


_WEIGHTS: dict = {}


def weights(arch):
    """The reference's tiny weights of ``arch``, as fresh port
    tensors (training updates them in place)."""
    if arch not in _WEIGHTS:
        _WEIGHTS[arch] = jax.tree.map(np.asarray, ref_init(
            ref_tiny(arch), jax.random.PRNGKey(0)))
    return pm.params_from_numpy(_WEIGHTS[arch], "cpu")


def policy(dp, tp, names=("cpu",), kw=None, rep=None):
    devs = [names[i % len(names)] for i in range(dp * tp)]
    return ShardingPolicy.for_mesh(make_mesh(dp, tp, devices=devs),
                                   **(kw or {})).replace(**(rep or {}))


def train(cfg, params, pol, batch, mb=1, steps=chk.STEPS, remat=None):
    """``steps`` fp32 steps on ``batch``; (losses, params, state)."""
    opt = AdamWConfig(lr=chk.LR)
    if pol is not None:
        params = shard_params(cfg, params, pol)
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, num_microbatches=mb, remat=remat,
                            policy=pol)
    losses = []
    for i in range(steps):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        assert int(m["step"]) == i + 1
    return losses, params, state


def case_run(case, names=("cpu",), remat=None):
    arch, (dp, tp), kw, rep, rows, mb = chk.TRAIN_CASES[case]
    cfg = get_tiny(arch)
    batch = {k: torch.as_tensor(v)
             for k, v in chk.cfg_batch(cfg, rows, chk.SEQ, seed=1).items()}
    return cfg, batch, mb, train(cfg, weights(arch),
                                 policy(dp, tp, names, kw, rep), batch, mb,
                                 remat=remat)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


# --- no reference needed: these run while its subprocess compiles ---


@pytest.mark.parametrize("case", ["mamba2_2x2", "paligemma_1x2"])
def test_mesh_training_matches_one_device(case):
    """Three steps over the mesh against the port's own one device
    (these layouts give one device's function): losses within 1e-5,
    parameters within 1e-4."""
    cfg, batch, mb, (losses, params, _) = case_run(case)
    one, p1, _ = train(cfg, weights(chk.TRAIN_CASES[case][0]), None, batch,
                       mb)
    np.testing.assert_allclose(losses, one, atol=LOSS_TOL, rtol=0)
    for (k, a), (_, b) in zip(_leaves(p1),
                              _leaves(sm.unshard(params, "cpu"))):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=PARAM_TOL,
                                   rtol=0, err_msg=k)


def test_remat_over_the_mesh_changes_no_bit():
    """whisper at (2, 2) under ``dp_over_tp``, each layer of the encoder
    and the decoder recomputed in the backward: the run without remat
    bit for bit."""
    case = "whisper_2x2_dp_over_tp"
    _, _, _, (l1, p1, _) = case_run(case)
    _, _, _, (l2, p2, _) = case_run(case, remat="full")
    assert l1 == l2
    for (k, a), (_, b) in zip(_leaves(sm.unshard(p1, "cpu")),
                              _leaves(sm.unshard(p2, "cpu"))):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("arch,mesh,rep", [
    ("mamba2-370m", (2, 2), {}),
    ("whisper-small", (1, 2), {}),
    ("paligemma-3b", (2, 2), {}),
    ("hymba-1.5b", (2, 2), {"dp_over_tp": True})])
def test_checkpoint_restores_the_families_over_the_mesh(tmp_path, arch,
                                                        mesh, rep):
    """One device's tree and moments (the SSM's ``A_log`` and
    ``conv_w``, the encoder and its ``pos_embed``, the cross-attention,
    ``img_proj``) saved, restored over the mesh: every leaf laid out as
    ``shard_params`` lays it out, and back whole bit for bit."""
    cfg = get_tiny(arch)
    params = weights(arch)
    state = init_state(params, AdamWConfig())
    CheckpointManager(tmp_path).save(1, {"params": params, "opt": state})
    pol = policy(*mesh, rep=rep)
    tree, _ = CheckpointManager(tmp_path).restore(policy=pol, cfg=cfg)
    assert isinstance(tree["params"]["blocks"]["ln1"], sm.Sharded)
    back = sm.unshard(tree, "cpu")
    want = dict(_leaves({"params": params, "opt": state}))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("arch,dp,tp", [("mamba2-370m", 2, 2),
                                        ("hymba-1.5b", 2, 1)])
def test_launch_train_over_the_mesh(tmp_path, arch, dp, tp):
    """``launch/train --tiny --device cpu --dp --tp`` trains the SSM and
    the hybrid: the final loss within 1e-5 of one device's."""
    common = ["--arch", arch, "--tiny", "--device", "cpu", "--steps", "3",
              "--batch", "4", "--seq", "16", "--log-every", "3"]
    with contextlib.redirect_stdout(io.StringIO()):
        one = train_launch.main(common)
        mesh = train_launch.main(common + ["--dp", str(dp), "--tp",
                                           str(tp)])
    assert abs(mesh - one) <= LOSS_TOL


def test_hybrid_at_tp_without_dp_over_tp_is_refused():
    """No longer refused: the tiny hybrid at (1, 2) trains one step to
    one device's loss and parameters (its reference run:
    ``test_torch_tp_hybrid.py``)."""
    cfg = get_tiny("hymba-1.5b")
    batch = {k: torch.as_tensor(v)
             for k, v in chk.cfg_batch(cfg, 4, chk.SEQ, seed=1).items()}
    one = train(cfg, weights("hymba-1.5b"), None, batch, steps=1)
    mesh = train(cfg, weights("hymba-1.5b"), policy(1, 2), batch, steps=1)
    assert abs(mesh[0][0] - one[0][0]) <= LOSS_TOL
    got = sm.unshard(mesh[1])
    for k in ("wq", "wk", "wo"):
        assert float((got["blocks"]["attn"][k] - one[1]["blocks"]["attn"][k])
                     .abs().max()) <= PARAM_TOL, k


# --- held to the reference's run: last, so that the tests above run
# while its subprocess compiles ---


@pytest.mark.parametrize("names", sorted(DEVICES))
@pytest.mark.parametrize("case", sorted(chk.TRAIN_CASES))
def test_train_step_matches_the_reference_mesh(ref, case, names):
    _, _, _, (losses, params, _) = case_run(case, DEVICES[names])
    want = [float(ref[f"{case}/loss/{s}"]) for s in range(chk.STEPS)]
    np.testing.assert_allclose(losses, want, atol=LOSS_TOL, rtol=0)
    got = chk.flat(sm.unshard(params, "cpu"))
    assert {f"{case}/param/{k}" for k in got} == {
        k for k in ref if k.startswith(f"{case}/param/")}
    far = max(float(np.abs(v.numpy() - ref[f"{case}/param/{k}"]).max())
              for k, v in got.items())
    dl = max(abs(a - b) for a, b in zip(losses, want))
    outside = total = 0
    for k, v in got.items():
        d = np.abs(v.numpy() - ref[f"{case}/param/{k}"])
        outside += int((d > PARAM_TOL).sum())
        total += d.size
        assert d.max() <= 6 * chk.LR, k
    print(f"{case} {names}: max|dloss| {dl:.3g}, max|dparam| {far:.3g}, "
          f"{outside} of {total} elements beyond {PARAM_TOL}")
    assert outside <= 1e-4 * total
