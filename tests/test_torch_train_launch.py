"""The port's training entry points and the files they share with the
reference: ``launch/train.py`` killed at step 6 and resumed (the final
``loss=`` line equals an uninterrupted run's), ``launch/serve.py
--ckpt`` serving a backend that ``examples/torch_train_backend.py``
trained for a few steps, ``CheckpointManager`` (round trip, async
writes and GC, a partial write invisible, and checkpoints written by
either package restored by the other, bit for bit), and the
step-addressable ``TokenStream``/``PromptStream`` against the
reference's batches, bit for bit. All on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import make_ecommerce as ref_ecommerce  # noqa: E402
from repro.training import checkpoint as ref_ckpt  # noqa: E402
from repro.training import data as ref_data  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro_torch.data import make_ecommerce  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.training import (  # noqa: E402
    CheckpointManager,
    HashTokenizer,
    PromptStream,
    TokenStream,
    backend_config,
)
from repro_torch.training.optimizer import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _run_train(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)


def test_failure_resume_identical(tmp_path):
    """Kill at step 6, resume: the final loss equals an uninterrupted
    run's, and the checkpoints of both runs are the same bit for bit."""
    common = ["--arch", "mamba2-370m", "--tiny", "--device", "cpu",
              "--steps", "12", "--batch", "2", "--seq", "16",
              "--ckpt-every", "3", "--log-every", "1"]
    r1 = _run_train(common + ["--ckpt-dir", str(tmp_path / "a")])
    assert r1.returncode == 0, r1.stderr[-2000:]
    loss_ref = r1.stdout.strip().splitlines()[-1]
    r2 = _run_train(common + ["--ckpt-dir", str(tmp_path / "b"),
                              "--simulate-failure", "6"])
    assert r2.returncode == 42, r2.stderr[-2000:]
    assert CheckpointManager(tmp_path / "b").latest_step() == 6
    r3 = _run_train(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert r3.returncode == 0, r3.stderr[-2000:]
    assert "resumed from step 6" in r3.stdout
    loss_resumed = r3.stdout.strip().splitlines()[-1]
    assert "final loss=" in loss_ref
    assert loss_ref.split("loss=")[1] == loss_resumed.split("loss=")[1]
    a, ma = CheckpointManager(tmp_path / "a").restore(12)
    b, mb = CheckpointManager(tmp_path / "b").restore(12)
    assert ma["keys"] == mb["keys"] and ma["arch"] == "mamba2-tiny"
    for (k, x), (_, y) in zip(leaves(a), leaves(b)):
        for u, v in ([(x["q"], y["q"]), (x["s"], y["s"])]
                     if isinstance(x, dict) else [(x, y)]):
            assert u.shape == v.shape and u.dtype == v.dtype, k
            np.testing.assert_array_equal(u, v, err_msg=k)


def test_train_mla_tiny_cpu(tmp_path, capsys):
    """``launch/train --arch deepseek-v3-671b --tiny --device cpu``:
    MLA and the MTP loss train, and the checkpoint holds the ``mtp``
    leaves."""
    loss = train.main(["--arch", "deepseek-v3-671b", "--tiny", "--device",
                       "cpu", "--steps", "3", "--batch", "2", "--seq",
                       "16", "--log-every", "1", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] done: 3 steps" in out and np.isfinite(loss)
    _, manifest = CheckpointManager(tmp_path).restore(3)
    assert manifest["arch"] == "deepseek-tiny"
    assert "params.mtp.proj" in manifest["keys"]
    assert "params.blocks.mla.wuk" in manifest["keys"]


def test_train_refuses_a_model_parallel_mesh():
    """Every token-fed family trains over a mesh, the hybrid at tp > 1
    too (``test_torch_train_tp.py``, ``test_torch_train_tp_families.py``,
    ``test_torch_train_tp_mla.py``, ``test_torch_tp_hybrid.py``); what
    ``launch/train`` refuses over a mesh, as on one device, is a family
    that needs frames or patches beside its tokens."""
    with pytest.raises(NotImplementedError, match="feeds tokens only"):
        train.main(["--arch", "whisper-small", "--tiny", "--device", "cpu",
                    "--tp", "2"])


def test_serve_ckpt_serves_the_trained_backend(tmp_path, capsys):
    """A backend trained for 3 steps by the example, checkpointed,
    restored by ``serve --ckpt --device cpu`` and by the serving
    example, which runs the products ⋈ previews plan on it."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_serve_semantic_queries as serve_example
        import torch_train_backend
    finally:
        sys.path.remove(str(ROOT / "examples"))
    ckpt = str(tmp_path / "ckpt")
    torch_train_backend.main(["--steps", "3", "--device", "cpu",
                              "--ckpt-dir", ckpt])
    tree, manifest = CheckpointManager(ckpt).restore(device="cpu")
    assert manifest["step"] == 3 and manifest["arch"] == "backend-13m"
    assert 0.0 <= manifest["accuracy"] <= 1.0
    capsys.readouterr()
    prompts = ["Is this product an electronics item? A toys item, model 3.",
               "Is this product review positive? Purchase 7 felt great."]
    serve.main(["--ckpt", ckpt, "--device", "cpu", "--batch", "2",
                "--prompts", *prompts])
    out = capsys.readouterr().out
    assert "[serve] restored backend-13m @ step 3 on cpu" in out
    for p in prompts:
        assert repr(p) in out
    assert "[serve] 2 prompts" in out
    # weights that require grad are served without autograd
    cfg = backend_config()
    params = tree["params"]
    for _, v in leaves(params):
        v.requires_grad_(True)
    eng = ServingEngine(cfg, params, tokenizer=HashTokenizer(
        cfg.vocab_size), batch_size=4, max_seq=48, device="cpu")
    logits, cache = eng._prefill(torch.ones(2, 8, dtype=torch.int32))
    assert not logits.requires_grad and not cache["k"].requires_grad
    answers = eng.answer(prompts)
    assert len(answers) == 2 and all(answers)
    res = serve_example.serve_plan(eng, torch.device("cpu"),
                                   strategies=("cost",))["cost"]
    assert res["llm_calls"] > 0 and len(res["verdicts"]) == res["llm_calls"]
    assert 0.0 <= res["f1"] <= 1.0 and res["oracle_rows"] > 0


# ------------------------------------------------------------ checkpoints


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = {"params": {"w": torch.arange(10.0)},
            "opt": {"m": torch.ones((3, 3)),
                    "b": torch.full((4,), 1.5).to(torch.bfloat16),
                    "step": torch.tensor(5, dtype=torch.int32)}}
    mgr.save(7, tree, extra={"arch": "t"})
    out, manifest = mgr.restore()
    assert manifest["step"] == 7 and manifest["arch"] == "t"
    assert manifest["keys"] == sorted(["params.w", "opt.m", "opt.b",
                                       "opt.step"])
    np.testing.assert_array_equal(out["params"]["w"], np.arange(10.0))
    np.testing.assert_array_equal(out["opt"]["step"], 5)
    dev, _ = mgr.restore(device="cpu")
    assert dev["opt"]["step"].shape == () and \
        dev["opt"]["step"].dtype == torch.int32
    assert dev["opt"]["b"].dtype == torch.bfloat16
    assert torch.equal(dev["opt"]["b"], tree["opt"]["b"])
    assert torch.equal(dev["params"]["w"], tree["params"]["w"])


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    w = torch.zeros(4)
    for s in (1, 2, 3, 4):
        w.fill_(s)  # the caller's tensor changes while a save writes
        mgr.save_async(s, {"w": w})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    for s in (3, 4):
        np.testing.assert_array_equal(mgr.restore(s)[0]["w"],
                                      np.full(4, s, np.float32))


def test_checkpoint_partial_write_is_invisible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.ones(3)})
    # a crashed writer's stale tmp dir must be ignored
    (tmp_path / "step_0000000002.tmp").mkdir()
    assert mgr.latest_step() == 1
    out, _ = mgr.restore()
    np.testing.assert_array_equal(out["w"], np.ones(3))


@pytest.mark.parametrize("moment_dtype", ("fp32", "bf16", "int8"))
def test_checkpoints_cross_packages(tmp_path, moment_dtype):
    """A training checkpoint (params and optimizer state) written by
    either package restores in the other, leaf for leaf and bit for
    bit."""
    rng = np.random.default_rng(0)
    rp = {"embed": jnp.asarray(rng.standard_normal((16, 8)), jnp.float32),
          "blocks": {"w": jnp.asarray(rng.standard_normal((2, 8, 130)),
                                      jnp.float32),
                     "ln": jnp.ones((2, 8), jnp.float32)}}
    opt = ref_opt.AdamWConfig(moment_dtype=moment_dtype)
    rs = ref_opt.init_state(rp, opt)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), rp)
    rp, rs, _ = ref_opt.apply_updates(rp, g, rs, opt)
    ref_ckpt.CheckpointManager(tmp_path / "ref").save(
        3, {"params": rp, "opt": rs}, extra={"arch": "t"})
    tree, manifest = CheckpointManager(tmp_path / "ref").restore(
        device="cpu")
    assert manifest["step"] == 3 and manifest["arch"] == "t"
    want = {".".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path({"params": rp, "opt": rs})}
    flat = {}
    for k, v in leaves(tree):
        for sub, t in ([(k + ".q", v["q"]), (k + ".s", v["s"])]
                       if isinstance(v, dict) else [(k, v)]):
            flat[sub] = t
    assert set(flat) == set(want)
    for k, v in flat.items():
        w = want[k]
        if v.dtype == torch.bfloat16:
            assert w.dtype == jnp.bfloat16
            np.testing.assert_array_equal(v.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    # and back: the port writes, the reference reads
    CheckpointManager(tmp_path / "port").save(4, tree, extra={"arch": "t"})
    back, manifest = ref_ckpt.CheckpointManager(tmp_path / "port").restore()
    assert manifest["step"] == 4
    for path, v in jax.tree_util.tree_leaves_with_path(back):
        k = ".".join(p.key for p in path)
        w = want[k]
        if w.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(v.view(np.int16), w.view(np.int16))
        else:
            assert v.dtype == w.dtype, k
            np.testing.assert_array_equal(v, w, err_msg=k)


# ----------------------------------------------------------- data streams


def test_token_stream_matches_reference_and_is_step_addressable():
    ds = TokenStream(vocab_size=100, batch_size=2, seq_len=8, seed=3)
    ref = ref_data.TokenStream(vocab_size=100, batch_size=2, seq_len=8,
                               seed=3)
    for step in (0, 1, 41, 10_000):
        a = ds[step]["tokens"]
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, ref[step]["tokens"])
    np.testing.assert_array_equal(ds[41]["tokens"], ds[41]["tokens"])
    assert not np.array_equal(ds[41]["tokens"], ds[42]["tokens"])
    it = iter(ds)
    np.testing.assert_array_equal(next(it)["tokens"], ds[0]["tokens"])


def test_prompt_stream_matches_reference():
    """The port's PromptStream over the port's ``make_ecommerce`` gives
    the reference's batches over the reference's."""
    tok = HashTokenizer(4096)
    ps = PromptStream(db=make_ecommerce(seed=4, device="cpu"),
                      tokenizer=tok, batch_size=32, seq_len=48, seed=0)
    ref = ref_data.PromptStream(db=ref_ecommerce(seed=4),
                                tokenizer=ref_data.HashTokenizer(4096),
                                batch_size=32, seq_len=48, seed=0)
    assert len(ps) == len(ref) > 1000
    for step in (0, 7, 10_000):
        a, b = ps[step], ref[step]
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    labels = np.concatenate([ps[s]["labels"] for s in range(4)])
    assert set(labels.tolist()) == {tok.YES, tok.NO}
