"""The reference's sharded model functions for the SSM, hybrid,
encoder-decoder and VLM families and the ``dp_over_tp`` and
``seq_parallel`` knobs on forced host devices, for
``tests/test_torch_tp_families.py`` (``serve``: prefill and greedy
decode steps) and ``tests/test_torch_train_tp_families.py`` (``train``:
the jitted train step). One subprocess a mode computes every case of
it and writes the outputs to one ``.npz``:

    XLA_FLAGS="--xla_force_host_platform_device_count=8 \\
        --xla_backend_optimization_level=0" \\
        python tests/torch_tp_families_check.py serve|train <out.npz>

The mesh is ``jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(dp,
tp), ("data", "model"))``, whose axes are Auto (the reference's own
``make_mesh`` gives Explicit axes on jax 0.9, under which its
``ShardingPolicy.shard`` raises), the policy
``ShardingPolicy.for_mesh(mesh, **kw).replace(**rep)``. Weights come
from ``repro.models.init_params(cfg, PRNGKey(0))``, which the tests
rebuild in their own process; tokens, frames and patches from numpy
seeds (``batch``). XLA compiles at backend optimization level 0, as
``tests/torch_train_tp_check.py`` explains (also faster)."""
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# case -> (arch, (dp, tp), for_mesh keywords, replace keywords): prefill
# of PROMPT rows (with FRAMES frames or the VLM's patches), then
# DECODE_STEPS greedy steps
SERVE_CASES = {
    "mamba2_2x2": ("mamba2-370m", (2, 2), {}, {}),
    "hymba_2x1": ("hymba-1.5b", (2, 1), {}, {}),
    "hymba_2x2_dp_over_tp": ("hymba-1.5b", (2, 2), {}, {"dp_over_tp": True}),
    "whisper_2x2_dp_over_tp": ("whisper-small", (2, 2), {},
                               {"dp_over_tp": True}),
    "whisper_1x2": ("whisper-small", (1, 2), {}, {}),
    "paligemma_1x2": ("paligemma-3b", (1, 2), {}, {}),
    "paligemma_2x2": ("paligemma-3b", (2, 2), {}, {}),
    "starcoder2_2x2_dp_over_tp": ("starcoder2-3b", (2, 2), {},
                                  {"dp_over_tp": True}),
    "olmoe_2x2_dp_over_tp": ("olmoe-1b-7b", (2, 2), {},
                             {"dp_over_tp": True}),
    "stablelm_1x2_seq_parallel": ("stablelm-3b", (1, 2),
                                  {"seq_parallel": True}, {}),
}
# moe_block alone under dp_over_tp at capacity factor 1.0, where experts
# drop rows: the capacity of n·S / (dp·tp) tokens decides which
MOE_CASE = ("olmoe-1b-7b", (2, 2), (4, 8))
MOE_CAPACITY_FACTOR = 1.0
PROMPT = (4, 16)
# the hybrid's tiny window is 16: MAX_SEQ keeps a 16-slot ring, which
# the decode steps wrap
DECODE_STEPS = 4
FRAMES = 24  # of whisper-tiny's 32 encoder positions
# case -> (arch, (dp, tp), for_mesh keywords, replace keywords, batch
# rows, microbatches): STEPS fp32 steps of build_train_step at LR
TRAIN_CASES = {
    "mamba2_2x2": ("mamba2-370m", (2, 2), {}, {}, 4, 1),
    "hymba_2x2_dp_over_tp": ("hymba-1.5b", (2, 2), {}, {"dp_over_tp": True},
                             4, 1),
    "whisper_2x2_dp_over_tp": ("whisper-small", (2, 2), {},
                               {"dp_over_tp": True}, 4, 1),
    "paligemma_1x2": ("paligemma-3b", (1, 2), {}, {}, 4, 1),
    # microbatches of 3 rows over 4 data ranks: a zero row, zero frames
    "whisper_2x2_dp_over_tp_mb2": ("whisper-small", (2, 2), {},
                                   {"dp_over_tp": True}, 6, 2),
}
STEPS = 3
LR = 1e-3
SEQ = 16


def max_seq(image_tokens: int) -> int:
    """The cache length of a serve case: the prompt's positions (the
    VLM's image positions first) and the decode steps."""
    return image_tokens + PROMPT[1] + DECODE_STEPS


def batch(family: str, vocab: int, d_model: int, image_tokens: int,
          rows: int, seq: int, seed: int = 12) -> dict:
    """Tokens in [1, vocab) (rows, seq), plus unit-normal ``frames``
    (rows, FRAMES, d_model) for the encoder-decoder or ``patches``
    (rows, image_tokens, d_model) for the VLM, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, vocab, (rows, seq)).astype(np.int32)}
    if family == "encdec":
        out["frames"] = rng.standard_normal(
            (rows, FRAMES, d_model)).astype(np.float32)
    if family == "vlm":
        out["patches"] = rng.standard_normal(
            (rows, image_tokens, d_model)).astype(np.float32)
    return out


def moe_input(d_model: int) -> np.ndarray:
    return np.random.default_rng(11).standard_normal(
        (*MOE_CASE[2], d_model)).astype(np.float32)


def cfg_batch(cfg, rows: int, seq: int, seed: int = 12) -> dict:
    return batch(cfg.family, cfg.vocab_size, cfg.d_model,
                 cfg.num_image_tokens, rows, seq, seed)


def flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _setup():
    import jax
    from jax.sharding import Mesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro.sharding import ShardingPolicy

    def policy(dp, tp, kw, rep):
        devs = np.array(jax.devices()[:dp * tp]).reshape(dp, tp)
        return ShardingPolicy.for_mesh(Mesh(devs, ("data", "model")),
                                       **kw).replace(**rep)
    return policy


def serve(out: str) -> None:
    import jax
    import jax.numpy as jnp

    policy = _setup()
    from repro.configs import get_tiny
    from repro.models import init_params
    from repro.models.lm import decode_step, prefill

    from repro.models.layers import moe_block

    res = {}
    arch, (dp, tp), _ = MOE_CASE
    cfg = get_tiny(arch).replace(moe_capacity_factor=MOE_CAPACITY_FACTOR)
    p = jax.tree.map(lambda a: a[0], init_params(
        cfg, jax.random.PRNGKey(0))["blocks"]["moe"])
    pol = policy(dp, tp, {}, {"dp_over_tp": True})
    res["moe"] = np.asarray(jax.jit(lambda p_, x_: moe_block(
        cfg, pol, p_, x_))(p, jnp.asarray(moe_input(cfg.d_model))))
    for case, (arch, (dp, tp), kw, rep) in SERVE_CASES.items():
        cfg = get_tiny(arch)
        params = init_params(cfg, jax.random.PRNGKey(0))
        pol = policy(dp, tp, kw, rep)
        b = {k: jnp.asarray(v) for k, v in cfg_batch(cfg, *PROMPT).items()}
        T = max_seq(cfg.num_image_tokens)
        logits, cache = jax.jit(lambda p_, b_: prefill(
            cfg, pol, p_, b_, max_seq=T))(params, b)
        res[f"{case}/prefill"] = np.asarray(logits)
        for name, leaf in cache.items():
            res[f"{case}/cache/{name}"] = np.asarray(leaf)
        step = jax.jit(lambda p_, c_, t_, q_: decode_step(cfg, pol, p_, c_,
                                                          t_, q_))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        pos = jnp.full((PROMPT[0],), cfg.num_image_tokens + PROMPT[1],
                       jnp.int32)
        for s in range(DECODE_STEPS):
            res[f"{case}/tokens/{s}"] = np.asarray(tok)
            logits, cache = step(params, cache, tok, pos)
            res[f"{case}/decode/{s}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            pos = pos + 1
        res[f"{case}/tokens/{DECODE_STEPS}"] = np.asarray(tok)
        for name, leaf in cache.items():
            res[f"{case}/final_cache/{name}"] = np.asarray(leaf)
    np.savez(out, **res)


def train(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    policy = _setup()
    from repro.configs import get_tiny
    from repro.models import init_params, param_specs
    from repro.training.optimizer import AdamWConfig, init_state
    from repro.training.train_step import build_train_step

    def placement(a, spec, mesh):
        """``spec`` without an entry naming a mesh axis an earlier entry
        used (``cache_specs``' rule) or one that does not divide its
        dimension (paligemma's one KV head over tp = 2, which
        ``device_put`` refuses; the jitted step's constraints place
        it as they will)."""
        seen, ents = set(), []
        for n, e in zip(a.shape, spec):
            names = e if isinstance(e, tuple) else (e,)
            size = int(np.prod([mesh.shape[x] for x in names if x]))
            bad = any(x in seen for x in names if x) or n % size
            ents.append(None if bad else e)
            seen.update(x for x in names if x)
        return NamedSharding(mesh, PartitionSpec(*ents))

    res = {}
    opt = AdamWConfig(lr=LR)
    for case, (arch, (dp, tp), kw, rep, rows, mb) in TRAIN_CASES.items():
        cfg = get_tiny(arch)
        pol = policy(dp, tp, kw, rep)
        params = init_params(cfg, jax.random.PRNGKey(0))
        state = init_state(params, opt)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, placement(a, s, pol.mesh)),
            params, param_specs(cfg, pol))
        step = jax.jit(build_train_step(cfg, pol, opt, num_microbatches=mb,
                                        remat=None))
        b = {k: jnp.asarray(v)
             for k, v in cfg_batch(cfg, rows, SEQ, seed=1).items()}
        for s in range(STEPS):
            params, state, m = step(params, state, b)
            res[f"{case}/loss/{s}"] = np.asarray(m["loss"])
        for k, v in flat(params).items():
            res[f"{case}/param/{k}"] = np.asarray(v)
    np.savez(out, **res)


LEVEL_0 = "--xla_backend_optimization_level=0"


def start_reference(mode: str, out: str):
    """Start ``mode`` ("serve" or "train") in a subprocess on 8 forced
    host devices at XLA's level 0, its errors to ``<out>.err``;
    ``finish_reference`` waits for it."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count=8 "
                         f"{LEVEL_0}",
               PYTHONPATH=str(ROOT / "src"))
    with open(f"{out}.err", "w") as err:
        return subprocess.Popen([sys.executable, __file__, mode, out],
                                env=env, stdout=subprocess.DEVNULL,
                                stderr=err)


def finish_reference(proc, out: str, timeout: int = 600) -> None:
    try:
        proc.wait(timeout=timeout)
    finally:
        proc.kill()
    if proc.returncode:
        err = Path(f"{out}.err").read_text()
        raise RuntimeError(f"reference run failed:\n{err[-3000:]}")


if __name__ == "__main__":
    {"serve": serve, "train": train}[sys.argv[1]](sys.argv[2])
