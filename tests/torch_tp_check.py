"""The reference's sharded model functions on forced host devices, for
``tests/test_torch_tp.py``: one subprocess computes every case and
writes the outputs to one ``.npz``:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_tp_check.py <out.npz>

The mesh is ``jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(dp,
tp), ("data", "model"))``, whose axes are Auto; the reference's own
``launch/mesh.py::make_mesh`` gives Explicit axes on jax 0.9, under
which its ``ShardingPolicy.shard`` raises. Weights come from
``repro.models.init_params(cfg, PRNGKey(0))``, which the test rebuilds
in its own process; inputs from numpy seeds (``moe_input``,
``prompt_tokens``)."""
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# (arch, (dp, tp), ep_over_dp, (B, S)); capacity factor 1.0, so experts
# drop rows
MOE_CASES = {
    "olmoe_2x2": ("olmoe-1b-7b", (2, 2), False, (4, 8)),
    "olmoe_1x4": ("olmoe-1b-7b", (1, 4), False, (4, 8)),
    "olmoe_2x4": ("olmoe-1b-7b", (2, 4), False, (4, 8)),
    "olmoe_2x2_width1": ("olmoe-1b-7b", (2, 2), False, (1, 16)),
    "olmoe_2x2_ep": ("olmoe-1b-7b", (2, 2), True, (4, 8)),
    "olmoe_2x4_ep": ("olmoe-1b-7b", (2, 4), True, (4, 8)),
    "deepseek_2x2": ("deepseek-v3-671b", (2, 2), False, (4, 8)),
    "deepseek_2x2_ep": ("deepseek-v3-671b", (2, 2), True, (4, 8)),
}
MOE_CAPACITY_FACTOR = 1.0
# (arch, (dp, tp), for_mesh keywords): prefill of PROMPT rows, then
# DECODE_STEPS greedy steps
MODEL_CASES = {
    "olmoe_2x2": ("olmoe-1b-7b", (2, 2), {}),
    "olmoe_1x4": ("olmoe-1b-7b", (1, 4), {}),
    "starcoder2_2x2": ("starcoder2-3b", (2, 2), {}),
    "starcoder2_1x4": ("starcoder2-3b", (1, 4), {}),
    "starcoder2_1x4_kv_replicated": ("starcoder2-3b", (1, 4),
                                     {"shard_kv_heads": False}),
    "qwen_2x4_kv_replicated": ("qwen2.5-32b", (2, 4),
                               {"shard_kv_heads": False}),
    "qwen_1x4_kv_replicated": ("qwen2.5-32b", (1, 4),
                               {"shard_kv_heads": False}),
}
PROMPT = (4, 16)
DECODE_STEPS = 4
MAX_SEQ = PROMPT[1] + DECODE_STEPS


def moe_input(case: str, d_model: int) -> np.ndarray:
    shape = MOE_CASES[case][3]
    return np.random.default_rng(11).standard_normal(
        (*shape, d_model)).astype(np.float32)


def prompt_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(12).integers(
        1, vocab, PROMPT).astype(np.int32)


def reference(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro.configs import get_tiny
    from repro.models import init_params
    from repro.models.layers import moe_block
    from repro.models.lm import decode_step, prefill
    from repro.sharding import ShardingPolicy

    def mesh(dp, tp):
        devs = np.array(jax.devices()[:dp * tp]).reshape(dp, tp)
        return Mesh(devs, ("data", "model"))

    res = {}
    for case, (arch, (dp, tp), ep, _) in MOE_CASES.items():
        cfg = get_tiny(arch).replace(moe_capacity_factor=MOE_CAPACITY_FACTOR)
        p = jax.tree.map(lambda a: a[0],
                         init_params(cfg, jax.random.PRNGKey(0))["blocks"]
                         ["moe"])
        pol = ShardingPolicy.for_mesh(mesh(dp, tp)).replace(ep_over_dp=ep)
        x = jnp.asarray(moe_input(case, cfg.d_model))
        y = jax.jit(lambda p_, x_: moe_block(cfg, pol, p_, x_))(p, x)
        res[f"moe/{case}"] = np.asarray(y)
    for case, (arch, (dp, tp), kw) in MODEL_CASES.items():
        cfg = get_tiny(arch)
        params = init_params(cfg, jax.random.PRNGKey(0))
        pol = ShardingPolicy.for_mesh(mesh(dp, tp), **kw)
        toks = jnp.asarray(prompt_tokens(cfg.vocab_size))
        logits, cache = jax.jit(lambda p_, t_: prefill(
            cfg, pol, p_, {"tokens": t_}, max_seq=MAX_SEQ))(params, toks)
        res[f"model/{case}/prefill"] = np.asarray(logits)
        for name in ("k", "v", "slot_pos"):
            res[f"model/{case}/cache/{name}"] = np.asarray(cache[name])
        step = jax.jit(lambda p_, c_, t_, q_: decode_step(cfg, pol, p_, c_,
                                                          t_, q_))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        pos = jnp.full((PROMPT[0],), PROMPT[1], jnp.int32)
        for s in range(DECODE_STEPS):
            res[f"model/{case}/tokens/{s}"] = np.asarray(tok)
            logits, cache = step(params, cache, tok, pos)
            res[f"model/{case}/decode/{s}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            pos = pos + 1
    np.savez(out, **res)


def run_reference(out: str, timeout: int = 600) -> None:
    """Run ``reference`` in a subprocess on 8 forced host devices."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, __file__, out], env=env,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode:
        raise RuntimeError(f"reference run failed:\n{r.stderr[-3000:]}")


if __name__ == "__main__":
    reference(sys.argv[1])
