"""The reference's sharded model functions for MLA, the MTP loss and the
``shard_cache_seq`` knob on forced host devices, for
``tests/test_torch_tp_mla.py`` (``serve``: prefill and greedy decode
steps) and ``tests/test_torch_train_tp_mla.py`` (``train``: the jitted
``forward_loss``). One subprocess a mode computes every case of it and
writes the outputs to one ``.npz``:

    XLA_FLAGS="--xla_force_host_platform_device_count=8 \\
        --xla_backend_optimization_level=0" \\
        python tests/torch_tp_mla_check.py serve|train <out.npz>

The mesh is ``jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(dp,
tp), ("data", "model"))``, whose axes are Auto (the reference's own
``make_mesh`` gives Explicit axes on jax 0.9, under which its
``ShardingPolicy.shard`` raises), the policy
``ShardingPolicy.for_mesh(mesh, **kw).replace(**rep)``. Weights come
from ``repro.models.init_params(cfg, PRNGKey(0))``, which the tests
rebuild in their own process; tokens, frames and patches from numpy
seeds (``tests/torch_tp_families_check.py``'s ``batch``). The cache
lengths divide every tensor-parallel size here (the prompt's positions
plus DECODE_STEPS: 20, and the VLM's 8 image positions before them):
the reference's ``device_put`` refuses a dimension its mesh axis does
not divide, so the uneven slices of ``shard_cache_seq`` are held to the
port's own one-device run instead."""
import sys

import numpy as np

import torch_tp_families_check as fam

# case -> (arch, (dp, tp), for_mesh keywords, replace keywords): prefill
# of fam.PROMPT rows, then fam.DECODE_STEPS greedy steps
SERVE_CASES = {
    "deepseek_1x2": ("deepseek-v3-671b", (1, 2), {}, {}),
    "deepseek_1x2_seq": ("deepseek-v3-671b", (1, 2), {},
                         {"shard_cache_seq": True}),
    "deepseek_2x2": ("deepseek-v3-671b", (2, 2), {}, {}),
    "deepseek_2x2_seq": ("deepseek-v3-671b", (2, 2), {},
                         {"shard_cache_seq": True}),
    "deepseek_1x4": ("deepseek-v3-671b", (1, 4), {}, {}),
    "deepseek_1x4_seq": ("deepseek-v3-671b", (1, 4), {},
                         {"shard_cache_seq": True}),
    "deepseek_2x2_ep": ("deepseek-v3-671b", (2, 2), {},
                        {"ep_over_dp": True}),
    "starcoder2_1x4_seq": ("starcoder2-3b", (1, 4), {},
                           {"shard_cache_seq": True}),
    "olmoe_2x2_seq": ("olmoe-1b-7b", (2, 2), {}, {"shard_cache_seq": True}),
    "whisper_1x2_seq": ("whisper-small", (1, 2), {},
                        {"shard_cache_seq": True}),
    "paligemma_1x2_seq": ("paligemma-3b", (1, 2), {},
                          {"shard_cache_seq": True}),
}
# case -> (arch, (dp, tp), for_mesh keywords, mtp_depth override or
# None): the jitted forward_loss of LOSS_ROWS x fam.SEQ tokens
LOSS_CASES = {
    "deepseek_2x2": ("deepseek-v3-671b", (2, 2), {}, None),
    "deepseek_1x2": ("deepseek-v3-671b", (1, 2), {}, None),
    "qwen_mtp_2x4_kv_replicated": ("qwen2.5-32b", (2, 4),
                                   {"shard_kv_heads": False}, 1),
}
LOSS_ROWS = 4


def loss_config(get_tiny, case: str):
    arch, _, _, mtp = LOSS_CASES[case]
    cfg = get_tiny(arch)
    return cfg if mtp is None else cfg.replace(mtp_depth=mtp)


def serve(out: str) -> None:
    import jax
    import jax.numpy as jnp

    policy = fam._setup()
    from repro.configs import get_tiny
    from repro.models import init_params
    from repro.models.lm import decode_step, prefill

    res = {}
    for case, (arch, (dp, tp), kw, rep) in SERVE_CASES.items():
        cfg = get_tiny(arch)
        params = init_params(cfg, jax.random.PRNGKey(0))
        pol = policy(dp, tp, kw, rep)
        b = {k: jnp.asarray(v)
             for k, v in fam.cfg_batch(cfg, *fam.PROMPT).items()}
        T = fam.max_seq(cfg.num_image_tokens)
        logits, cache = jax.jit(lambda p_, b_: prefill(
            cfg, pol, p_, b_, max_seq=T))(params, b)
        res[f"{case}/prefill"] = np.asarray(logits)
        for name, leaf in cache.items():
            res[f"{case}/cache/{name}"] = np.asarray(leaf)
        step = jax.jit(lambda p_, c_, t_, q_: decode_step(cfg, pol, p_, c_,
                                                          t_, q_))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        pos = jnp.full((fam.PROMPT[0],), cfg.num_image_tokens
                       + fam.PROMPT[1], jnp.int32)
        for s in range(fam.DECODE_STEPS):
            res[f"{case}/tokens/{s}"] = np.asarray(tok)
            logits, cache = step(params, cache, tok, pos)
            res[f"{case}/decode/{s}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            pos = pos + 1
        for name, leaf in cache.items():
            res[f"{case}/final_cache/{name}"] = np.asarray(leaf)
    np.savez(out, **res)


def train(out: str) -> None:
    import jax
    import jax.numpy as jnp

    policy = fam._setup()
    from repro.configs import get_tiny
    from repro.models import init_params
    from repro.models.lm import forward_loss

    res = {}
    for case, (_, (dp, tp), kw, _) in LOSS_CASES.items():
        cfg = loss_config(get_tiny, case)
        pol = policy(dp, tp, kw, {})
        params = init_params(cfg, jax.random.PRNGKey(0))
        b = {k: jnp.asarray(v) for k, v in fam.cfg_batch(
            cfg, LOSS_ROWS, fam.SEQ, seed=1).items()}
        res[f"{case}/loss"] = np.asarray(jax.jit(
            lambda p_, b_: forward_loss(cfg, pol, p_, b_))(params, b))
    np.savez(out, **res)


def start_reference(mode: str, out: str):
    """Start ``mode`` ("serve" or "train") in a subprocess on 8 forced
    host devices at XLA's level 0 (``torch_tp_families_check``'s way);
    ``finish_reference`` waits for it."""
    import os
    import subprocess
    from pathlib import Path

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count=8 "
                         f"{fam.LEVEL_0}",
               PYTHONPATH=os.pathsep.join([str(fam.ROOT / "src"),
                                           str(Path(__file__).parent)]))
    with open(f"{out}.err", "w") as err:
        return subprocess.Popen([sys.executable, __file__, mode, out],
                                env=env, stdout=subprocess.DEVNULL,
                                stderr=err)


finish_reference = fam.finish_reference


if __name__ == "__main__":
    {"serve": serve, "train": train}[sys.argv[1]](sys.argv[2])
