"""The reference's sharded hybrid (hymba) at tp > 1 without ``dp_over_tp``
on forced host devices, for ``tests/test_torch_tp_hybrid.py``: prefill
and greedy decode steps past the ring's wrap for every ``SERVE_CASES``
entry, and ``TRAIN_STEPS`` fp32 steps of the jitted train step for
every ``TRAIN_CASES`` entry, in one subprocess written to one ``.npz``:

    XLA_FLAGS="--xla_force_host_platform_device_count=8 \\
        --xla_backend_optimization_level=0" \\
        python tests/torch_tp_hybrid_check.py <out.npz>

The mesh, the policy, the weights (``init_params(cfg, PRNGKey(0))``)
and the batches are ``tests/torch_tp_families_check.py``'s; the
configurations are the tiny hymba given full hymba-1.5b's head layout
(25 query heads over 5 KV heads, head_dim 8: ``h25``), the stock tiny
hymba (5 over 5), and ``h25`` padded for tp = 2 (26 over 2)."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_tp_families_check as fam  # noqa: E402

# config name -> ModelConfig.replace keywords on get_tiny("hymba-1.5b")
H25 = {"num_heads": 25, "num_kv_heads": 5, "head_dim": 8}
# case -> (config name, (dp, tp), replace keywords on the policy)
SERVE_CASES = {
    "h25_1x2": ("h25", (1, 2), {}),
    "h25_1x4": ("h25", (1, 4), {}),
    "h25_2x2": ("h25", (2, 2), {}),
    "h25_1x2_seq": ("h25", (1, 2), {"shard_cache_seq": True}),
    "stock_1x2": ("stock", (1, 2), {}),
    "h25pad_1x2": ("h25pad", (1, 2), {}),
}
# case -> (config name, (dp, tp), policy keywords, batch rows)
TRAIN_CASES = {"h25_1x2": ("h25", (1, 2), {}, 4)}
TRAIN_STEPS = 3


def config(name: str, get_tiny):
    """The tiny hymba of ``name`` from a package's ``get_tiny``."""
    cfg = get_tiny("hymba-1.5b")
    if name == "stock":
        return cfg
    cfg = cfg.replace(**H25)
    return cfg.pad_heads_for_tp(2) if name == "h25pad" else cfg


def main(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    policy = fam._setup()
    from repro.configs import get_tiny
    from repro.models import init_params, param_specs
    from repro.models.lm import decode_step, prefill
    from repro.training.optimizer import AdamWConfig, init_state
    from repro.training.train_step import build_train_step

    res = {}
    P = fam.PROMPT
    for case, (name, (dp, tp), rep) in SERVE_CASES.items():
        cfg = config(name, get_tiny)
        params = init_params(cfg, jax.random.PRNGKey(0))
        pol = policy(dp, tp, {}, rep)
        b = {k: jnp.asarray(v) for k, v in fam.cfg_batch(cfg, *P).items()}
        T = fam.max_seq(0)
        logits, cache = jax.jit(lambda p_, b_: prefill(
            cfg, pol, p_, b_, max_seq=T))(params, b)
        res[f"{case}/prefill"] = np.asarray(logits)
        for k, leaf in cache.items():
            res[f"{case}/cache/{k}"] = np.asarray(leaf)
        step = jax.jit(lambda p_, c_, t_, q_: decode_step(cfg, pol, p_, c_,
                                                          t_, q_))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        pos = jnp.full((P[0],), P[1], jnp.int32)
        for s in range(fam.DECODE_STEPS):
            res[f"{case}/tokens/{s}"] = np.asarray(tok)
            logits, cache = step(params, cache, tok, pos)
            res[f"{case}/decode/{s}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            pos = pos + 1
        res[f"{case}/tokens/{fam.DECODE_STEPS}"] = np.asarray(tok)
        for k, leaf in cache.items():
            res[f"{case}/final_cache/{k}"] = np.asarray(leaf)

    def placement(a, spec, mesh):
        """``spec`` without an entry that does not divide its dimension
        (25 query heads over tp = 2, which ``device_put`` refuses; the
        jitted step's constraints place them as they will)."""
        ents = []
        for n, e in zip(a.shape, spec):
            names = e if isinstance(e, tuple) else (e,)
            size = int(np.prod([mesh.shape[x] for x in names if x]))
            ents.append(None if n % size else e)
        return NamedSharding(mesh, PartitionSpec(*ents))

    opt = AdamWConfig(lr=fam.LR)
    for case, (name, (dp, tp), rep, rows) in TRAIN_CASES.items():
        cfg = config(name, get_tiny)
        pol = policy(dp, tp, {}, rep)
        params = init_params(cfg, jax.random.PRNGKey(0))
        state = init_state(params, opt)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, placement(a, s, pol.mesh)),
            params, param_specs(cfg, pol))
        step = jax.jit(build_train_step(cfg, pol, opt, num_microbatches=1,
                                        remat=None))
        b = {k: jnp.asarray(v)
             for k, v in fam.cfg_batch(cfg, rows, fam.SEQ, seed=1).items()}
        for s in range(TRAIN_STEPS):
            params, state, m = step(params, state, b)
            res[f"train/{case}/loss/{s}"] = np.asarray(m["loss"])
        for k, v in fam.flat(params).items():
            res[f"train/{case}/param/{k}"] = np.asarray(v)
    np.savez(out, **res)


def start_reference(out: str):
    """Start ``main`` in a subprocess on 8 forced host devices at XLA's
    level 0, its errors to ``<out>.err``; ``fam.finish_reference``
    waits for it."""
    import os
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count=8 "
                         f"{fam.LEVEL_0}",
               PYTHONPATH=str(fam.ROOT / "src"))
    with open(f"{out}.err", "w") as err:
        return subprocess.Popen([sys.executable, __file__, out], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)


if __name__ == "__main__":
    main(sys.argv[1])
