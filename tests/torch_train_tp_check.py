"""The reference's sharded train step on forced host devices, for
``tests/test_torch_train_tp.py``: one subprocess trains every case and
writes the losses and final parameters to one ``.npz``:

    XLA_FLAGS="--xla_force_host_platform_device_count=8 \\
        --xla_backend_optimization_level=0" \\
        python tests/torch_train_tp_check.py <out.npz>

The mesh is ``jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(dp,
tp), ("data", "model"))``, whose axes are Auto (the reference's own
``make_mesh`` gives Explicit axes on jax 0.9, under which its
``ShardingPolicy.shard`` raises). Each case starts from
``repro.models.init_params(cfg, PRNGKey(0))`` placed by
``param_specs``, zero fp32 moments and the tokens of ``batch`` (a numpy
seed), and runs ``STEPS`` steps of the jitted ``build_train_step``.

``python tests/torch_train_tp_check.py --levels <dir>`` runs
``reference`` at level 0 and at the default level, each in a
subprocess, and prints each case's largest parameter difference
between the two.

``python tests/torch_train_tp_check.py --drift`` (same flags) prints
the reference's own drift between one device and the (2, 4) mesh with
replicated KV heads, fp32 against int8 moments, on the reference test's
batch (``tests/test_distributed.py:22``: ``randint(PRNGKey(1), (4,
16))``): each run's losses, the largest move of a weight a step, and
after each step the three leaves furthest apart.

XLA compiles at backend optimization level 0: at the default level the
float32 sums compile in another order, which moves the reference's own
final parameters by up to 6.1e-5 (Adam's first step turns float noise
in a gradient of a few ``eps`` into a move of a good part of lr); level
0 also compiles in two thirds of the time."""
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

STEPS = 3
LR = 1e-3
# case -> (arch, (dp, tp), for_mesh keywords, replace keywords, batch
# rows, microbatches)
CASES = {
    "qwen_2x4_kv_replicated": ("qwen2.5-32b", (2, 4),
                               {"shard_kv_heads": False}, {}, 4, 1),
    "qwen_2x2": ("qwen2.5-32b", (2, 2), {}, {}, 4, 1),
    "olmoe_2x2": ("olmoe-1b-7b", (2, 2), {}, {}, 4, 1),
    "olmoe_2x2_ep": ("olmoe-1b-7b", (2, 2), {}, {"ep_over_dp": True}, 4, 1),
    # a microbatch of 3 rows pads data rank 1 with a zero row
    "qwen_2x2_mb2_pad": ("qwen2.5-32b", (2, 2), {}, {}, 6, 2),
}
SEQ = 16


def batch(arch_vocab: int, rows: int) -> np.ndarray:
    return np.random.default_rng(1).integers(
        1, arch_vocab, (rows, SEQ)).astype(np.int32)


def flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def dedupe(spec):
    """``spec`` without an entry that names a mesh axis an earlier entry
    used (the rule of the reference's ``cache_specs``; under
    ``ep_over_dp`` the experts take the data axis FSDP also names, which
    ``NamedSharding`` refuses)."""
    from jax.sharding import PartitionSpec

    out, seen = [], set()
    for a in spec:
        names = a if isinstance(a, tuple) else (a,)
        out.append(None if any(n in seen for n in names if n) else a)
        seen.update(n for n in names if n)
    return PartitionSpec(*out)


def reference(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    sys.path.insert(0, str(ROOT / "src"))
    from repro.configs import get_tiny
    from repro.models import init_params, param_specs
    from repro.sharding import ShardingPolicy
    from repro.training.optimizer import AdamWConfig, init_state
    from repro.training.train_step import build_train_step

    res = {}
    opt = AdamWConfig(lr=LR)
    for case, (arch, (dp, tp), kw, rep, rows, mb) in CASES.items():
        cfg = get_tiny(arch)
        mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                    ("data", "model"))
        pol = ShardingPolicy.for_mesh(mesh, **kw).replace(**rep)
        params = init_params(cfg, jax.random.PRNGKey(0))
        state = init_state(params, opt)
        params = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, dedupe(s))),
            params, param_specs(cfg, pol))
        step = jax.jit(build_train_step(cfg, pol, opt, num_microbatches=mb,
                                        remat=None))
        toks = {"tokens": jnp.asarray(batch(cfg.vocab_size, rows))}
        for s in range(STEPS):
            params, state, m = step(params, state, toks)
            res[f"{case}/loss/{s}"] = np.asarray(m["loss"])
        for k, v in flat(params).items():
            res[f"{case}/param/{k}"] = np.asarray(v)
    np.savez(out, **res)


def drift() -> None:
    import jax
    from jax.sharding import Mesh, NamedSharding

    sys.path.insert(0, str(ROOT / "src"))
    from repro.configs import get_tiny
    from repro.models import init_params, param_specs
    from repro.sharding import ShardingPolicy
    from repro.training.optimizer import AdamWConfig, init_state
    from repro.training.train_step import build_train_step

    cfg = get_tiny("qwen2.5-32b")
    toks = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (4, 16), 1,
                                         cfg.vocab_size)}

    def run(mesh_shape, moments):
        opt = AdamWConfig(lr=LR, moment_dtype=moments)
        params = init_params(cfg, jax.random.PRNGKey(0))
        state = init_state(params, opt)
        pol = ShardingPolicy.single()
        if mesh_shape:
            mesh = Mesh(np.array(jax.devices()[:8]).reshape(mesh_shape),
                        ("data", "model"))
            pol = ShardingPolicy.for_mesh(mesh, shard_kv_heads=False)
            params = jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                params, param_specs(cfg, pol))
        step = jax.jit(build_train_step(cfg, pol, opt, remat=None))
        losses, moves, snaps = [], [], []
        prev = flat(jax.tree.map(np.asarray, params))
        for _ in range(STEPS):
            params, state, m = step(params, state, toks)
            cur = flat(jax.tree.map(np.asarray, params))
            moves.append(max(float(np.abs(cur[k] - prev[k]).max())
                             for k in cur))
            losses.append(float(m["loss"]))
            snaps.append(cur)
            prev = cur
        return losses, moves, snaps

    for moments in ("fp32", "int8"):
        one, mesh = run(None, moments), run((2, 4), moments)
        print(moments, "losses: one device", one[0], "mesh", mesh[0])
        print(moments, "largest move a step: one device", one[1], "mesh",
              mesh[1])
        for s in range(STEPS):
            a, b = one[2][s], mesh[2][s]
            far = sorted(((float(np.abs(a[k] - b[k]).max()), k) for k in a),
                         reverse=True)[:3]
            print(moments, f"after step {s + 1}: max|dparam|", far)


LEVEL_0 = "--xla_backend_optimization_level=0"


def levels(directory: str) -> None:
    outs = {}
    for name, flag in (("level0", LEVEL_0), ("default", "")):
        outs[name] = f"{directory}/{name}.npz"
        finish_reference(start_reference(outs[name], flag), outs[name])
    a, b = (np.load(outs[n]) for n in ("level0", "default"))
    for case in CASES:
        keys = [k for k in a if k.startswith(f"{case}/param/")]
        print(case, "max|dparam| between the levels",
              max(float(np.abs(a[k] - b[k]).max()) for k in keys))


def start_reference(out: str, level: str = LEVEL_0):
    """Start ``reference`` in a subprocess on 8 forced host devices
    (XLA flags beside: ``level``), its errors to ``<out>.err``;
    ``finish_reference`` waits for it."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count=8 "
                         f"{level}",
               PYTHONPATH=str(ROOT / "src"))
    with open(f"{out}.err", "w") as err:
        return subprocess.Popen([sys.executable, __file__, out], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)


def finish_reference(proc, out: str, timeout: int = 600) -> None:
    try:
        proc.wait(timeout=timeout)
    finally:
        proc.kill()
    if proc.returncode:
        err = Path(f"{out}.err").read_text()
        raise RuntimeError(f"reference run failed:\n{err[-3000:]}")


if __name__ == "__main__":
    if sys.argv[1] == "--drift":
        drift()
    elif sys.argv[1] == "--levels":
        levels(sys.argv[2])
    else:
        reference(sys.argv[1])
