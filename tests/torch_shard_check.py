"""Shared checks of the partitioned data tier, the port against the
reference.

**The tier's pieces** (``tests/test_torch_sharded.py``): ``tier_cases``
makes, from seeds, key tables (multi-key, int32 extremes, empty, skewed,
hot keys, wide rows), min/max value columns (NaN first, in the middle,
last and alone in a group, -0.0 beside +0.0, ±inf, int32 extremes) and
join sides; ``reference_tier`` and ``port_tier`` run the same partitions,
group plans, sharded reductions and joins on a mesh and return every
output (layouts with their pads, plans, partials' merge, match lists)
and the sync and collective counts each step ticked, as flat numpy
arrays under the same names. The reference's four-device results come
from one subprocess:

    python tests/torch_shard_check.py tier <out.npz>

**The corpus** (``tests/test_torch_shardcorpus_<schema>.py``): the
port's mesh executor (``Executor(mesh=...)`` over four shards on the
CPU) against the reference on one corpus query.

* Rows, row order, the six ExecStats fields and backend calls are held
  to the reference's single-device run in this process.
* ``collective_ops``, ``join_physical`` and ``pipeline_syncs`` (and
  the rows again) are held to the reference's own mesh executor, which
  needs four JAX devices: one subprocess per schema runs this file as a
  script under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
  and writes every query's numbers to a JSON file:

      python tests/torch_shard_check.py corpus <schema> <out.json>

Both sides plan under the default ``CostParams()`` at the scale of
``tests/test_sharded.py``; on the CPU ``auto`` resolves to the host
paths, which skip the partitioned tier, so the reference runs at
``kernel_impl="ref"`` and the port at ``"ref"`` and ``"kernel"``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import benchmarks.corpus as corpus  # noqa: E402

N_SHARDS = 4
SCALE = 0.15
STAT_FIELDS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
               "sem_rows", "rel_rows")
MESH_FIELDS = ("collective_ops", "join_physical", "pipeline_syncs")


def specs(schema: str) -> list:
    return [s for s in corpus.ALL_QUERIES if s.schema == schema]


def _freeze(recs):
    def fz(v):
        return "NaN" if isinstance(v, float) and v != v else v
    return [[[k, fz(v)] for k, v in sorted(r.items())] for r in recs]


def _reference_run(spec, db, mesh=None):
    from repro.core import optimize
    from repro.engine import Executor
    from repro.semantic import OracleBackend, SemanticRunner

    opt = optimize(spec.build(), db.catalog(), strategy="cost")
    backend = OracleBackend(truths=db.truths)
    ex = Executor(db, SemanticRunner(backend), kernel_impl="ref", mesh=mesh)
    table, stats = ex.execute(opt.plan)
    rows = _freeze(db.materialize(table, list(spec.out_cols)))
    return rows, stats, backend.calls


def _reference_db(schema: str):
    """A fresh database per query on both sides: a base table's first
    use costs fetches that a reused one would not."""
    from repro.data import SCHEMAS

    return SCHEMAS[schema](seed=0, scale=SCALE)


_SINGLE: dict = {}


def reference_single(spec) -> tuple:
    """The reference's single-device run at ``kernel_impl="ref"``
    (once per query and process)."""
    if spec.qid not in _SINGLE:
        _SINGLE[spec.qid] = _reference_run(spec, _reference_db(spec.schema))
    return _SINGLE[spec.qid]


def _mesh_env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count="
                          f"{N_SHARDS}")


def reference_mesh(schema: str, tmp_dir: Path) -> dict:
    """Every query of ``schema`` through the reference's mesh executor on
    four forced host devices, in one subprocess: qid -> rows, calls and
    the mesh fields."""
    out = tmp_dir / f"mesh_{schema}.json"
    subprocess.run([sys.executable, __file__, "corpus", schema, str(out)],
                   env=_mesh_env(), check=True, timeout=600, cwd=str(ROOT))
    return json.loads(out.read_text())


def port_run(spec, impl: str):
    """The port's mesh executor over four CPU shards."""
    import repro_torch.core as port_core
    from repro_torch.data import SCHEMAS as PORT_SCHEMAS
    from repro_torch.engine import Executor
    from repro_torch.semantic import OracleBackend, SemanticRunner
    from repro_torch.sharding import make_data_mesh

    saved = corpus.Q, corpus.col
    corpus.Q, corpus.col = port_core.Q, port_core.col
    try:
        plan = spec.build()
    finally:
        corpus.Q, corpus.col = saved
    db = PORT_SCHEMAS[spec.schema](seed=0, scale=SCALE, device="cpu")
    opt = port_core.optimize(plan, db.catalog(), strategy="cost")
    backend = OracleBackend(truths=db.truths)
    mesh = make_data_mesh(N_SHARDS, devices=["cpu"] * N_SHARDS)
    ex = Executor(db, SemanticRunner(backend), kernel_impl=impl, mesh=mesh)
    table, stats = ex.execute(opt.plan)
    rows = _freeze(db.materialize(table, list(spec.out_cols)))
    return rows, stats, backend.calls


def check(spec, impl: str, single: tuple, mesh: dict) -> None:
    """The port's mesh run at ``impl`` against the reference's
    single-device run (``single``) and its mesh run (``mesh``)."""
    rows, stats, calls = port_run(spec, impl)
    want_rows, want, want_calls = single
    assert rows == want_rows, (spec.qid, impl)
    for f in STAT_FIELDS:
        assert getattr(stats, f) == getattr(want, f), (spec.qid, impl, f)
    assert calls == want_calls, (spec.qid, impl)
    assert rows == mesh["rows"], (spec.qid, impl)
    assert calls == mesh["calls"], (spec.qid, impl)
    for f in MESH_FIELDS:
        assert getattr(stats, f) == mesh[f], (spec.qid, impl, f)


def _corpus_main(schema: str, out: str) -> None:
    from repro.sharding import make_data_mesh

    mesh = make_data_mesh(N_SHARDS)
    res = {}
    for spec in specs(schema):
        rows, stats, calls = _reference_run(spec, _reference_db(schema),
                                            mesh)
        res[spec.qid] = {"rows": rows, "calls": calls,
                         **{f: getattr(stats, f) for f in MESH_FIELDS}}
    Path(out).write_text(json.dumps(res))


# ------------------------------------------------------------ the tier

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
TIER_IMPL = "interpret"  # the reference's Pallas K10, interpreted
# sync sites and collective sites the tier ticks
SYNC_SITES = ("shard_merge", "shard_reduce", "shard_join_probe")


def tier_cases() -> dict:
    """name -> numpy inputs, made from seeds: key tables ("keys_*",
    (N, C) int32), value columns for the min/max cases ("vals_*", over
    the "keys_minmax" table) and join sides ("join_*": build keys, probe
    keys)."""
    rng = np.random.default_rng(0)
    i32 = np.int32
    cases = {
        "keys_multikey": np.stack([rng.integers(-1000, 1000, 777),
                                   rng.integers(0, 5, 777)], 1).astype(i32),
        "keys_extremes": np.array([[INT32_MAX], [INT32_MIN], [0],
                                   [INT32_MAX]], dtype=i32),
        "keys_empty": np.zeros((0, 2), dtype=i32),
        "keys_skew": np.full((2048, 1), 7, dtype=i32),
        "keys_small": rng.integers(-9, 9, (513, 2)).astype(i32),
        "keys_groups": np.stack([rng.integers(-20, 20, 4000),
                                 rng.integers(0, 3, 4000)], 1).astype(i32),
        "keys_hot": np.where(rng.random(3000) < 0.7, -5,
                             rng.integers(-50000, 50000, 3000))
        .astype(i32)[:, None],
        "keys_wide": rng.integers(INT32_MIN, INT32_MAX, (200, 3),
                                  dtype=np.int64).astype(i32)[
            rng.integers(0, 200, 1500)],
    }
    # min/max: 48 groups of ~25 rows; group g's values by g % 8
    n, g = 1200, 48
    k = rng.integers(0, g, n).astype(i32)
    cases["keys_minmax"] = k[:, None]
    f = (rng.normal(size=n) * 100).astype(np.float32)
    for gi in range(g):
        rows = np.flatnonzero(k == gi)
        kind = gi % 8
        if kind == 0:
            f[rows[0]] = np.nan
        elif kind == 1:
            f[rows[len(rows) // 2]] = np.nan
        elif kind == 2:
            f[rows[-1]] = np.nan
        elif kind == 3:
            f[rows] = np.nan
        elif kind in (4, 5):  # signed zeros only, -0.0 first or +0.0 first
            z = np.where(np.arange(len(rows)) % 2 == kind - 4, -0.0, 0.0)
            f[rows] = z.astype(np.float32)
        elif kind == 6:
            f[rows[::3]] = np.inf
            f[rows[1::3]] = -np.inf
    cases["vals_f32"] = f
    v = rng.integers(INT32_MIN, INT32_MAX, n, dtype=np.int64).astype(i32)
    v[::7] = INT32_MIN
    v[3::7] = INT32_MAX
    cases["vals_i32"] = v
    big, small = INT32_MAX, INT32_MIN
    cases["join_random"] = (rng.integers(0, 100, 300).astype(i32),
                            rng.integers(0, 120, 1000).astype(i32))
    cases["join_extremes"] = (np.array([big, 7, small, big], dtype=i32),
                              np.array([big, small, 0, big, 7], dtype=i32))
    cases["join_none"] = (np.array([1, 2, 3], dtype=i32),
                          np.array([4, 5], dtype=i32))
    cases["join_skew"] = (
        np.concatenate([np.full(50, 3), rng.integers(0, 40, 200)])
        .astype(i32),
        np.concatenate([np.full(500, 3), rng.integers(0, 60, 700)])
        .astype(i32))
    return cases


def _keys(cases: dict) -> list:
    return [k for k in cases if k.startswith("keys_")]


def _counts(out: dict, label: str, snap0: dict, snap1: dict) -> None:
    """The collectives and tier fetches ticked between two snapshots."""
    for site in SYNC_SITES:
        out[f"{label}.sync.{site}"] = np.int64(
            snap1["by_site"].get(site, 0) - snap0["by_site"].get(site, 0))
    for site in ("exchange_aggregate", "exchange_join_build",
                 "exchange_join_probe"):
        out[f"{label}.coll.{site}"] = np.int64(
            snap1["by_collective"].get(site, 0)
            - snap0["by_collective"].get(site, 0))


def _plan_out(out: dict, label: str, st, gid) -> None:
    plan, reps = st.group_plan()
    for f in ("seg", "counts", "order", "starts"):
        out[f"{label}.plan.{f}"] = np.asarray(getattr(plan, f))
    out[f"{label}.plan.num_groups"] = np.int64(plan.num_groups)
    out[f"{label}.plan.reps"] = np.asarray(reps)
    out[f"{label}.gid"] = gid


def reference_tier(mesh) -> dict:
    """Every tier output of the reference on ``mesh``."""
    import jax.numpy as jnp

    from repro.engine import Table
    from repro.kernels.sync import HOST_SYNCS
    from repro.sharding import (
        PartitionCache,
        partition_columns,
        sharded_join_match,
        sharded_segment_reduce,
    )

    cases = tier_cases()
    out = {}
    for name in _keys(cases):
        keys = cases[name]
        s0 = HOST_SYNCS.snapshot()
        st = partition_columns(
            [jnp.asarray(keys[:, i]) for i in range(keys.shape[1])],
            len(keys), mesh, site="exchange_aggregate", impl=TIER_IMPL)
        out[f"{name}.data"] = np.asarray(st.data)
        out[f"{name}.boundary"] = np.asarray(st.boundary)
        _plan_out(out, name, st, np.asarray(st.gid_device()))
        if name == "keys_minmax":
            for vname in ("vals_f32", "vals_i32"):
                for op in ("min", "max"):
                    out[f"{name}.{vname}.{op}"] = np.asarray(
                        sharded_segment_reduce(
                            st, jnp.asarray(cases[vname]), op))
        _counts(out, name, s0, HOST_SYNCS.snapshot())
    cache = PartitionCache(mesh)
    for name in [k for k in cases if k.startswith("join_")]:
        build, probe = cases[name]
        t = Table(columns={"b.k": jnp.asarray(build)},
                  valid=jnp.ones(len(build), dtype=bool))
        s0 = HOST_SYNCS.snapshot()
        pl, bl = sharded_join_match(cache, t, "b.k", jnp.asarray(probe),
                                    impl=TIER_IMPL)
        out[f"{name}.probe_rows"], out[f"{name}.build_rows"] = pl, bl
        _counts(out, name, s0, HOST_SYNCS.snapshot())
    return out


def port_tier(mesh, impl: str) -> dict:
    """Every tier output of the port on ``mesh`` at ``impl``, under the
    reference's names."""
    import torch

    from repro_torch.engine import Table
    from repro_torch.kernels.sync import HOST_SYNCS
    from repro_torch.sharding import (
        PartitionCache,
        partition_columns,
        sharded_join_match,
        sharded_segment_reduce,
    )

    cases = tier_cases()
    out = {}
    for name in _keys(cases):
        keys = cases[name]
        s0 = HOST_SYNCS.snapshot()
        st = partition_columns(
            [torch.as_tensor(keys[:, i]) for i in range(keys.shape[1])],
            len(keys), mesh, site="exchange_aggregate", impl=impl)
        out[f"{name}.data"] = np.concatenate(
            [d.numpy() for d in st.data], axis=1)
        out[f"{name}.boundary"] = np.concatenate(
            [b.numpy() for b in st.boundary])
        _plan_out(out, name, st, np.concatenate(
            [g.numpy() for g in st.gid_device()]))
        if name == "keys_minmax":
            for vname in ("vals_f32", "vals_i32"):
                for op in ("min", "max"):
                    out[f"{name}.{vname}.{op}"] = sharded_segment_reduce(
                        st, torch.as_tensor(cases[vname]), op, impl=impl)
        _counts(out, name, s0, HOST_SYNCS.snapshot())
    cache = PartitionCache(mesh)
    for name in [k for k in cases if k.startswith("join_")]:
        build, probe = cases[name]
        t = Table(columns={"b.k": torch.as_tensor(build)},
                  valid=torch.ones(len(build), dtype=torch.bool))
        s0 = HOST_SYNCS.snapshot()
        pl, bl = sharded_join_match(cache, t, "b.k",
                                    torch.as_tensor(probe), impl=impl)
        out[f"{name}.probe_rows"], out[f"{name}.build_rows"] = pl, bl
        _counts(out, name, s0, HOST_SYNCS.snapshot())
    return out


def reference_tier_mesh(tmp_dir: Path) -> dict:
    """``reference_tier`` on four forced host devices, in a subprocess."""
    out = tmp_dir / "tier.npz"
    subprocess.run([sys.executable, __file__, "tier", str(out)],
                   env=_mesh_env(), check=True, timeout=600, cwd=str(ROOT))
    with np.load(out) as z:
        return dict(z)


def _tier_main(out: str) -> None:
    from repro.sharding import make_data_mesh

    np.savez(out, **reference_tier(make_data_mesh(N_SHARDS)))


if __name__ == "__main__":
    if sys.argv[1] == "corpus":
        _corpus_main(sys.argv[2], sys.argv[3])
    else:
        _tier_main(sys.argv[2])
