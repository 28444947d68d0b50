"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python chip_smoke.py

Phases, each printing one JSON line:

1. ``build`` — builds the CUDA kernels from ``src/repro_torch/csrc``
   with nvcc (sm_90a, one process per source, all started together)
   and reports the build time and the card;
2. ``kernels`` — holds every kernel against its plain PyTorch version
   on the card, at edge sizes up to 2^24 and on the edge inputs each
   kernel must handle: K1 prefix count, K2 FNV-1a row hash, K3 group
   boundaries, K4 running segment ids and K6 radix rank bit-identical;
   K5 segmented reduction over {sum, min, max} x {int32, float32} and
   G in {1, 16, 4097, 2^20} with NaN, ±inf, -0.0, empty segments and a
   hot segment — bit-identical except float32 sums, which are held to
   the float32 accumulation bound (min/max compared after mapping every
   NaN to one code and -0.0 to +0.0);
3. ``e2e`` — a 2^24-row fact table joined to a 2^16-row dimension with
   a semantic filter on the dimension's text and a two-key group-by,
   optimised under the sort-merge join configuration and executed at
   ``kernel_impl="auto"``; it must launch K1-K4 and match the port's
   own ``kernel_impl="host"`` run in rows, row order, the six
   ExecStats fields and backend calls;
4. ``e2e_hash`` — the default configuration users run: the 2^24-row
   fact table joined to a 2^22-row user table and the dimension, both
   joins planned ``hash`` under ``CostParams()``, then the semantic
   filter and a group-by with count and int32/float32 min/max; it must
   launch K1, K4, K5 and K6 and match the host run the same way;
5. ``corpus`` — corpus queries of all five schemas at scale 1.0, under
   the sort-merge configuration and again under ``CostParams()`` (hash
   joins), each held to the host run in the same way;
6. ``stream`` — a standing query over a 2^20-row fact table fed 8
   micro-batches of 2^16 rows; the fact table is the build side of a
   hash join served by the incremental stream table, and after every
   batch the standing output equals a cold host run on the
   concatenated data;
7. the ``kernels`` line: per kernel, its launches in the run of the
   path it belongs to (``e2e`` for K1-K4, ``e2e_hash`` for K5 and K6)
   and, at the largest shape that run gave it, its device time, its
   plain version's, the bound and one PyTorch library call's time where
   one computes the same function (each timed as CUDA-graph replays,
   so no host work is counted), plus the wrapper's eager call time.

It then prints the card's name and power limit as nvidia-smi reports
them and, last, ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; so does a machine without CUDA. Imports nothing of
the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM (NVIDIA data sheet): HBM3 rate and the float32 rate outside
# the tensor cores, the peak this script charges 32-bit integer ALU
# work against
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
SORT_MERGE = dict(w_hash_build=1e9, w_host_join=1e9)
DEFAULT = {}  # CostParams(): every base-table join is planned hash
G_SIZES = (1, 16, 4097, 1 << 20)
F32_NAN_BITS = 0x7fc00000
STAT_FIELDS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
               "sem_rows", "rel_rows")
EDGE_SIZES = (1, 1023, 1024, 1025, 65537, 1 << 24)
INT32_MAX = 2**31 - 1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

def eager_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median time of one eager ``fn()`` call in ms, between two CUDA
    events recorded around it: the device time plus any time the card
    waits for the call's host work (allocation, checks, launches)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms(fn, reps: int = 30, inner: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` in ms, free of host work: ``fn`` is
    captured once into a CUDA graph (its allocations, checks and launch
    calls run at capture), and each of ``reps`` samples replays the
    graph ``inner`` times between two CUDA events. Returns the median
    sample over ``inner``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel checks

def _same(a, b, what: str) -> int:
    """Max absolute difference between a kernel's output ``a`` and its
    plain version's ``b``; raises unless they are bit-identical (the
    stated tolerance is 0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: shape/dtype {tuple(a.shape)} "
                             f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    if err:
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version by up to {err}")
    return err


def _marks_from_counts(counts, total: int, device):
    """+1 marks at each segment start (empty segments stack; starts at
    ``total`` drop), the K4 input the expansion builds."""
    import torch

    starts = torch.cumsum(counts, 0) - counts
    marks = torch.zeros(total + 1, dtype=torch.int32, device=device)
    marks.index_add_(0, starts.long(),
                     torch.ones_like(starts, dtype=torch.int32))
    return marks[:total].contiguous()


def minmax_bits(t):
    """float32 results as int32 codes for an exact comparison: every
    NaN maps to one code and -0.0 to +0.0; int32 passes through."""
    import torch

    if not t.is_floating_point():
        return t
    bits = (t + 0.0).view(torch.int32)
    return torch.where(torch.isnan(t), F32_NAN_BITS, bits)


def k5_cases(n: int, g: int, dtype, gen, device, finite: bool):
    """K5 inputs on ``device``: ids spread over [0, g) with every third
    segment empty, a hot segment taking ~90% of the rows, and sorted
    ids; float32 values carry NaN, ±inf, -0.0 and +0.0 unless
    ``finite``, int32 values span the whole range."""
    import torch

    if dtype == torch.int32:
        vals = torch.randint(-2**31, INT32_MAX, (n,), generator=gen,
                             device=device, dtype=torch.int32)
    else:
        vals = torch.randn(n, generator=gen, device=device) * 100
        if not finite:
            special = torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), -0.0, 0.0],
                                   device=device)
            pick = torch.rand(n, generator=gen, device=device) < 0.05
            which = torch.randint(0, 5, (n,), generator=gen, device=device)
            vals = torch.where(pick, special[which], vals)
    spread = torch.randint(0, g, (n,), generator=gen, device=device,
                           dtype=torch.int32)
    if g > 2:
        spread = torch.where(spread % 3 == 1, spread - 1, spread)
    hot = torch.where(torch.rand(n, generator=gen, device=device) < 0.9,
                      g // 2, spread).to(torch.int32)
    return [(vals, spread), (vals, hot), (vals, torch.sort(spread)[0])]


def sum_error(got, vals, seg, g: int) -> tuple[float, float]:
    """Max |float32 segment sum - float64 sum| and its largest ratio to
    the float32 accumulation bound count * 2^-23 * sum|v|; raises where
    the error exceeds the bound."""
    import torch

    dev = vals.device
    idx = seg.long()
    exact = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
        0, idx, vals.double())
    mag = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
        0, idx, vals.double().abs())
    cnt = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
        0, idx, torch.ones(idx.shape[0], dtype=torch.float64, device=dev))
    err = (got.double() - exact).abs()
    bound = cnt * 2.0**-23 * mag
    if bool((err > bound).any()):
        raise AssertionError(f"K5 float sum g={g}: error {float(err.max())} "
                             f"beyond the float32 accumulation bound")
    ratio = torch.where(bound > 0, err / bound, torch.zeros_like(err))
    return float(err.max()), float(ratio.max())


def k6_digit_cases(n: int, gen, device, buckets: int = 256):
    """K6 digits: all equal, uniform, and skewed (half in one bucket)."""
    import torch

    few = torch.randint(0, min(buckets, 5), (n,), generator=gen,
                        device=device, dtype=torch.int32)
    skew = torch.where(torch.rand(n, generator=gen, device=device) < 0.5,
                       3, few).to(torch.int32)
    return [torch.full((n,), buckets - 1, dtype=torch.int32, device=device),
            torch.randint(0, buckets, (n,), generator=gen, device=device,
                          dtype=torch.int32), skew]


def exclusive_bases(digits, buckets: int = 256):
    import torch

    hist = torch.zeros(buckets, dtype=torch.int64, device=digits.device)
    hist.index_add_(0, digits.long(), torch.ones_like(digits, dtype=torch.int64))
    return (torch.cumsum(hist, 0) - hist).to(torch.int32)


def check_kernels(device, sizes=EDGE_SIZES, seed: int = 0,
                  g_sizes=G_SIZES):
    """Every kernel against its plain version on ``device``. Returns
    the cases checked and the max absolute difference per kernel."""
    import torch

    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.compact.ref import prefix_count_torch
    from repro_torch.kernels.expand.expand import running_segment_ids_kernel
    from repro_torch.kernels.expand.ref import running_segment_ids_torch
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.hash_dedup import hash_rows_kernel
    from repro_torch.kernels.hash_dedup.ref import (
        group_boundaries_ref, hash_rows_np, hash_rows_ref)
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)

    g = torch.Generator(device=device).manual_seed(seed)
    cases = {"prefix_count": 0, "hash_rows": 0, "group_boundaries": 0,
             "running_segment_ids": 0, "segment_reduce": 0,
             "radix_rank": 0}
    errs = dict.fromkeys(cases, 0)

    def same(name, a, b, what):
        errs[name] = max(errs[name], _same(a, b, what))
        cases[name] += 1

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=torch.int32)

    for n in sizes:
        # K1: 0/1 flags, all-zero, all-one, small counts
        for flags in (rint(0, 2, (n,)), torch.zeros(n, dtype=torch.int32,
                      device=device), torch.ones(n, dtype=torch.int32,
                      device=device), rint(0, 5, (n,))):
            same("prefix_count", prefix_count_kernel(flags),
                 prefix_count_torch(flags), f"K1 n={n}")
        # K4: k > 1 marks where empty segments stack, trailing empties
        counts = rint(0, 4, (max(n // 2, 1),)).long()
        total = int(counts.sum())
        if total:
            marks = _marks_from_counts(counts, total, device)
            same("running_segment_ids", running_segment_ids_kernel(marks),
                 running_segment_ids_torch(marks), f"K4 n={total}")
        # K2: C in {1, 2, 4}, negative keys; also against numpy FNV
        for c in (1, 2, 4):
            keys = rint(-2**31, INT32_MAX, (n, c))
            kern = hash_rows_kernel(keys)
            same("hash_rows", kern, hash_rows_ref(keys), f"K2 n={n} c={c}")
            if n <= 65537:
                want = hash_rows_np(keys.cpu().numpy()).view(np.int32)
                if not np.array_equal(kern.cpu().numpy(), want):
                    raise AssertionError(f"K2 n={n} c={c}: differs from "
                                         f"hash_rows_np")
        # K3: sorted keys with a run of INT32_MAX (the reference's pad
        # value, an ordinary key here), a wide run, INT32_MIN ties,
        # all-equal
        top = torch.sort(rint(INT32_MAX - 8, INT32_MAX, (n,)))[0]
        top[n - n // 3:] = INT32_MAX
        wide = torch.sort(rint(-2**31, INT32_MAX, (n,)))[0]
        low = torch.sort(rint(-2**31, -2**31 + 3, (n,)))[0]
        for k in (top, wide, low, torch.full_like(top, 7)):
            bk, gk = group_boundaries_kernel(k)
            br, gr = group_boundaries_ref(k)
            same("group_boundaries", bk, br, f"K3 bnd n={n}")
            same("group_boundaries", gk, gr, f"K3 gid n={n}")
        # K6: all-equal, uniform and skewed digits
        for d in k6_digit_cases(n, g, device):
            base = exclusive_bases(d)
            same("radix_rank", radix_rank_kernel(d, base),
                 radix_rank_torch(d, base), f"K6 n={n}")
        # K5: every op and dtype over spread/hot/sorted ids
        for gs in g_sizes:
            for dt in (torch.int32, torch.float32):
                for op in ("sum", "min", "max"):
                    fsum = op == "sum" and dt == torch.float32
                    for v, sg in k5_cases(n, gs, dt, g, device, fsum):
                        kern = segment_reduce_kernel(v, sg, gs, op)
                        what = f"K5 {op} {dt} n={n} g={gs}"
                        if fsum:
                            err, ratio = sum_error(kern, v, sg, gs)
                            errs["segment_reduce_f32_sum"] = max(
                                errs.get("segment_reduce_f32_sum", 0.0), err)
                            errs["segment_reduce_f32_sum_over_bound"] = max(
                                errs.get("segment_reduce_f32_sum_over_bound",
                                         0.0), ratio)
                            cases["segment_reduce"] += 1
                            continue
                        plain = segment_reduce_torch(v, sg, gs, op)
                        if kern.dtype != plain.dtype or not torch.equal(
                                minmax_bits(kern), minmax_bits(plain)):
                            raise AssertionError(f"{what}: kernel differs "
                                                 f"from its plain version")
                        cases["segment_reduce"] += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cases, errs


# ---------------------------------------------------------------- the e2e

PHI_SEASONAL = ("Is the category '{cats.name}' seasonal? "
                "Answer YES or NO.")


def e2e_tables(n_events: int, n_cats: int, seed: int = 0):
    """Columns of ``events(event_id, cat_id, region)`` and
    ``cats(cat_id, name)``, made from ``seed``; ~20% of the events
    reference no category."""
    rng = np.random.default_rng(seed)
    events = {
        "event_id": np.arange(n_events, dtype=np.int64),
        "cat_id": rng.integers(0, int(n_cats * 1.25), n_events),
        "region": rng.integers(0, 16, n_events),
    }
    seasonal = rng.random(n_cats) < 0.5
    words = np.array(["winter", "garden", "office", "beach", "kitchen",
                      "travel", "school", "holiday"])
    kind = words[rng.integers(0, len(words), n_cats)]
    cats = {
        "cat_id": np.arange(n_cats, dtype=np.int64),
        "name": [f"{k} goods line {i}" for i, k in enumerate(kind)],
        "_seasonal": seasonal,
    }
    truths = {PHI_SEASONAL: lambda ctx: bool(ctx["cats"]["_seasonal"])}
    return {"events": events, "cats": cats}, {"cats": ["name"]}, truths


def e2e_plan(Q, col):
    return (Q.scan("events")
            .where(col("events.region") != 3)
            .join(Q.scan("cats"), "events.cat_id", "cats.cat_id")
            .sem_filter(PHI_SEASONAL)
            .group_by(["events.region", "cats.cat_id"],
                      [("count", "*", "n"), ("sum", "events.event_id", "s"),
                       ("avg", "events.event_id", "a")])
            .build())


def _freeze(recs):
    def fz(v):
        return "NaN" if isinstance(v, float) and v != v else v
    return [tuple((k, fz(v)) for k, v in sorted(r.items())) for r in recs]


def run_query(db, plan, out_cols, impl: str, split: dict | None = None,
              params: dict = SORT_MERGE):
    """Optimise ``plan`` under ``CostParams(**params)`` (by default the
    sort-merge configuration) and execute it at ``impl``. Returns
    (frozen rows, stats, backend calls); fills ``split`` with the
    host-clock seconds of each stage."""
    import torch

    from repro_torch.core import CostParams, optimize
    from repro_torch.engine import Executor
    from repro_torch.semantic import OracleBackend, SemanticRunner

    def sync():
        if db.device.type == "cuda":
            torch.cuda.synchronize(db.device)

    t0 = time.perf_counter()
    cat = db.catalog()
    t1 = time.perf_counter()
    opt = optimize(plan, cat, strategy="cost", params=CostParams(**params))
    backend = OracleBackend(truths=db.truths)
    ex = Executor(db, SemanticRunner(backend), kernel_impl=impl)
    t2 = time.perf_counter()
    table, stats = ex.execute(opt.plan)
    sync()
    t3 = time.perf_counter()
    rows = _freeze(db.materialize(table, list(out_cols)))
    sync()
    t4 = time.perf_counter()
    if split is not None:
        split.update(catalog_s=t1 - t0, optimize_s=t2 - t1,
                     execute_s=t3 - t2, rel_s=stats.rel_wall_s,
                     sem_s=stats.sem_wall_s, materialize_s=t4 - t3)
    return rows, stats, backend.calls


def hold_to_host(label: str, got, want) -> None:
    rows, stats, calls = got
    rows_h, stats_h, calls_h = want
    if rows != rows_h:
        raise AssertionError(f"{label}: rows differ from the host run "
                             f"({len(rows)} vs {len(rows_h)})")
    for f in STAT_FIELDS:
        if getattr(stats, f) != getattr(stats_h, f):
            raise AssertionError(f"{label}: {f} {getattr(stats, f)} != "
                                 f"host {getattr(stats_h, f)}")
    if calls != calls_h:
        raise AssertionError(f"{label}: backend calls {calls} != {calls_h}")
    if not all(np.isfinite(v) for r in rows for _, v in r
               if isinstance(v, float)):
        raise AssertionError(f"{label}: non-finite aggregate")


def run_e2e(device, n_events: int = 1 << 24, n_cats: int = 1 << 16
            ) -> dict:
    import torch

    from repro_torch.core import Q, col
    from repro_torch.engine import database_from_numpy
    from repro_torch.kernels import _build

    tables, texts, truths = e2e_tables(n_events, n_cats)
    t0 = time.perf_counter()
    db = database_from_numpy(tables, texts, truths, device=device)
    load_s = time.perf_counter() - t0
    out = ["events.region", "cats.cat_id", "agg.n", "agg.s", "agg.a"]
    plan = e2e_plan(Q, col)
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
        torch.cuda.reset_peak_memory_stats(db.device)
    _build.reset_launches()
    split = {}
    t0 = time.perf_counter()
    got = run_query(db, plan, out, "auto", split)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    shapes = dict(_build.MAX_SHAPES)
    peak = (torch.cuda.max_memory_allocated(db.device)
            if db.device.type == "cuda" else None)
    host_split = {}
    t0 = time.perf_counter()
    want = run_query(db, plan, out, "host", host_split)
    host_wall = time.perf_counter() - t0
    hold_to_host("e2e", got, want)
    if len(got[0]) == 0:
        raise AssertionError("e2e: empty result")
    return {"rows": len(got[0]), "n_events": n_events, "n_cats": n_cats,
            "load_s": load_s, "wall_s": wall, "split": split,
            "host_wall_s": host_wall, "host_split": host_split,
            "peak_device_bytes": peak, "launches": launches,
            "shapes": {k: list(v) for k, v in shapes.items()},
            "stats": {f: getattr(got[1], f) for f in STAT_FIELDS},
            "pipeline_syncs": got[1].pipeline_syncs,
            "join_physical": got[1].join_physical}


# ------------------------------------------------------- the e2e, hashed

def e2e_hash_tables(n_events: int, n_users: int, n_cats: int,
                    seed: int = 0):
    """``e2e_tables`` plus ``events.user_id`` (~9% dangling) and
    ``events.amount`` (finite float32), and ``users(user_id, tier)``
    with eight tiers."""
    tables, texts, truths = e2e_tables(n_events, n_cats, seed)
    rng = np.random.default_rng(seed + 1)
    ev = tables["events"]
    ev["user_id"] = rng.integers(0, int(n_users * 1.1), n_events)
    ev["amount"] = (rng.gamma(2.0, 50.0, n_events)
                    - 20.0).astype(np.float32)
    tables["users"] = {"user_id": np.arange(n_users, dtype=np.int64),
                       "tier": rng.integers(0, 8, n_users)}
    return tables, texts, truths


def e2e_hash_plan(Q, col):
    return (Q.scan("events")
            .where(col("events.region") != 3)
            .join(Q.scan("users"), "events.user_id", "users.user_id")
            .join(Q.scan("cats"), "events.cat_id", "cats.cat_id")
            .sem_filter(PHI_SEASONAL)
            .group_by(["events.region", "users.tier"],
                      [("count", "*", "n"),
                       ("min", "events.amount", "amin"),
                       ("max", "events.amount", "amax"),
                       ("min", "events.event_id", "emin"),
                       ("max", "events.event_id", "emax")])
            .build())


def run_e2e_hash(device, n_events: int = 1 << 24, n_users: int = 1 << 22,
                 n_cats: int = 1 << 16) -> dict:
    import torch

    from repro_torch.core import Q, col
    from repro_torch.engine import database_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels.hash_join import ref as hj_ref

    tables, texts, truths = e2e_hash_tables(n_events, n_users, n_cats)
    t0 = time.perf_counter()
    db = database_from_numpy(tables, texts, truths, device=device)
    load_s = time.perf_counter() - t0
    out = ["events.region", "users.tier", "agg.n", "agg.amin", "agg.amax",
           "agg.emin", "agg.emax"]
    plan = e2e_hash_plan(Q, col)
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
        torch.cuda.reset_peak_memory_stats(db.device)
    _build.reset_launches()
    hj_ref.reset_loop_fetches()
    split = {}
    t0 = time.perf_counter()
    got = run_query(db, plan, out, "auto", split, params=DEFAULT)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    shapes = dict(_build.MAX_SHAPES)
    loop_fetches = dict(hj_ref.LOOP_FETCHES)
    peak = (torch.cuda.max_memory_allocated(db.device)
            if db.device.type == "cuda" else None)
    host_split = {}
    t0 = time.perf_counter()
    want = run_query(db, plan, out, "host", host_split, params=DEFAULT)
    host_wall = time.perf_counter() - t0
    hold_to_host("e2e_hash", got, want)
    if len(got[0]) == 0:
        raise AssertionError("e2e_hash: empty result")
    if got[1].join_physical != {"hash": 2}:
        raise AssertionError(f"e2e_hash: joins served by "
                             f"{got[1].join_physical}, not two hash joins")
    return {"rows": len(got[0]), "n_events": n_events, "n_users": n_users,
            "n_cats": n_cats, "load_s": load_s, "wall_s": wall,
            "split": split, "host_wall_s": host_wall,
            "host_split": host_split, "peak_device_bytes": peak,
            "launches": launches, "radix_passes": launches["radix_rank"],
            "loop_fetches": loop_fetches,
            "loop_check_every": hj_ref.LOOP_CHECK_EVERY,
            "shapes": {k: list(v) for k, v in shapes.items()},
            "stats": {f: getattr(got[1], f) for f in STAT_FIELDS},
            "pipeline_syncs": got[1].pipeline_syncs,
            "host_pipeline_syncs": want[1].pipeline_syncs,
            "join_physical": got[1].join_physical}


# ------------------------------------------------------------- the corpus

def corpus_specs(Q, col, S):
    """(qid, schema, out_cols, builder) — corpus queries Q5, Q13, Q16,
    Q23, Q25 and q8 of ``benchmarks/corpus.py``, built with the port's
    ``Q``: every schema, two-table semantic templates (the sem_joins of
    Q16 and Q25) and grouped aggregates."""
    return [
        ("Q5", "bookreview", ["books.title", "reviews.review_id"],
         lambda: (Q.scan("books")
                  .join(Q.scan("reviews"), "books.book_id",
                        "reviews.book_id")
                  .where(col("reviews.rating") >= 3)
                  .sem_filter(S.BOOKS_ABOUT_AI)
                  .sem_filter(S.REVIEW_POSITIVE)
                  .select("books.title", "reviews.review_id").build())),
        ("Q13", "yelp", ["businesses.biz_id", "agg.cnt"],
         lambda: (Q.scan("businesses")
                  .join(Q.scan("yreviews"), "businesses.biz_id",
                        "yreviews.biz_id")
                  .sem_filter(S.YELP_REVIEW_SERVICE)
                  .group_by(["businesses.biz_id"], [("count", "*", "cnt")])
                  .build())),
        ("Q16", "googlelocal", ["places.place_id", "greviews.review_id"],
         lambda: (Q.scan("places")
                  .where(col("places.rating") >= 4.5)
                  .sem_join(Q.scan("greviews")
                            .where(col("greviews.rating") <= 2)
                            .where(col("greviews.time") >= 2022),
                            S.GL_REVIEW_DESCRIBES_PLACE)
                  .select("places.place_id", "greviews.review_id").build())),
        ("Q23", "tpch", ["part.p_partkey", "supplier.s_suppkey"],
         lambda: (Q.scan("part")
                  .join(Q.scan("partsupp"), "part.p_partkey",
                        "partsupp.ps_partkey")
                  .join(Q.scan("supplier"), "partsupp.ps_suppkey",
                        "supplier.s_suppkey")
                  .where(col("part.p_size").between(1, 40))
                  .sem_filter(S.PART_FRAGILE)
                  .sem_filter(S.SUPPLIER_RELIABLE)
                  .select("part.p_partkey", "supplier.s_suppkey").build())),
        ("Q25", "tpch", ["supplier.s_suppkey", "nation.n_name"],
         lambda: (Q.scan("supplier")
                  .sem_join(Q.scan("nation"), S.NATION_MATCHES_SUPPLIER)
                  .select("supplier.s_suppkey", "nation.n_name").build())),
        ("q8", "ecommerce", ["products.product_id", "agg.cnt"],
         lambda: (Q.scan("products")
                  .join(Q.scan("previews"), "products.product_id",
                        "previews.product_id")
                  .sem_filter(S.ECOM_REVIEW_POSITIVE)
                  .group_by(["products.product_id"], [("count", "*", "cnt")])
                  .build())),
    ]


def run_corpus(device, scale: float = 1.0, params: dict = SORT_MERGE
               ) -> dict:
    from repro_torch.core import Q, col
    from repro_torch.data import SCHEMAS
    from repro_torch.data import schemas as S
    from repro_torch.kernels import _build

    dbs = {}
    out = {}
    _build.reset_launches()
    for qid, schema, cols, build in corpus_specs(Q, col, S):
        if schema not in dbs:
            dbs[schema] = SCHEMAS[schema](seed=0, scale=scale, device=device)
        db = dbs[schema]
        t0 = time.perf_counter()
        got = run_query(db, build(), cols, "auto", params=params)
        wall = time.perf_counter() - t0
        hold_to_host(qid, got, run_query(db, build(), cols, "host",
                                         params=params))
        out[qid] = {"rows": len(got[0]), "wall_s": wall,
                    "llm_calls": got[1].llm_calls,
                    "join_physical": got[1].join_physical}
    return {"queries": out, "launches": dict(_build.LAUNCHES)}


# ---------------------------------------------------------- the stream

def stream_plan(Q):
    """The fact table as the BUILD side of a hash join (so every append
    grows the incremental stream table), the semantic filter on the
    probe side's text, and a group-by with count and min/max."""
    return (Q.scan("cats")
            .join(Q.scan("events"), "cats.cat_id", "events.cat_id")
            .sem_filter(PHI_SEASONAL)
            .group_by(["events.region"],
                      [("count", "*", "n"), ("min", "events.amount", "lo"),
                       ("max", "events.event_id", "hi")])
            .build())


def run_stream(device, n_base: int = 1 << 20, n_batch: int = 1 << 16,
               n_batches: int = 8, n_cats: int = 1 << 16,
               impl: str = "auto") -> dict:
    """A ``StreamSession`` over an ``n_base``-row fact table, fed
    ``n_batches`` appends of ``n_batch`` rows; after every batch the
    standing output must equal a cold ``kernel_impl="host"`` run on the
    concatenated data, and the batch's LLM calls the cold run's delta."""
    import torch

    from repro_torch.core import CostParams, Q, optimize
    from repro_torch.engine import Executor, database_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels.sync import HOST_SYNCS
    from repro_torch.semantic import OracleBackend, SemanticRunner
    from repro_torch.streaming import StreamSession

    total = n_base + n_batch * n_batches
    tables, texts, truths = e2e_hash_tables(total, 1 << 10, n_cats, seed=3)
    ev = tables.pop("events")
    tables.pop("users")
    tables["events"] = {k: v[:n_base] for k, v in ev.items()}
    db = database_from_numpy(tables, texts, truths, device=device)
    out_cols = ["events.region", "agg.n", "agg.lo", "agg.hi"]
    plan = optimize(stream_plan(Q), db.catalog(), strategy="cost",
                    params=CostParams()).plan
    _build.reset_launches()
    sess = StreamSession(db, OracleBackend(truths=db.truths),
                         kernel_impl=impl)
    t0 = time.perf_counter()
    sq = sess.register("q", plan, out_cols=out_cols)
    prime_s = time.perf_counter() - t0
    prev_cold_llm = sq.last_stats.llm_calls
    names = list(ev)
    batches = []
    for b in range(n_batches):
        lo = n_base + b * n_batch
        cols = {k: ev[k][lo:lo + n_batch].tolist() for k in names}
        recs = [dict(zip(names, row)) for row in zip(*cols.values())]
        probe0 = HOST_SYNCS.by_site.get("stream_probe", 0)
        t0 = time.perf_counter()
        d = sess.ingest("events", recs)["q"]
        if db.device.type == "cuda":
            torch.cuda.synchronize(db.device)
        ingest_s = time.perf_counter() - t0
        cold_ex = Executor(db, SemanticRunner(OracleBackend(
            truths=db.truths)), kernel_impl="host")
        cold_t, cold_st = cold_ex.execute(plan)
        cold = _freeze(db.materialize(cold_t, out_cols))
        if _freeze(d.output) != cold:
            raise AssertionError(f"stream: batch {b} differs from the cold "
                                 f"host run")
        if d.stats.llm_calls != cold_st.llm_calls - prev_cold_llm:
            raise AssertionError(f"stream: batch {b} llm_calls "
                                 f"{d.stats.llm_calls} != cold delta")
        prev_cold_llm = cold_st.llm_calls
        build = sess.ctx.builds[("events", "events.cat_id")]
        batches.append({
            "batch": b, "rows": db.tables["events"].capacity,
            "ingest_refresh_s": ingest_s,
            "stream_probe_syncs": HOST_SYNCS.by_site.get("stream_probe", 0)
            - probe0,
            "pipeline_syncs": d.stats.pipeline_syncs,
            "llm_calls": d.stats.llm_calls,
            "join_physical": d.stats.join_physical,
            "rebuilds": build.rebuilds, "inserts": build.inserts})
    if not all(b["join_physical"].get("stream") for b in batches):
        raise AssertionError("stream: a batch's join was not served by the "
                             "stream table")
    return {"n_base": n_base, "n_batch": n_batch, "prime_s": prime_s,
            "batches": batches, "launches": dict(_build.LAUNCHES)}


# ------------------------------------------------- timing at main-path shapes

def kernel_rows(device, launches: dict, shapes: dict, max_err: dict,
                by_path: dict, seed: int = 1) -> list[dict]:
    """Time each kernel at the largest shape its path's run gave it
    (``launches``/``shapes``: K1-K4 from ``e2e``, K5/K6 from
    ``e2e_hash``): the kernel, its plain version and the library call
    each as CUDA-graph replays (device time only), and the kernel's
    wrapper also as one eager call between two events
    (``wrapper_eager_ms``, which adds the wrapper's host work where the
    card waits for it). ``by_path`` holds every path's launch counts."""
    import torch

    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.compact.ref import prefix_count_torch
    from repro_torch.kernels.expand.expand import running_segment_ids_kernel
    from repro_torch.kernels.expand.ref import running_segment_ids_torch
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.hash_dedup import hash_rows_kernel
    from repro_torch.kernels.hash_dedup.ref import (
        group_boundaries_ref, hash_rows_ref)
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.hash_join.ops import _radix_order
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)

    g = torch.Generator(device=device).manual_seed(seed)
    rows = []

    def row(name, source, replaces, kern, plain, library, n_bytes, n_ops,
            shape, err=None, **extra):
        if err is None:
            outs, wants = kern(), plain()
            if not isinstance(outs, tuple):
                outs, wants = (outs,), (wants,)
            err = max([max_err.get(name, 0)] + [
                _same(a, b, name) for a, b in zip(outs, wants)])
        b, by = bound_ms(n_bytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": err, "shape": list(shape),
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(library) if library else None,
            "wrapper_eager_ms": eager_ms(kern), **extra,
        })

    n = shapes["prefix_count"][0]
    flags = torch.randint(0, 2, (n,), generator=g, device=device,
                          dtype=torch.int32)
    row("prefix_count", "src/repro_torch/csrc/compact.cu",
        "src/repro/kernels/compact/compact.py:50",
        lambda: prefix_count_kernel(flags),
        lambda: prefix_count_torch(flags),
        lambda: torch.cumsum(flags, 0, dtype=torch.int32),
        8 * n, n, (n,))

    n, c = shapes["hash_rows"]
    keys = torch.randint(-2**31, INT32_MAX, (n, c), generator=g,
                         device=device, dtype=torch.int32)
    row("hash_rows", "src/repro_torch/csrc/hash_rows.cu",
        "src/repro/kernels/hash_dedup/hash_dedup.py:51",
        lambda: hash_rows_kernel(keys), lambda: hash_rows_ref(keys), None,
        4 * n * (c + 1), 16 * n * c, (n, c))

    n = shapes["group_boundaries"][0]
    sk = torch.sort(torch.randint(0, max(n // 4, 1), (n,), generator=g,
                                  device=device, dtype=torch.int32))[0]
    row("group_boundaries", "src/repro_torch/csrc/group_build.cu",
        "src/repro/kernels/hash_dedup/group_build.py:61",
        lambda: group_boundaries_kernel(sk),
        lambda: group_boundaries_ref(sk), None,
        12 * n, 3 * n, (n,))

    n = shapes["running_segment_ids"][0]
    counts = torch.randint(0, 3, (n // 2 + 1,), generator=g, device=device)
    marks = _marks_from_counts(counts, n, device)
    row("running_segment_ids", "src/repro_torch/csrc/expand.cu",
        "src/repro/kernels/expand/expand.py:49",
        lambda: running_segment_ids_kernel(marks),
        lambda: running_segment_ids_torch(marks),
        lambda: torch.cumsum(marks, 0, dtype=torch.int32),
        8 * n, 2 * n, (n,))

    # K5 at the group-by's (rows, groups): float32 max, the aggregate
    # the path runs; min/max are exact, so held bit for bit here
    n, gs = shapes["segment_reduce"]
    vals = torch.randn(n, generator=g, device=device) * 100
    seg = torch.randint(0, gs, (n,), generator=g, device=device,
                        dtype=torch.int32)
    seg64 = seg.long()
    kern5 = segment_reduce_kernel(vals, seg, gs, "max")
    if not torch.equal(minmax_bits(kern5),
                       minmax_bits(segment_reduce_torch(vals, seg, gs,
                                                        "max"))):
        raise AssertionError("K5 at the e2e_hash shape differs from its "
                             "plain version")
    row("segment_reduce", "src/repro_torch/csrc/segment_reduce.cu",
        "src/repro/kernels/segmented_reduce/segmented_reduce.py:71",
        lambda: segment_reduce_kernel(vals, seg, gs, "max"),
        lambda: segment_reduce_torch(vals, seg, gs, "max"),
        lambda: torch.full((gs,), -float("inf"), device=device)
        .scatter_reduce_(0, seg64, vals, reduce="amax", include_self=True),
        8 * n + 4 * gs, n, (n, gs),
        err=max(max_err.get("segment_reduce", 0),
                max_err.get("segment_reduce_f32_sum", 0.0)),
        library_call="scatter_reduce_(amax)",
        exact_cases_max_abs_err=max_err.get("segment_reduce", 0),
        f32_sum_max_abs_err=max_err.get("segment_reduce_f32_sum", 0.0),
        f32_sum_max_err_over_bound=max_err.get(
            "segment_reduce_f32_sum_over_bound", 0.0),
        f32_sum_tolerance="count * 2^-23 * sum|v| per segment")

    # K6 at the largest radix pass: 8-bit digits of a slot key; the
    # chained order of a whole build side is timed beside it
    n = shapes["radix_rank"][0]
    hbits = max(int(2 * n - 1).bit_length(), 10)
    slot_key = torch.randint(0, 1 << hbits, (n,), generator=g,
                             device=device, dtype=torch.int32)
    digit = slot_key & 255
    base = exclusive_bases(digit)
    row("radix_rank", "src/repro_torch/csrc/radix_rank.cu",
        "src/repro/kernels/hash_join/hash_join.py:57",
        lambda: radix_rank_kernel(digit, base),
        lambda: radix_rank_torch(digit, base),
        lambda: torch.sort(digit, stable=True),
        8 * n, n, (n,), library_call="torch.sort(stable=True)",
        order_key_bits=hbits,
        order_ms=time_ms(lambda: _radix_order(slot_key, key_bits=hbits)),
        order_argsort_ms=time_ms(
            lambda: torch.argsort(slot_key, stable=True)))
    order = _radix_order(slot_key, key_bits=hbits)
    if not torch.equal(order.long(), torch.argsort(slot_key, stable=True)):
        raise AssertionError("K6 chained order differs from the stable "
                             "argsort")
    return rows


# ------------------------------------------------------------------- main

# kernels each main path must launch
SORT_MERGE_KERNELS = ("prefix_count", "hash_rows", "group_boundaries",
                      "running_segment_ids")
HASH_KERNELS = ("prefix_count", "running_segment_ids", "segment_reduce",
                "radix_rank")


def require_launched(path: str, launches: dict, names) -> None:
    missing = [k for k in names if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_INFO.get("seconds"),
          "cached": _build.BUILD_INFO.get("cached"), "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    ptxas = [ln.strip() for ln in _build.BUILD_INFO.get("log", "").split("\n")
             if "registers" in ln or "== " in ln]
    emit({"phase": "ptxas", "lines": ptxas})

    t0 = time.perf_counter()
    cases, errs = check_kernels(device)
    emit({"phase": "kernels", "bit_identical_cases": cases,
          "max_abs_err": errs, "tolerance": 0,
          "sizes": list(EDGE_SIZES), "seconds": time.perf_counter() - t0,
          "gpu": smi})

    e2e = run_e2e(device)
    emit({"phase": "e2e", **e2e, "gpu": smi})
    require_launched("e2e", e2e["launches"], SORT_MERGE_KERNELS)

    e2e_hash = run_e2e_hash(device)
    emit({"phase": "e2e_hash", **e2e_hash, "gpu": smi})
    require_launched("e2e_hash", e2e_hash["launches"], HASH_KERNELS)

    corpus = {}
    for config, params, need in (("sort_merge", SORT_MERGE,
                                  SORT_MERGE_KERNELS),
                                 ("default", DEFAULT, ("radix_rank",))):
        t0 = time.perf_counter()
        corpus[config] = run_corpus(device, params=params)
        emit({"phase": "corpus", "config": config, **corpus[config],
              "seconds": time.perf_counter() - t0, "gpu": smi})
        require_launched(f"corpus {config}", corpus[config]["launches"], need)

    t0 = time.perf_counter()
    stream = run_stream(device)
    emit({"phase": "stream", **stream, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    require_launched("stream", stream["launches"],
                     ("radix_rank", "segment_reduce"))

    launches = dict(e2e["launches"])
    shapes = dict(e2e["shapes"])
    for k in ("segment_reduce", "radix_rank"):
        launches[k] = e2e_hash["launches"][k]
        shapes[k] = e2e_hash["shapes"][k]
    rows = kernel_rows(device, launches, shapes, errs,
                       {"e2e": e2e["launches"],
                        "e2e_hash": e2e_hash["launches"]})
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
