"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python chip_smoke.py

Phases, each printing one JSON line:

1. ``build`` — builds the CUDA kernels from ``src/repro_torch/csrc``
   with nvcc (sm_90a) and reports the build time and the card;
2. ``kernels`` — holds every kernel (K1 prefix count, K2 FNV-1a row
   hash, K3 group boundaries, K4 running segment ids) bit-identical to
   its plain PyTorch version on the card, at edge sizes up to 2^24 and
   on the edge inputs each kernel must handle;
3. ``e2e`` — a 2^24-row fact table joined to a 2^16-row dimension with
   a semantic filter on the dimension's text and a two-key group-by,
   optimised under the sort-merge join configuration and executed at
   ``kernel_impl="auto"``; it must launch all four kernels and match
   the port's own ``kernel_impl="host"`` run in rows, row order, the
   six ExecStats fields and backend calls;
4. ``corpus`` — corpus queries of all five schemas at scale 1.0, held
   to the host run in the same way;
5. the ``kernels`` line: per kernel, its launches in the e2e run and,
   at the largest shape that run gave it, its device time, its plain
   version's, the byte bound and one PyTorch library call's time where
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


def check_kernels(device, sizes=EDGE_SIZES, seed: int = 0):
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

    g = torch.Generator(device=device).manual_seed(seed)
    cases = {"prefix_count": 0, "hash_rows": 0, "group_boundaries": 0,
             "running_segment_ids": 0}
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


def run_query(db, plan, out_cols, impl: str, split: dict | None = None):
    """Optimise ``plan`` under the sort-merge configuration and execute
    it at ``impl``. Returns (frozen rows, stats, backend calls); fills
    ``split`` with the host-clock seconds of each stage."""
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
    opt = optimize(plan, cat, strategy="cost",
                   params=CostParams(**SORT_MERGE))
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


def run_corpus(device, scale: float = 1.0) -> dict:
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
        got = run_query(db, build(), cols, "auto")
        wall = time.perf_counter() - t0
        hold_to_host(qid, got, run_query(db, build(), cols, "host"))
        out[qid] = {"rows": len(got[0]), "wall_s": wall,
                    "llm_calls": got[1].llm_calls,
                    "join_physical": got[1].join_physical}
    return {"queries": out, "launches": dict(_build.LAUNCHES)}


# ------------------------------------------------- timing at main-path shapes

def kernel_rows(device, launches: dict, shapes: dict, max_err: dict,
                seed: int = 1) -> list[dict]:
    """Time each kernel at the largest shape the e2e run gave it: the
    kernel, its plain version and the library call each as CUDA-graph
    replays (device time only), and the kernel's wrapper also as one
    eager call between two events (``wrapper_eager_ms``, which adds the
    wrapper's host work where the card waits for it)."""
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

    g = torch.Generator(device=device).manual_seed(seed)
    rows = []

    def row(name, source, replaces, kern, plain, library, n_bytes, n_ops,
            shape):
        outs, wants = kern(), plain()
        if not isinstance(outs, tuple):
            outs, wants = (outs,), (wants,)
        err = max([max_err.get(name, 0)] + [_same(a, b, name)
                                            for a, b in zip(outs, wants)])
        b, by = bound_ms(n_bytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": err, "shape": list(shape),
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(library) if library else None,
            "wrapper_eager_ms": eager_ms(kern),
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
    return rows


# ------------------------------------------------------------------- main

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
    missing = [k for k, v in e2e["launches"].items() if v == 0]
    if missing:
        raise AssertionError(f"e2e: kernels never launched: {missing}")

    t0 = time.perf_counter()
    corpus = run_corpus(device)
    emit({"phase": "corpus", **corpus, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    missing = [k for k, v in corpus["launches"].items() if v == 0]
    if missing:
        raise AssertionError(f"corpus: kernels never launched: {missing}")

    rows = kernel_rows(device, e2e["launches"], e2e["shapes"], errs)
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
