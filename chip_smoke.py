"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python chip_smoke.py

Phases, each printing one JSON line:

1. ``build`` — builds the CUDA kernels from ``src/repro_torch/csrc``
   with nvcc (sm_90a, one process per source, all started together)
   and reports the build time and the card;
2. ``kernels`` — holds every kernel against its plain PyTorch version
   on the card, at edge sizes up to 2^24 and on the edge inputs each
   kernel must handle: K1 prefix count, K2 FNV-1a row hash, K3 group
   boundaries, K4 running segment ids, K6 radix rank and K10 shard rank
   (over ``repro_torch.kernels.partition_cases``: P in {1, 2, 4, 8, 32},
   uniform / one-bucket / half-hot destinations, fixed-stride or random
   offsets) bit-identical; K1, K4 and K3 (one-pass look-back scans)
   also over ``repro_torch.kernels.scan_cases``: sizes around the tile,
   each input kind (K3: sorted keys whose runs cross stripes, warp runs
   and tile edges, a key change at every tile edge, all equal,
   INT32_MIN/INT32_MAX runs, strictly increasing) repeated 50 times,
   views not 16-byte aligned, 200 replays of one captured CUDA graph on
   alternating inputs, and two calls on two streams at once; K5 (one
   memset and one launch) also over
   ``repro_torch.kernels.reduce_cases``: sizes around its batch, G in
   {1, 120, 256} and its shared limit and one either side, every op and
   dtype over NaN payloads, denormals and int32 extremes, ids outside
   [0, G), views not 16-byte aligned, 200 graph replays and two streams,
   bit for bit (float sums within their bound); K6 (a one-pass
   look-back rank) also over
   ``repro_torch.kernels.radix_cases``: sizes around its tile, five
   digit kinds, B in {1, 4, 7, 256, 1024}, each case repeated 20 times
   (at B <= 32 also equal to K10), graph replays and two streams;
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
7. ``e2e_sharded`` — the ``e2e_hash`` tables and query planned under
   ``CostParams(n_shards=4)`` and run by the partitioned mesh executor
   over four shards of the card (``make_data_mesh(4, devices=[card] *
   4)``), cold then warm on one executor; both held to the
   single-device kernel run and the host run in rows, order, the six
   ExecStats fields and backend calls; both joins ``partitioned``,
   collectives within 2 per join + 1 per grouped aggregate, K1, K2, K5
   and K10 launched; prints the walls, their split, the collectives by
   site and the peak memory;
8. ``sharded_stream`` — ``benchmarks/bench_sharded.py``'s workload at
   2^24 facts and 2^16 dims: its grouped aggregate and its join 8
   times each on the mesh and on one device, every output identical,
   the collective budget (aggregate <= 1 cold and 0 warm, join <= 2
   cold and exactly 1 warm), per-query walls of both. Four shards on
   one card measure the tier's kernels, layout and host merges, not
   an interconnect;
9. ``attention`` — K7 (flash attention) and K8 (flash-decode) against
   their plain versions on unit-normal inputs: K7 at S in {1, 63, 64,
   65, 128, 1000}, GQA group in {1, 2, 12}, head_dim in {36, 64, 80,
   128} (36 and 80 zero-padded to K7's tiles), causal and not, through
   the model's transposed (B, S, H, d) views,
   and causal with a sliding window of {1, 17, 64} at S = 1000; K8 at T
   in {1, 131, 1000} with rows of lengths {1, 2, T-1, T} in one batch,
   through the model's permuted (B, T, K, d) cache, and with the
   reference's slot mask over wrapped rings of 16 and 64 slots (entries
   above pos, entries too old for the window, empty slots); within 1e-4
   (float32 sums over <= 1000 keys in another order); then K8 at the
   edges of its split over the cache (``check_decode_split``): lengths
   around its chunk over 131- and 4104-position caches, a full
   2048-slot ring, rings with dead chunks between live ones, each call
   equal bit for bit to a second one, and 200 graph replays per mask
   on alternating inputs. The sweep and its tolerance are
   ``repro_torch.kernels.attention_cases``, which the card tests share;
10. ``ssd`` — K9 (the SSD intra-chunk step) against its plain version,
   all four outputs, over ``repro_torch.kernels.ssd_cases``: chunk in
   {64, 128}, s in {1, chunk-1, chunk, chunk+1, 4 chunk+3} (padded as
   ``ops.ssd`` pads), (h, p, n) in {(1, 16, 16), (32, 64, 128),
   (50, 64, 16)}, b in {1, 16}, on the model's distribution (dt =
   softplus(3 N), A = -U[1, 16]: exp above the diagonal overflows) and
   strided layout; then ``ops.ssd`` against the sequential oracle at
   (1, 1000, 4, 16, 16, 128); within ``ssd_cases.tolerance``;
11. ``serve`` — starcoder2-3b at full width (30 layers, d_model 3072,
   24 query heads over 2 KV heads, head_dim 128, float32 weights from a
   seeded generator) behind ``ServingEngine(batch_size=16, max_seq=128,
   max_new_tokens=2)``: 256 prompts made from a seed, served
   continuously with K7/K8 (``attn_impl="auto"``) and again with the
   plain grouped einsum (``"ref"``); the answers must be identical, K7
   must launch once per layer per admission and K8 once per layer per
   round; prints admissions, rounds, prefill/decode device seconds
   (CUDA events around the scheduler's ``_admit``/``_round``), rates,
   syncs, peak memory and one admission's prefill-logit difference;
   then serves 64 of the prompts in two waves half a batch apart, so
   slots are freed and refilled while others are mid-decode, and holds
   the K7/K8 engine's token ids to the plain engine's there too;
12. ``llm_query`` — five corpus queries (one per schema, scale 0.15,
   ``CostParams()``) through per-schema ``FrontDoor``s sharing one
   runner over ``ModelBackend.from_engine`` on the same starcoder2-3b
   engine, once with K7/K8 and once with the plain attention: rows,
   order, ``llm_calls``, ``cache_hits``, ``pipeline_syncs``,
   ``serving_syncs``, backend calls and the token ids the model emitted
   for every prompt must be equal;
13. ``serve_ssm`` and ``serve_hybrid`` — the same serving checks with
   mamba2-370m (48 SSM layers, d_model 1024, 32 heads x 64, state 128,
   chunk 128) and hymba-1.5b (32 layers, d_model 1600, attention of 25
   query over 5 KV heads with window 2048 beside 50 SSM heads x 64,
   state 16, chunk 64) at full width, 128 prompts each, kernel path
   (K9, and K7/K8 for the hybrid) against the plain path (grouped
   einsum and ``ssd_chunked``, no kernel): identical answers and token
   ids (two-wave run included), K9 once per layer per admission, and
   one admission's prefill logits, SSM ``state`` and ``conv`` compared;
14. ``long_prefill`` — the shapes admissions never reach: mamba2-370m
   prefills 2 x 2048 tokens (16 chunks), hymba-1.5b 1 x 4096 tokens
   into a 4104-position cache (a 2048-slot ring; the window cuts) and
   decodes 8 steps past the wrap, both paths, logits (and the SSM
   state) within LONG_TOLERANCE of max|plain|;
15. ``llm_query_hybrid`` — Q13 and q8 through ``ModelBackend`` on the
   hymba-1.5b engines, held as ``llm_query`` holds its queries;
16. the ``kernels`` line: per kernel, its launches in the run of the
   path it belongs to (``e2e`` for K1-K4, ``e2e_hash`` for K5 and K6,
   ``serve`` for K7 and K8, ``serve_ssm`` for K9, the cold
   ``e2e_sharded`` run for K10; every path's counts
   beside) and, at the largest shape that run gave it, its device time,
   its plain version's, the bound and one PyTorch library call's time
   where one computes the same function (``torch.cumsum`` for K1/K4,
   ``scaled_dot_product_attention`` for K7/K8; each timed as
   CUDA-graph replays, so no host work is counted, except K3's
   ``torch.unique_consecutive``, which syncs the host and is timed as
   one eager call), plus the wrapper's
   eager call time; the scans (K1, K3, K4), K5, K6, K7, K8 and K9 also
   list their device activity over 20 calls under ``torch.profiler``
   (``device_kernels``: each kernel and memset with its count and device
   time per launch, beside the launches the wrappers counted; K3, K5,
   K6, K7, K8 and K9 must show one data kernel per call, K3, K5, K6 and
   K8 at most one memset beside it); K5 also at the radix histograms'
   shape (``radix_histogram``: int32 ones into 256 buckets, with
   ``index_add_`` as its library call and ``torch.bincount`` beside it,
   eager, since it syncs the host); K7 and K9, which run
   on the tensor cores as three TF32 products, carry their bound at
   that rate (a third of 495 TFLOP/s) beside the float32 CUDA-core one;
   K7 also with the hybrid's window and K8 with its slot mask at
   ``serve_hybrid``'s shapes (and both at ``long_prefill``'s: K8 over
   its 2048-slot ring with every slot live), K9 also at
   ``serve_hybrid``'s and ``long_prefill``'s shapes, with its head
   groups (``head_groups``) and blocks, K10
   also at P = 32 and beside K6 over the same P buckets.

Float32 matrix products run in full float32: TF32 is switched off for
cuBLAS and cuDNN, as the reference computes in float32.

It then prints the card's name and power limit as nvidia-smi reports
them and, last, ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; so does a machine without CUDA. Imports nothing of
the JAX package.
"""
from __future__ import annotations

import gc
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
# float32-accurate products on the tensor cores as three TF32 products
# (K7, K9): a third of the dense TF32 rate, 495 TFLOP/s
PEAK_TF32X3_OPS_PER_S = 495e12 / 3
SORT_MERGE = dict(w_hash_build=1e9, w_host_join=1e9)
DEFAULT = {}  # CostParams(): every base-table join is planned hash
G_SIZES = (1, 16, 4097, 1 << 20)
F32_NAN_BITS = 0x7fc00000
STAT_FIELDS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
               "sem_rows", "rel_rows")
EDGE_SIZES = (1, 1023, 1024, 1025, 65537, 1 << 24)
INT32_MAX = 2**31 - 1
SERVE_ARCH = "starcoder2-3b"
SERVE = dict(batch_size=16, max_seq=128, max_new_tokens=2)
SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "hymba-1.5b"
SSM_PROMPTS = 128
# the kernels of the LLM tier, each path's launches of them
LLM_KERNELS = ("flash_attention", "decode_attention", "ssd_chunk")
# long_prefill: kernel path against plain path at full width, relative
# to max|plain|: 48 (32) layers of float32 in which the SSD's chunk sums
# (K9 against ssd_chunked), the attention sums (K7/K8 against the
# grouped einsum) and the GEMMs' inputs differ in their last bits; the
# chunk step alone is held to ssd_cases.tolerance, 2^-23 max|cum| of
# max|plain|: 1e-4 to 1e-3 at the |cum| of 10^3 to 10^4 that random
# dt·A reach in a chunk
LONG_TOLERANCE = 1e-3
# the hybrid's corpus queries through ModelBackend
HYBRID_QIDS = ("Q13", "q8")


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


PAD_SPINS = 8  # device_kernels' throwaway spins (~50 us each)


def device_kernels(fn, calls: int = 20) -> dict:
    """Every device activity of ``calls`` eager ``fn()`` calls under
    ``torch.profiler`` (kernels and memsets by name), with its listed
    count and its device time per listed launch, the longest first,
    beside the launches the wrappers counted (``_build.LAUNCHES``) in
    the same calls. The window opens with ``PAD_SPINS`` short spin
    kernels, left out of the listing: late in this script the profiler
    leaves out the first device records of each window, however long
    the host waits before them and however many calls follow."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    fn()
    torch.cuda.synchronize()
    before = sum(_build.LAUNCHES.values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_SPINS):
            torch.cuda._sleep(100_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counted = sum(_build.LAUNCHES.values()) - before
    rows = [{"name": e.key, "count": e.count,
             "us_per_launch": e.self_device_time_total / e.count}
            for e in prof.key_averages() if e.self_device_time_total > 0
            and "spin_kernel" not in e.key]
    return {"calls": calls, "launches_counted": counted,
            "activities": sorted(rows, key=lambda r: -r["us_per_launch"])}


def one_data_kernel(label: str, fn, name: str, calls: int = 20,
                    memset: bool = False) -> dict:
    """``device_kernels(fn)``, which must show one launch per call: the
    wrappers counted ``calls`` launches, and the profiler lists one
    data kernel, ``name``, ``calls`` times, and (with ``memset``) at most
    one memset per call beside it."""
    listing = device_kernels(fn, calls)
    acts = listing["activities"]
    data = [a for a in acts if "Memset" not in a["name"]]
    sets = [a for a in acts if "Memset" in a["name"]]
    if listing["launches_counted"] != calls or len(data) != 1 or \
            name not in data[0]["name"] or data[0]["count"] != calls or \
            len(sets) > int(memset) or any(a["count"] > calls for a in sets):
        raise AssertionError(f"{label}: expected one {name} per call"
                             f"{' and at most one memset' if memset else ''}"
                             f", got {listing}")
    return listing


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bounds(n_bytes: float, n_ops: float) -> dict:
    """A tensor-core kernel's bound (K7, K9: operations at the
    three-TF32-product rate) and, beside it, the bound at the float32
    CUDA-core rate that the earlier design was held to."""
    b, by = bound_ms(n_bytes, n_ops, PEAK_TF32X3_OPS_PER_S)
    b32, by32 = bound_ms(n_bytes, n_ops)
    return {"bound_ms": b, "bound_by": by, "bound_f32_cores_ms": b32,
            "bound_f32_cores_by": by32}


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
    from repro_torch.kernels import partition_cases as PC
    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.partition.partition import shard_rank_kernel
    from repro_torch.kernels.partition.ref import shard_rank_torch
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)

    g = torch.Generator(device=device).manual_seed(seed)
    cases = {"prefix_count": 0, "hash_rows": 0, "group_boundaries": 0,
             "running_segment_ids": 0, "segment_reduce": 0,
             "radix_rank": 0, "shard_rank": 0}
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
            base = RC.exclusive_bases(d, 256)
            same("radix_rank", radix_rank_kernel(d, base),
                 radix_rank_torch(d, base), f"K6 n={n}")
        # K10: P in {1, 2, 4, 8, 32}, uniform / one-bucket / half-hot
        # destinations, fixed-stride or random exclusive offsets
        for _, p, dkind, bkind in PC.sweep((n,)):
            d = PC.dest_case(dkind, n, p, g, device)
            b = PC.base_case(bkind, d, p, g)
            same("shard_rank", shard_rank_kernel(d, b),
                 shard_rank_torch(d, b, p),
                 f"K10 n={n} p={p} {dkind} {bkind}")
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


def check_lookback(device, sizes=None, repeats=None, seed: int = 2):
    """K1, K4 and K3 over ``scan_cases``: every size and input kind (K3:
    every key kind), each call repeated ``repeats`` times against one
    plain result, the views at ``scan_cases.OFFSETS``, and on a card the
    graph replays and two streams. Returns the cases compared per
    kernel."""
    import torch

    from repro_torch.kernels import scan_cases as SC
    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.compact.ref import prefix_count_torch
    from repro_torch.kernels.expand.expand import running_segment_ids_kernel
    from repro_torch.kernels.expand.ref import running_segment_ids_torch
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.ref import group_boundaries_ref

    sizes = SC.SIZES if sizes is None else sizes
    repeats = SC.REPEATS if repeats is None else repeats
    g = torch.Generator(device=device).manual_seed(seed)
    k3 = SC.boundaries(group_boundaries_kernel)
    k3_plain = SC.boundaries(group_boundaries_ref)
    pairs = (("prefix_count", prefix_count_kernel, prefix_count_torch,
              SC.KINDS, SC.make_input, ("small", "ones")),
             ("running_segment_ids", running_segment_ids_kernel,
              running_segment_ids_torch, SC.KINDS, SC.make_input,
              ("small", "ones")),
             ("group_boundaries", k3, k3_plain, SC.KEY_KINDS, SC.make_keys,
              ("random", "increasing")))
    cases = {p[0]: 0 for p in pairs}
    for n in sizes:
        for name, kernel, plain, kinds, make, graphed in pairs:
            xs = {kind: make(kind, n, g, device) for kind in kinds}
            for kind, x in xs.items():
                want = plain(x)
                for r in range(repeats):
                    _same(kernel(x), want, f"{name} n={n} {kind} rep {r}")
                for off in SC.OFFSETS:
                    _same(kernel(SC.misaligned(x, off)), want,
                          f"{name} n={n} {kind} offset {off}")
                cases[name] += repeats + len(SC.OFFSETS)
            if device.type == "cuda":
                two = [xs[kind] for kind in graphed]
                wants = [plain(x) for x in two]
                cases[name] += SC.graph_replays(kernel, two, wants)
                cases[name] += SC.two_streams(kernel, two, wants)
            del xs
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cases


def check_reduce(device, sizes=None, segments=None, seed: int = 4):
    """K5 over ``reduce_cases``: every size, segment count, op, dtype and
    id kind against the plain version, the views at
    ``reduce_cases.OFFSETS``, and on a card the graph replays (int32
    sum, float32 min and max) and two streams. Returns the cases
    compared."""
    import torch

    from repro_torch.kernels import reduce_cases as RD
    from repro_torch.kernels import scan_cases as SC
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)

    sizes = RD.SIZES if sizes is None else sizes
    segments = RD.SEGMENTS if segments is None else segments
    g = torch.Generator(device=device).manual_seed(seed)
    cases = 0
    for n in sizes:
        for gs in segments:
            ids = {k: RD.make_ids(k, n, gs, g, device) for k in RD.ID_KINDS}
            for dt in RD.DTYPES:
                for op in RD.OPS:
                    fsum = op == "sum" and dt == torch.float32
                    v = RD.make_values(dt, n, g, device, finite=fsum)
                    for kind, s in ids.items():
                        want = segment_reduce_torch(v, s, gs, op)
                        views = [(v, s)] + [
                            (RD.misaligned(v, o), RD.misaligned(s, o))
                            for o in RD.OFFSETS if kind == "uniform"]
                        for vv, ss in views:
                            got = segment_reduce_kernel(vv, ss, gs, op)
                            if not RD.held(got, want, v, s, gs, op):
                                raise AssertionError(
                                    f"K5 {op} {dt} n={n} g={gs} {kind} "
                                    f"offset {vv.storage_offset()}: "
                                    f"differs from its plain version")
                            cases += 1
            if device.type == "cuda" and gs in (120, 256):
                for dt, op in ((torch.int32, "sum"), (torch.float32, "min"),
                               (torch.float32, "max")):
                    two = [RD.packed(RD.make_values(dt, n, g, device),
                                     ids[k]) for k in ("uniform", "hot")]
                    wants = [segment_reduce_torch(
                        x[:n].view(dt), x[n:], gs, op).view(torch.int32)
                        for x in two]
                    kernel = RD.unpacking(segment_reduce_kernel, n, dt, gs,
                                          op)
                    cases += SC.graph_replays(kernel, two, wants,
                                              RD.REPLAYS)
                    cases += SC.two_streams(kernel, two, wants)
            del ids
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cases


def check_radix(device, sizes=None, repeats=None, seed: int = 3):
    """K6 over ``radix_cases``: every size, digit kind and bucket count,
    each call repeated ``repeats`` times against one plain result, at
    B <= 32 also against K10, and on a card the graph replays and two
    streams. Returns the cases compared."""
    import torch

    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels import scan_cases as SC
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.partition.partition import (
        MAX_SHARDS, shard_rank_kernel)

    sizes = RC.SIZES if sizes is None else sizes
    repeats = RC.REPEATS if repeats is None else repeats
    g = torch.Generator(device=device).manual_seed(seed)
    cases = 0
    for n in sizes:
        for buckets in RC.BUCKETS:
            for kind in RC.KINDS:
                d = RC.make_digits(kind, n, buckets, g, device)
                base = RC.exclusive_bases(d, buckets)
                want = radix_rank_torch(d, base)
                for r in range(repeats):
                    _same(radix_rank_kernel(d, base), want,
                          f"K6 n={n} B={buckets} {kind} rep {r}")
                cases += repeats
                if buckets <= MAX_SHARDS:
                    _same(radix_rank_kernel(d, base),
                          shard_rank_kernel(d, base),
                          f"K6 against K10 n={n} B={buckets} {kind}")
                    cases += 1
        if device.type == "cuda":
            for buckets in (4, 256):
                ds = [RC.make_digits(kind, n, buckets, g, device)
                      for kind in ("uniform", "skewed")]
                bases = [RC.exclusive_bases(d, buckets) for d in ds]
                xs = [RC.packed(d, b) for d, b in zip(ds, bases)]
                wants = [radix_rank_torch(d, b) for d, b in zip(ds, bases)]
                kernel = RC.unpacking(radix_rank_kernel, n)
                cases += SC.graph_replays(kernel, xs, wants, RC.REPLAYS)
                cases += SC.two_streams(kernel, xs, wants)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cases


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


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_query(db, plan, out_cols, impl: str, split: dict | None = None,
              params: dict = SORT_MERGE):
    """Optimise ``plan`` under ``CostParams(**params)`` (by default the
    sort-merge configuration) and execute it at ``impl``. Returns
    (frozen rows, stats, backend calls); fills ``split`` with the
    host-clock seconds of each stage."""
    from repro_torch.core import CostParams, optimize
    from repro_torch.engine import Executor
    from repro_torch.semantic import OracleBackend, SemanticRunner

    t0 = time.perf_counter()
    cat = db.catalog()
    t1 = time.perf_counter()
    opt = optimize(plan, cat, strategy="cost", params=CostParams(**params))
    backend = OracleBackend(truths=db.truths)
    ex = Executor(db, SemanticRunner(backend), kernel_impl=impl)
    t2 = time.perf_counter()
    table, stats = ex.execute(opt.plan)
    _sync(db.device)
    t3 = time.perf_counter()
    rows = _freeze(db.materialize(table, list(out_cols)))
    _sync(db.device)
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


# ------------------------------------------------- the partitioned tier

def _execute(ex, db, plan, out_cols, split: dict):
    """Execute ``plan`` with ``ex`` and materialise ``out_cols``. Returns
    (frozen rows, stats, collectives by site); fills ``split`` with the
    host-clock seconds of each stage."""
    from repro_torch.kernels.sync import HOST_SYNCS

    coll0 = dict(HOST_SYNCS.by_collective)
    t0 = time.perf_counter()
    table, stats = ex.execute(plan)
    _sync(db.device)
    t1 = time.perf_counter()
    rows = _freeze(db.materialize(table, list(out_cols)))
    _sync(db.device)
    split.update(execute_s=t1 - t0, rel_s=stats.rel_wall_s,
                 sem_s=stats.sem_wall_s,
                 materialize_s=time.perf_counter() - t1)
    by = {k: v - coll0.get(k, 0) for k, v in HOST_SYNCS.by_collective.items()
          if v != coll0.get(k, 0)}
    return rows, stats, by


def run_e2e_sharded(device, n_events: int = 1 << 24, n_users: int = 1 << 22,
                    n_cats: int = 1 << 16, n_shards: int = 4,
                    impl: str = "auto") -> dict:
    """``e2e_hash``'s tables and query planned under
    ``CostParams(n_shards=4)`` and run by the mesh executor over
    ``n_shards`` shards of one card at ``impl``, cold then warm (the
    same executor: the build sides' layouts are cached), each held to
    the single-device run at ``impl`` and the host run on the same
    card. (On the CPU ``auto`` is the host path, which skips the mesh:
    rehearse there with ``impl="kernel"``.)"""
    import torch

    from repro_torch.core import CostParams, Q, col, optimize
    from repro_torch.core.plan import Aggregate, Join
    from repro_torch.engine import Executor, database_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.semantic import OracleBackend, SemanticRunner
    from repro_torch.sharding import make_data_mesh

    tables, texts, truths = e2e_hash_tables(n_events, n_users, n_cats)
    t0 = time.perf_counter()
    db = database_from_numpy(tables, texts, truths, device=device)
    load_s = time.perf_counter() - t0
    out = ["events.region", "users.tier", "agg.n", "agg.amin", "agg.amax",
           "agg.emin", "agg.emax"]
    mesh = make_data_mesh(n_shards, devices=[device] * n_shards)
    t0 = time.perf_counter()
    cat = db.catalog()
    t1 = time.perf_counter()
    plan = optimize(e2e_hash_plan(Q, col), cat, strategy="cost",
                    params=CostParams(n_shards=n_shards)).plan
    plan_split = {"catalog_s": t1 - t0,
                  "optimize_s": time.perf_counter() - t1}
    joins = sum(isinstance(n, Join) for n in plan.walk())
    aggs = sum(bool(isinstance(n, Aggregate) and n.group_by)
               for n in plan.walk())

    def executor(impl, m=None):
        backend = OracleBackend(truths=db.truths)
        return Executor(db, SemanticRunner(backend), kernel_impl=impl,
                        mesh=m), backend

    ex, backend = executor(impl, mesh)
    runs = {}
    for label in ("cold", "warm"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        _build.reset_launches()
        split = {}
        calls0 = backend.calls
        t0 = time.perf_counter()
        rows, stats, by = _execute(ex, db, plan, out, split)
        wall = time.perf_counter() - t0
        runs[label] = {
            "rows": rows, "stats": stats, "calls": backend.calls - calls0,
            "wall_s": wall, "split": split, "by_collective": by,
            "launches": dict(_build.LAUNCHES),
            "shapes": {k: list(v) for k, v in _build.MAX_SHAPES.items()},
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)}
    want = {}
    for label in ("single", "host"):
        e, b = executor(impl if label == "single" else "host")
        split = {}
        t0 = time.perf_counter()
        rows, stats, _ = _execute(e, db, plan, out, split)
        want[label] = {"rows": rows, "stats": stats, "calls": b.calls,
                       "wall_s": time.perf_counter() - t0, "split": split}
    for label, run in runs.items():
        got = (run["rows"], run["stats"], run["calls"])
        for other, w in want.items():
            hold_to_host(f"e2e_sharded {label} vs {other}", got,
                         (w["rows"], w["stats"], w["calls"]))
        st = run["stats"]
        if st.join_physical != {"partitioned": joins}:
            raise AssertionError(f"e2e_sharded {label}: joins served by "
                                 f"{st.join_physical}")
        if not 0 < st.collective_ops <= 2 * joins + aggs:
            raise AssertionError(f"e2e_sharded {label}: "
                                 f"{st.collective_ops} collectives")
    if len(runs["cold"]["rows"]) == 0:
        raise AssertionError("e2e_sharded: empty result")

    def summary(run):
        st = run["stats"]
        return {k: v for k, v in run.items() if k not in ("rows", "stats")
                } | {"stats": {f: getattr(st, f) for f in STAT_FIELDS},
                     "collective_ops": st.collective_ops,
                     "pipeline_syncs": st.pipeline_syncs,
                     "join_physical": st.join_physical}

    return {"rows": len(runs["cold"]["rows"]), "n_events": n_events,
            "n_users": n_users, "n_cats": n_cats, "n_shards": n_shards,
            "mesh": [str(d) for d in mesh.devices],
            "collective_budget": 2 * joins + aggs, "load_s": load_s,
            "plan_split": plan_split,
            "cold": summary(runs["cold"]), "warm": summary(runs["warm"]),
            "single_wall_s": want["single"]["wall_s"],
            "single_split": want["single"]["split"],
            "single_pipeline_syncs": want["single"]["stats"].pipeline_syncs,
            "host_wall_s": want["host"]["wall_s"],
            "host_split": want["host"]["split"]}


def sharded_stream_tables(n_facts: int, n_dims: int, seed: int = 0):
    """``benchmarks/bench_sharded.py``'s workload as columns: facts
    ``(fact_id, k1 in [0, 500), k2 in [0, 40), dim_id, v)`` and dims
    ``(dim_id, weight)``, made from ``seed``."""
    rng = np.random.default_rng(seed)
    facts = {"fact_id": np.arange(n_facts),
             "k1": rng.integers(0, 500, n_facts),
             "k2": rng.integers(0, 40, n_facts),
             "dim_id": rng.integers(0, n_dims, n_facts),
             "v": rng.normal(size=n_facts).astype(np.float32)}
    dims = {"dim_id": np.arange(n_dims),
            "weight": rng.normal(size=n_dims).astype(np.float32)}
    return {"facts": facts, "dims": dims}


def sharded_stream_plans(Q):
    agg = (Q.scan("facts")
           .group_by(["facts.k1", "facts.k2"],
                     aggs=[("count", "facts.v", "n"),
                           ("min", "facts.v", "lo"),
                           ("max", "facts.v", "hi")])
           .build())
    join = (Q.scan("facts")
            .join(Q.scan("dims"), "facts.dim_id", "dims.dim_id").build())
    return {"aggregate": (agg, ["facts.k1", "facts.k2", "agg.n", "agg.lo",
                                "agg.hi"], 1, 0),
            "join": (join, ["facts.fact_id", "dims.dim_id", "dims.weight"],
                     2, 1)}


def run_sharded_stream(device, n_facts: int = 1 << 24, n_dims: int = 1 << 16,
                       queries: int = 8, n_shards: int = 4,
                       impl: str = "auto") -> dict:
    """The grouped aggregate and the join of ``bench_sharded.py``, each
    run ``queries`` times by the mesh executor (``n_shards`` shards of
    one card) and by the single-device executor: every run's output
    columns identical, the reference's collective budget (aggregate
    <= 1 cold and 0 warm, join <= 2 cold and exactly 1 warm), per-query
    walls of both. (Rehearse on the CPU with ``impl="kernel"``.)"""
    from repro_torch.core import Q
    from repro_torch.engine import Executor, database_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels.util import to_numpy
    from repro_torch.semantic import OracleBackend, SemanticRunner
    from repro_torch.sharding import make_data_mesh

    db = database_from_numpy(sharded_stream_tables(n_facts, n_dims),
                             device=device)
    mesh = make_data_mesh(n_shards, devices=[device] * n_shards)
    runner = SemanticRunner(OracleBackend(truths={}))
    single = Executor(db, runner, kernel_impl=impl)
    part = Executor(db, runner, kernel_impl=impl, mesh=mesh)
    out = {"n_facts": n_facts, "n_dims": n_dims, "queries": queries,
           "n_shards": n_shards, "mesh": [str(d) for d in mesh.devices]}
    for name, (plan, cols, cold_max, warm) in sharded_stream_plans(
            Q).items():
        res = {}
        for label, ex in (("partitioned", part), ("single", single)):
            walls, colls, launches, last = [], [], [], None
            for _ in range(queries):
                _build.reset_launches()
                t0 = time.perf_counter()
                table, stats = ex.execute(plan)
                _sync(db.device)
                walls.append(time.perf_counter() - t0)
                colls.append(stats.collective_ops)
                launches.append(dict(_build.LAUNCHES))
                t = table.compact()
                cur = [to_numpy(t.col(c)) for c in cols]
                if last is not None and not all(
                        np.array_equal(a, b, equal_nan=True)
                        for a, b in zip(cur, last)):
                    raise AssertionError(f"sharded_stream {name} {label}: "
                                         f"a rerun's output differs")
                last = cur
            res[label] = {"walls_s": walls, "collectives": colls,
                          "launches": launches[0],
                          "warm_launches": launches[-1], "out": last}
        p, s = res["partitioned"], res["single"]
        if not all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(p.pop("out"), s.pop("out"))):
            raise AssertionError(f"sharded_stream {name}: mesh output "
                                 f"differs from the single-device run")
        if p["collectives"][0] > cold_max or any(
                c != warm for c in p["collectives"][1:]):
            raise AssertionError(f"sharded_stream {name}: collectives "
                                 f"{p['collectives']} (budget {cold_max} "
                                 f"cold, {warm} warm)")
        if any(s["collectives"]):
            raise AssertionError(f"sharded_stream {name}: the single-device "
                                 f"run exchanged")
        res["rows_out"] = int(table.num_valid)
        out[name] = res
    return out


# ------------------------------------------------------- attention kernels

def check_attention(device, seq=None, groups=None, dims=None,
                    cache_lens=None, windows=None, window_seq=None,
                    ring_windows=None, seed: int = 0) -> dict:
    """K7 and K8 against their plain versions on ``device`` (unit-normal
    inputs from ``seed``, in the model's layouts) over the sweep of
    ``attention_cases`` (or the given one): K7 causal and not, and
    causal with a sliding window; K8 with per-row lengths, and with the
    slot mask over a wrapped ring; raises above its tolerance. Returns
    the cases and the worst max|Δ| per kernel and mask."""
    import torch

    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    seq = seq or AC.SEQ_LENS
    groups = groups or AC.GROUPS
    dims = dims or AC.HEAD_DIMS
    cache_lens = cache_lens or AC.CACHE_LENS
    windows = windows or AC.WINDOWS
    window_seq = window_seq or AC.WINDOW_SEQ
    ring_windows = ring_windows or AC.RING_WINDOWS
    impl = "kernel" if device.type == "cuda" else "ref"
    g = torch.Generator(device=device).manual_seed(seed)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0,
            "flash_attention_window": 0.0, "decode_attention_ring": 0.0}
    cases = dict.fromkeys(errs, 0)

    def hold(name, got, want, what):
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not err <= AC.TOLERANCE:
            raise AssertionError(f"{what}: max|diff| {err} > "
                                 f"{AC.TOLERANCE}")
        errs[name] = max(errs[name], err)
        cases[name] += 1

    K, B = 2, 2
    for d in dims:
        for grp in groups:
            H = grp * K
            for S in seq:
                q = torch.randn(B, S, H, d, generator=g, device=device)
                k = torch.randn(B, S, K, d, generator=g, device=device)
                v = torch.randn(B, S, K, d, generator=g, device=device)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                for causal in (True, False):
                    hold("flash_attention",
                         flash_attention(qt, kt, vt, causal=causal,
                                         impl=impl),
                         attention_ref(qt, kt, vt, causal=causal),
                         f"K7 S={S} group={grp} d={d} causal={causal}")
            for T in cache_lens:
                lens = AC.decode_lengths(T)
                lengths = torch.tensor(lens, dtype=torch.int32,
                                       device=device)
                Bd = len(lens)
                q = torch.randn(Bd, H, d, generator=g, device=device)
                kc = torch.randn(Bd, T, K, d, generator=g, device=device)
                vc = torch.randn(Bd, T, K, d, generator=g, device=device)
                kt, vt = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
                hold("decode_attention",
                     decode_attention(q, kt, vt, lengths, impl=impl),
                     decode_attention_ref(q, kt, vt, lengths),
                     f"K8 T={T} lengths={lens} group={grp} d={d}")
            S = window_seq
            q = torch.randn(B, S, H, d, generator=g, device=device)
            k = torch.randn(B, S, K, d, generator=g, device=device)
            v = torch.randn(B, S, K, d, generator=g, device=device)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            for w in windows:
                hold("flash_attention_window",
                     flash_attention(qt, kt, vt, causal=True, window=w,
                                     impl=impl),
                     attention_ref(qt, kt, vt, causal=True, window=w),
                     f"K7 S={S} window={w} group={grp} d={d}")
            for W in ring_windows:
                rows = AC.ring_rows(W)
                sp = torch.tensor(AC.ring_slot_pos(W, rows),
                                  dtype=torch.int32, device=device)
                pos = torch.tensor([p for _, p in rows], dtype=torch.int32,
                                   device=device)
                Bd = len(rows)
                q = torch.randn(Bd, H, d, generator=g, device=device)
                kc, vc = (torch.randn(Bd, W, K, d, generator=g,
                                      device=device).permute(0, 2, 1, 3)
                          for _ in range(2))
                hold("decode_attention_ring",
                     decode_attention(q, kc, vc, slot_pos=sp, pos=pos,
                                      window=W, impl=impl),
                     decode_attention_ref(q, kc, vc, slot_pos=sp, pos=pos,
                                          window=W),
                     f"K8 ring W={W} rows={rows} group={grp} d={d}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"cases": cases, "max_abs_err": errs,
            "tolerance": AC.TOLERANCE}


def check_decode_split(device, groups=None, dims=(36, 64, 128),
                       seed: int = 4) -> dict:
    """K8 at the edges of its split over the cache (``attention_cases``):
    lengths at the chunk edges over 131- and 4104-position caches, a
    full 2048-slot ring, rings with dead chunks between live ones, each
    within the tolerance of the plain version and equal bit for bit on a
    second call; on a card, ``REPLAYS`` graph replays per mask on
    alternating inputs. Returns the cases and the worst max|diff|."""
    import torch

    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref)

    groups = groups or AC.GROUPS
    impl = "kernel" if device.type == "cuda" else "ref"
    g = torch.Generator(device=device).manual_seed(seed)
    out = {"cases": 0, "max_abs_err": 0.0, "graph_replays": 0}

    def operands(B, H, K, T, d):
        q = torch.randn(B, H, d, generator=g, device=device)
        kc, vc = (torch.randn(B, T, K, d, generator=g, device=device)
                  .permute(0, 2, 1, 3) for _ in range(2))
        return q, kc, vc

    def hold(run, want, what):
        got = run()
        err = float((got - want).abs().max())
        if not err <= AC.TOLERANCE or not torch.equal(run(), got):
            raise AssertionError(f"K8 {what}: max|diff| {err} > "
                                 f"{AC.TOLERANCE}, or a second call "
                                 f"differs")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["cases"] += 1

    sp_full, pos_full = AC.full_ring()
    rows, gpos, W = AC.gapped_ring()
    for d in dims:
        for grp in groups:
            K = 2
            for T in (131, AC.LONG_CACHE):
                lengths = torch.tensor(AC.chunk_lengths(T),
                                       dtype=torch.int32, device=device)
                q, kc, vc = operands(lengths.shape[0], grp * K, K, T, d)
                hold(lambda: decode_attention(q, kc, vc, lengths, impl=impl),
                     decode_attention_ref(q, kc, vc, lengths),
                     f"lengths {lengths.tolist()} group={grp} d={d}")
            for sp, pos, w in (([sp_full], [pos_full], AC.FULL_RING),
                               (rows, gpos, W)):
                spt = torch.tensor(sp, dtype=torch.int32, device=device)
                post = torch.tensor(pos, dtype=torch.int32, device=device)
                q, kc, vc = operands(len(sp), grp * K, K, len(sp[0]), d)
                hold(lambda: decode_attention(q, kc, vc, slot_pos=spt,
                                              pos=post, window=w, impl=impl),
                     decode_attention_ref(q, kc, vc, slot_pos=spt, pos=post,
                                          window=w),
                     f"ring of {len(sp[0])} group={grp} d={d}")
    if device.type == "cuda":
        from repro_torch.kernels.decode_attention.decode_attention import (
            decode_attention_kernel)

        lens = [torch.randint(1, 132, (16,), generator=g, device=device,
                              dtype=torch.int32) for _ in range(2)]
        xs = [(*operands(16, 24, 2, 131, 128), n) for n in lens]
        out["graph_replays"] += AC.graph_replays(
            decode_attention_kernel, xs,
            [decode_attention_ref(*x) for x in xs])
        spt = torch.tensor([sp_full], dtype=torch.int32, device=device)
        post = torch.tensor([pos_full], dtype=torch.int32, device=device)
        dead = torch.where(torch.arange(AC.FULL_RING, device=device) % 96
                           < 32, spt, -1)
        xs = [(*operands(1, 25, 5, AC.FULL_RING, 64), s, post)
              for s in (spt, dead)]

        def ring(q, k, v, s, p):
            return decode_attention_kernel(q, k, v, slot_pos=s, pos=p,
                                           window=AC.FULL_RING)

        out["graph_replays"] += AC.graph_replays(
            ring, xs, [decode_attention_ref(q, k, v, slot_pos=s, pos=p,
                                            window=AC.FULL_RING)
                       for q, k, v, s, p in xs])
        torch.cuda.synchronize(device)
    return out


# ------------------------------------------------------------ SSD kernel

def check_ssd(device, cases=None, oracle=None, seed: int = 0) -> dict:
    """K9 against its plain version ``ssd_chunk_ref`` on ``device``, all
    four outputs, over the ``ssd_cases`` sweep (or ``cases``), on the
    model's input distribution and strided layout; then ``ops.ssd``
    (K9 plus the torch recurrence) against the sequential oracle at
    ``ssd_cases.ORACLE_CASE`` (or ``oracle``, (b, s, h, p, n, chunk)).
    Each output within ``ssd_cases.tolerance`` of max(1, max|plain|).
    Returns the cases, the worst kernel-vs-plain error, the oracle's
    error and the worst error over its allowance."""
    import torch

    from repro_torch.kernels import ssd_cases as SC
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref, ssd_reference
    from repro_torch.kernels.ssd.ssd import ssd_chunk_kernel

    cuda = device.type == "cuda"
    step = ssd_chunk_kernel if cuda else ssd_chunk_ref
    g = torch.Generator(device=device).manual_seed(seed)
    worst = {"max_abs_err": 0.0, "oracle_max_abs_err": 0.0,
             "err_over_allowance": 0.0}

    def hold(got, want, tol, what, key="max_abs_err"):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite output")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        allow = tol * max(1.0, float(want.abs().max()))
        if not err <= allow:
            raise AssertionError(f"{what}: max|diff| {err} > {allow}")
        worst[key] = max(worst[key], err)
        worst["err_over_allowance"] = max(worst["err_over_allowance"],
                                          err / allow)

    sweep = cases or SC.sweep()
    for b, s, h, p, n, chunk in sweep:
        x, dt, A, B, C = SC.case_inputs(b, s, h, p, n, chunk, g, device)
        tol = SC.tolerance(SC.cum_max(dt, A, chunk))
        got = step(x, dt, A, B, C, chunk=chunk)
        want = ssd_chunk_ref(x, dt, A, B, C, chunk)
        for name, a, w in zip(("y_diag", "states", "decay", "cum"), got,
                              want):
            hold(a, w, tol, f"K9 {name} (b,s,h,p,n,chunk)="
                            f"{(b, s, h, p, n, chunk)}")
    case = oracle or SC.ORACLE_CASE
    b, s, h, p, n, chunk = case
    x, dt, A, B, C = SC.oracle_inputs(g, device, case)
    y, _ = ssd_ops.ssd(x, dt, A, B, C, chunk,
                       impl="kernel" if cuda else "ref")
    hold(y, ssd_reference(x, dt, A, B, C),
         SC.tolerance(SC.cum_max(dt, A, chunk)),
         f"ops.ssd vs the sequential oracle {(b, s, h, p, n, chunk)}",
         key="oracle_max_abs_err")
    if cuda:
        torch.cuda.synchronize(device)
    return {"cases": len(sweep), "oracle_case": [b, s, h, p, n, chunk],
            **worst, "tolerance": "ssd_cases.tolerance(max|cum|) = "
            "1e-5 + 2^-23 max|cum|, relative to max(1, max|plain|)"}


# ------------------------------------------------------------ the serving

def serve_prompts(n: int, seed: int = 0) -> list[str]:
    """``n`` prompts of 4-150 words from a fixed vocabulary, made from
    ``seed`` (longer ones are cut at ``max_seq`` tokens)."""
    rng = np.random.default_rng(seed)
    words = ["is", "the", "review", "positive", "product", "winter",
             "garden", "seasonal", "category", "answer", "yes", "no",
             "book", "about", "machine", "learning", "service", "slow",
             "supplier", "reliable", "fragile", "part", "place", "rating"]
    return [" ".join(rng.choice(words, int(rng.integers(4, 151))))
            for _ in range(n)]


def serve_engine_pair(device, cfg, params, serve=SERVE):
    """Two engines on the same weights: the kernel path (K7/K8/K9,
    "auto"; the plain path on a CPU rehearsal) and the plain path
    ("ref": the grouped einsum and ``ssd_chunked``, no kernel)."""
    from repro_torch.serving import ServingEngine

    return tuple(ServingEngine(cfg, params, device=device, attn_impl=i,
                               ssd_impl=i, **serve) for i in ("auto", "ref"))


def path_launches(cfg, admissions: int, rounds: int) -> dict:
    """The LLM kernels' launches a served run must make: K7 and K9 once
    per layer per admission, K8 once per layer per round, as far as the
    family has attention (K7/K8) and SSM heads (K9)."""
    attn = cfg.family != "ssm"
    ssm = cfg.family in ("ssm", "hybrid")
    L = cfg.num_layers
    return {"flash_attention": L * admissions * attn,
            "decode_attention": L * rounds * attn,
            "ssd_chunk": L * admissions * ssm}


def timed_serve(eng, prompts) -> tuple[list[str], dict]:
    """``eng.answer(prompts)`` with CUDA events recorded around every
    ``_admit`` and ``_round`` call of its scheduler (set on the
    instance here, so the engine itself carries no timing)."""
    import torch

    sched = eng.scheduler
    events = {"_admit": [], "_round": []}
    cuda = eng.device.type == "cuda"

    def wrap(name):
        fn = getattr(sched, name)

        def run():
            if not cuda:
                t0 = time.perf_counter()
                fn()
                events[name].append(time.perf_counter() - t0)
                return
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events[name].append((a, b))
        setattr(sched, name, run)

    for name in events:
        wrap(name)
    t0 = time.perf_counter()
    try:
        answers = eng.answer(prompts)
        if cuda:
            torch.cuda.synchronize(eng.device)
    finally:
        for name in events:
            delattr(sched, name)
    wall = time.perf_counter() - t0

    def seconds(name):
        if not cuda:
            return sum(events[name])
        return sum(a.elapsed_time(b) for a, b in events[name]) / 1e3

    return answers, {"wall_s": wall, "prefill_s": seconds("_admit"),
                     "decode_s": seconds("_round")}


def record_serving(eng) -> dict:
    """Wrap ``take`` and ``_admit`` of ``eng``'s scheduler on the
    instance (``unrecord_serving`` removes them): the record gathers the
    token ids of every completed request, in the order its ticket was
    taken, and counts the admissions made while another slot was
    mid-decode (a live slot that has already emitted a token)."""
    sched = eng.scheduler
    rec = {"ids": [], "mid_decode_admissions": 0}
    take, admit = sched.take, sched._admit

    def take_recorded(ticket):
        out = take(ticket)
        rec["ids"].extend(list(ids) for ids in out)
        return out

    def admit_recorded():
        busy = any(sched._slot_req[s].out_ids for s in sched.live_slots())
        before = eng.stats.batches
        admit()
        if busy and eng.stats.batches > before:
            rec["mid_decode_admissions"] += 1

    sched.take, sched._admit = take_recorded, admit_recorded
    return rec


def unrecord_serving(eng) -> None:
    del eng.scheduler.take, eng.scheduler._admit


def staggered_serve(eng, prompts, first: int) -> tuple[list[str], dict]:
    """Submit ``first`` prompts, run one round, then submit the rest and
    drain: the two waves stay a round apart, so each later admission
    refills slots while the other wave is mid-decode."""
    rec = record_serving(eng)
    try:
        head = eng.submit(prompts[:first])
        eng.poll()
        tail = eng.submit(prompts[first:])
        eng.drain()
        answers = eng.answers(head) + eng.answers(tail)
    finally:
        unrecord_serving(eng)
    return answers, rec


def run_serve(device, arch: str = SERVE_ARCH, n_prompts: int = 256,
              seed: int = 0, tiny: bool = False, serve=SERVE) -> dict:
    """The serving path at full width (``tiny`` for a CPU rehearsal):
    weights from a seeded generator on ``device``, ``n_prompts`` prompts
    through the kernel-path engine and the plain engine. Returns the
    phase's numbers and keeps the engines under ``"engines"`` for
    ``run_llm_query`` and ``run_long_prefill``."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.kernels.sync import HOST_SYNCS
    from repro_torch.models import count_params, init_params, prefill

    cfg = get_tiny(arch) if tiny else get_config(arch)
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(seed), device=device)
    if cuda:
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    kern, plain = serve_engine_pair(device, cfg, params, serve)
    prompts = serve_prompts(n_prompts, seed)
    out = {"arch": cfg.name, "params": count_params(cfg),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "family": cfg.family, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "attn_window":
           cfg.attn_window, "ssm_heads": cfg.ssm_num_heads * (
               cfg.family != "dense"), "ssm_state": cfg.ssm_state,
           "ssm_chunk": cfg.ssm_chunk, "prompts": n_prompts,
           **serve, "init_s": init_s,
           "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32]}
    answers = {}
    for label, eng in (("kernel", kern), ("plain", plain)):
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        rounds0 = HOST_SYNCS.by_site.get("serving_round", 0)
        _build.reset_launches()
        answers[label], t = timed_serve(eng, prompts)
        launches = dict(_build.LAUNCHES)
        shapes = dict(_build.MAX_SHAPES)
        st = eng.stats
        padded = st.prefill_rows * eng.max_seq
        out[label] = {
            **t, "admissions": st.batches, "decode_rounds": st.decode_steps,
            "prefill_tokens": st.prefill_tokens, "prefill_padded": padded,
            "prefill_tokens_per_s": st.prefill_tokens / t["prefill_s"],
            "prefill_padded_per_s": padded / t["prefill_s"],
            "decode_slot_steps": st.slot_steps,
            "decode_slot_steps_per_s": st.slot_steps / t["decode_s"],
            "decode_tokens": st.decode_tokens,
            "serving_round_syncs": HOST_SYNCS.by_site.get(
                "serving_round", 0) - rounds0,
            "occupancy": st.occupancy,
            "launches": {k: launches[k] for k in LLM_KERNELS},
            "shapes": {k: list(v) for k, v in shapes.items()},
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if cuda else None)}
    name = cfg.name
    if answers["kernel"] != answers["plain"]:
        diff = sum(a != b for a, b in zip(answers["kernel"],
                                          answers["plain"]))
        raise AssertionError(f"serve {name}: {diff} of {n_prompts} answers "
                             f"differ between the kernel and plain paths")
    if len(answers["kernel"]) != n_prompts or not all(answers["kernel"]):
        raise AssertionError(f"serve {name}: missing answers")
    k = out["kernel"]
    if k["serving_round_syncs"] != k["decode_rounds"]:
        raise AssertionError(f"serve {name}: not one serving_round sync "
                             f"per round")
    if cuda:
        want = path_launches(cfg, k["admissions"], k["decode_rounds"])
        if k["launches"] != want:
            raise AssertionError(f"serve {name}: launches {k['launches']} "
                                 f"!= {want}")
        if any(out["plain"]["launches"].values()):
            raise AssertionError(f"serve {name}: the plain engine launched "
                                 f"{out['plain']['launches']}")
    # one admission's prefill logits and cache leaves, both paths
    toks = torch.from_numpy(np.stack([kern.encode_row(p)[0] for p in
                                      prompts[:serve["batch_size"]]])
                            ).to(device)
    lg = {}
    for eng in (kern, plain):
        lg[eng.attn_impl] = prefill(cfg, params, {"tokens": toks},
                                    max_seq=kern.cache_len,
                                    attn_impl=eng.attn_impl,
                                    ssd_impl=eng.ssd_impl)
    (la, ca), (lb, cb) = lg[kern.attn_impl], lg[plain.attn_impl]
    if not all(bool(torch.isfinite(x).all())
               for x in (la, *(v for n, v in ca.items()
                               if n != "slot_pos"))):
        raise AssertionError(f"serve {name}: non-finite prefill logits or "
                             f"cache")
    out["prefill_logit_max_abs_diff"] = float((la - lb).abs().max())
    out["prefill_logit_max_abs"] = float(lb.abs().max())
    if "k" in ca:
        out["prefill_kv_max_abs_diff"] = max(
            float((ca[n] - cb[n]).abs().max()) for n in ("k", "v"))
        if not torch.equal(ca["slot_pos"], cb["slot_pos"]):
            raise AssertionError(f"serve {name}: slot_pos differs")
    for n in ("state", "conv"):
        if n in ca:
            out[f"prefill_{n}_max_abs_diff"] = float(
                (ca[n] - cb[n]).abs().max())
            out[f"prefill_{n}_max_abs"] = float(cb[n].abs().max())
    out["answers_identical"] = True
    if cuda:
        out["breakdown"] = serve_breakdown(kern, toks, out["kernel"])
    # slots freed and refilled mid-decode: waves half a batch apart
    b = serve["batch_size"]
    stag = {eng.attn_impl: staggered_serve(eng, prompts[:4 * b], b // 2)
            for eng in (kern, plain)}
    (ka, kr), (pa, pr) = stag[kern.attn_impl], stag[plain.attn_impl]
    if ka != pa or kr["ids"] != pr["ids"]:
        raise AssertionError(f"serve {name} (staggered): answers differ "
                             f"between the kernel and plain paths")
    if not kr["mid_decode_admissions"]:
        raise AssertionError(f"serve {name} (staggered): no slot was "
                             f"refilled mid-decode")
    out["staggered"] = {"prompts": 4 * b, "first_wave": b // 2,
                        "mid_decode_admissions": kr["mid_decode_admissions"],
                        "tokens_compared": sum(map(len, kr["ids"]))}
    # K8's lengths in a first decode round of these prompts: pos + 1
    out["decode_lengths"] = [kern.encode_row(p)[1] for p in
                             prompts[:serve["batch_size"]]]
    out["cache_len"] = kern.cache_len
    out["answer_sample"] = answers["kernel"][:4]
    out["engines"] = (kern, plain)
    return out


GEMM_LEAVES = ("wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate")


def serve_breakdown(eng, toks, run: dict) -> dict:
    """Where one admission's and one round's time goes on the kernel
    path of ``eng``: the admission's prefill of ``toks`` and one decode
    round over its cache, each as CUDA-graph replays (device time, no
    host work) beside the eager times ``run`` measured (``prefill_s`` /
    admissions, ``decode_s`` / rounds: device time plus the time the
    card waited on the host); and the projection GEMMs of the prefill
    alone (every layer's ``GEMM_LEAVES`` matrices at the admission's
    B x S rows, as graph replays)."""
    import torch

    from repro_torch.models import decode_step, prefill

    cfg, params = eng.cfg, eng.params
    B, S = toks.shape

    def run_prefill():
        return prefill(cfg, params, {"tokens": toks}, max_seq=eng.cache_len,
                       attn_impl=eng.attn_impl, ssd_impl=eng.ssd_impl)

    prefill_ms = time_ms(run_prefill, reps=3, inner=2, warmup=1)
    _, cache = run_prefill()
    tok = toks[:, -1].contiguous()
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=toks.device)
    decode_ms = time_ms(lambda: decode_step(cfg, params, cache, tok, pos,
                                            attn_impl=eng.attn_impl),
                        reps=5, inner=5, warmup=1)
    g = torch.Generator(device=toks.device).manual_seed(3)
    gemm_ms, gemm_flops = 0.0, 0
    for part in params["blocks"].values():
        if not isinstance(part, dict):
            continue
        for name, w in part.items():
            if name not in GEMM_LEAVES:
                continue
            w0 = w[0].reshape(w.shape[1], -1) if name != "wo" else \
                w[0].reshape(-1, w.shape[-1])
            x = torch.randn(B * S, w0.shape[0], generator=g,
                            device=toks.device)
            gemm_ms += cfg.num_layers * time_ms(lambda: x @ w0, reps=10,
                                                inner=5)
            gemm_flops += cfg.num_layers * 2 * B * S * w0.numel()
    del cache
    eager_prefill = run["prefill_s"] / run["admissions"] * 1e3
    eager_round = run["decode_s"] / run["decode_rounds"] * 1e3
    return {"rows": B, "seq": S,
            "prefill_eager_ms": eager_prefill, "prefill_graph_ms": prefill_ms,
            "prefill_gemm_ms": gemm_ms,
            "prefill_gemm_tflop_per_s": gemm_flops / gemm_ms / 1e9,
            "decode_round_eager_ms": eager_round,
            "decode_round_graph_ms": decode_ms,
            "decode_host_share": 1.0 - decode_ms / eager_round}


def run_long_prefill(device, ssm_eng, hybrid_eng, ssm_shape=(2, 2048),
                     hybrid_shape=(1, 4096), hybrid_max_seq: int = 4104,
                     steps: int = 8, seed: int = 0) -> dict:
    """Full width at the multi-tile shapes the 128-token admissions never
    reach: the SSM model's ``prefill`` at ``ssm_shape`` (B, S) (16 chunks
    of 128 at full width), both paths, logits and final ``state``
    compared; the hybrid's ``prefill`` at ``hybrid_shape`` with cache
    length ``hybrid_max_seq``, so that its ring holds W = 2048 slots and
    the window cuts, then ``steps`` decode steps past the wrap, both
    paths, logits compared at every step. Each within LONG_TOLERANCE of
    max|plain|; launches counted per path."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, prefill

    cuda = device.type == "cuda"
    rng = np.random.default_rng(seed)

    def rel(a, b):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("long_prefill: non-finite output")
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def timed(fn):
        if not cuda:
            t0 = time.perf_counter()
            return fn(), time.perf_counter() - t0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        b.synchronize()
        return res, a.elapsed_time(b) / 1e3

    out = {"tolerance": LONG_TOLERANCE}
    # the SSM model: 16 chunks per row
    eng = ssm_eng
    cfg, params = eng.cfg, eng.params
    B, S = ssm_shape
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32)).to(device)
    res = {}
    for impl in ("auto", "ref"):
        _build.reset_launches()
        (lg, cache), sec = timed(lambda: prefill(
            cfg, params, {"tokens": toks}, max_seq=S, attn_impl=impl,
            ssd_impl=impl))
        res[impl] = (lg, cache["state"], sec, dict(_build.LAUNCHES),
                     dict(_build.MAX_SHAPES))
    (la, sa, ta, na, shapes), (lb, sb, tb, nb, _) = res["auto"], res["ref"]
    ssm = {"arch": cfg.name, "batch": B, "seq": S,
           "chunks": S // cfg.ssm_chunk, "prefill_s": ta,
           "plain_prefill_s": tb,
           "logit_rel_diff": rel(la, lb), "state_rel_diff": rel(sa, sb),
           "logit_max_abs": float(lb.abs().max()),
           "state_max_abs": float(sb.abs().max()),
           "launches": {k: na[k] for k in LLM_KERNELS},
           "plain_launches": {k: nb[k] for k in LLM_KERNELS},
           "shapes": {k: list(v) for k, v in shapes.items()}}
    del res, cache, la, lb, sa, sb
    # the hybrid: the ring wraps and the window cuts
    eng = hybrid_eng
    cfg, params = eng.cfg, eng.params
    B, S = hybrid_shape
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + steps))
                            .astype(np.int32)).to(device)
    res = {}
    for impl in ("auto", "ref"):
        _build.reset_launches()
        (lg, cache), sec = timed(lambda: prefill(
            cfg, params, {"tokens": toks[:, :S]}, max_seq=hybrid_max_seq,
            attn_impl=impl, ssd_impl=impl))
        logits = [lg]
        t_dec = 0.0
        for i in range(steps):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=device)
            (ld, cache), sec_d = timed(lambda: decode_step(
                cfg, params, cache, toks[:, S + i], pos, attn_impl=impl))
            logits.append(ld)
            t_dec += sec_d
        res[impl] = (logits, sec, t_dec, dict(_build.LAUNCHES),
                     dict(_build.MAX_SHAPES), cache["slot_pos"])
    ka, kb = res["auto"], res["ref"]
    W = ka[5].shape[2]
    hyb = {"arch": cfg.name, "batch": B, "seq": S,
           "cache_len": hybrid_max_seq, "ring_slots": W,
           "attn_window": cfg.attn_window, "decode_steps": steps,
           "prefill_s": ka[1], "plain_prefill_s": kb[1],
           "decode_s": ka[2], "plain_decode_s": kb[2],
           "logit_rel_diff_per_step": [rel(a, b) for a, b in
                                       zip(ka[0], kb[0])],
           "logit_max_abs": max(float(b.abs().max()) for b in kb[0]),
           "launches": {k: ka[3][k] for k in LLM_KERNELS},
           "plain_launches": {k: kb[3][k] for k in LLM_KERNELS},
           "shapes": {k: list(v) for k, v in ka[4].items()}}
    if not torch.equal(ka[5], kb[5]) or int(ka[5].max()) != S + steps - 1:
        raise AssertionError("long_prefill: ring slot_pos differs or the "
                             "decode steps did not wrap")
    del res, ka, kb
    worst = max([ssm["logit_rel_diff"], ssm["state_rel_diff"]]
                + hyb["logit_rel_diff_per_step"])
    if not worst <= LONG_TOLERANCE:
        raise AssertionError(f"long_prefill: kernel vs plain path "
                             f"{worst} > {LONG_TOLERANCE} of max|plain|")
    if cuda:
        want_ssm = {"flash_attention": 0, "decode_attention": 0,
                    "ssd_chunk": ssm_eng.cfg.num_layers}
        L = cfg.num_layers
        want_hyb = {"flash_attention": L, "decode_attention": L * steps,
                    "ssd_chunk": L}
        if ssm["launches"] != want_ssm or hyb["launches"] != want_hyb:
            raise AssertionError(f"long_prefill: launches {ssm['launches']}"
                                 f" / {hyb['launches']}")
        if any(ssm["plain_launches"].values()) or \
                any(hyb["plain_launches"].values()):
            raise AssertionError("long_prefill: the plain path launched a "
                                 "kernel")
    out.update(ssm=ssm, hybrid=hyb, worst_rel_diff=worst)
    return out


def run_llm_query(device, engines, scale: float = 0.15, qids=None) -> dict:
    """Five corpus queries (one per schema; or those of ``qids``) through
    per-schema ``FrontDoor``s sharing one runner over
    ``ModelBackend.from_engine``, once per engine of ``engines`` (kernel
    path, plain path); everything the queries report must agree, and so
    must the token ids the model emitted for every backend prompt (with
    random weights the verdicts parse to False on both paths, so the ids
    are what holds the kernels to the plain path here)."""
    import torch

    from repro_torch.core import CostParams, Q, col, optimize
    from repro_torch.data import SCHEMAS
    from repro_torch.data import schemas as S
    from repro_torch.engine import FrontDoor
    from repro_torch.kernels import _build
    from repro_torch.semantic import ModelBackend, SemanticRunner
    from repro_torch.serving import ServingStats

    specs = [sp for sp in corpus_specs(Q, col, S)
             if (sp[0] in qids if qids else sp[0] != "Q25")]
    fields = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
              "pipeline_syncs", "serving_syncs")
    runs = []
    for eng in engines:
        # fresh tables per run: a table caches what its first run fetched
        dbs = {sp[1]: SCHEMAS[sp[1]](seed=0, scale=scale, device=device)
               for sp in specs}
        eng.stats = ServingStats()
        backend = ModelBackend.from_engine(eng)
        runner = SemanticRunner(backend)
        doors = {name: FrontDoor(db, runner, n_lanes=2)
                 for name, db in dbs.items()}
        rec = record_serving(eng)
        _build.reset_launches()
        queries = {}
        t_all = time.perf_counter()
        for qid, schema, cols, build in specs:
            db = dbs[schema]
            t0 = time.perf_counter()
            plan = optimize(build(), db.catalog(), strategy="cost",
                            params=CostParams()).plan
            t1 = time.perf_counter()
            table, stats = doors[schema].execute(plan)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            rows = _freeze(db.materialize(table, list(cols)))
            t3 = time.perf_counter()
            queries[qid] = {
                "rows": rows, "stats": {f: getattr(stats, f)
                                        for f in fields},
                "split": {"optimize_s": t1 - t0, "execute_s": t2 - t1,
                          "rel_s": stats.rel_wall_s,
                          "sem_s": stats.sem_wall_s,
                          "materialize_s": t3 - t2}}
        wall = time.perf_counter() - t_all
        unrecord_serving(eng)
        runs.append({"queries": queries, "calls": backend.calls,
                     "wall_s": wall, "launches": dict(_build.LAUNCHES),
                     "serving": eng.stats.snapshot(), **rec})
    kern, plain = runs
    for qid, q in kern["queries"].items():
        p = plain["queries"][qid]
        if q["rows"] != p["rows"]:
            raise AssertionError(f"llm_query {qid}: rows differ between "
                                 f"the kernel and plain paths")
        if q["stats"] != p["stats"]:
            raise AssertionError(f"llm_query {qid}: {q['stats']} != "
                                 f"{p['stats']}")
    if kern["calls"] != plain["calls"] or kern["calls"] == 0:
        raise AssertionError(f"llm_query: backend calls {kern['calls']} "
                             f"vs {plain['calls']}")
    if kern["ids"] != plain["ids"]:
        diff = sum(a != b for a, b in zip(kern["ids"], plain["ids"]))
        raise AssertionError(
            f"llm_query: the token ids of {diff} of {len(kern['ids'])} "
            f"answers (counts {len(kern['ids'])} vs {len(plain['ids'])}) "
            f"differ between the kernel and plain paths")
    split = {k: sum(q["split"][k] for q in kern["queries"].values())
             for k in ("optimize_s", "execute_s", "rel_s", "sem_s",
                       "materialize_s")}
    return {"arch": engines[0].cfg.name, "qids": list(kern["queries"]),
            "scale": scale, "backend_calls": kern["calls"],
            "answers_compared": len(kern["ids"]),
            "tokens_compared": sum(map(len, kern["ids"])),
            "mid_decode_admissions": kern["mid_decode_admissions"],
            "wall_s": kern["wall_s"], "plain_wall_s": plain["wall_s"],
            "split": split, "serving": kern["serving"],
            "launches": kern["launches"],
            "plain_launches": plain["launches"],
            "queries": {qid: {"rows": len(q["rows"]), **q["stats"],
                              "split": q["split"]}
                        for qid, q in kern["queries"].items()}}


# ------------------------------------------------- timing at main-path shapes

def sdpa_call(q, k, v, **kw):
    """``scaled_dot_product_attention`` over GQA operands — the library
    yardstick of K7/K8, never called by the port. Torch builds without
    ``enable_gqa`` get K/V repeated H-wide here, outside the call."""
    import torch.nn.functional as F

    group = q.shape[1] // k.shape[1]
    try:
        F.scaled_dot_product_attention(q[:1, :1, :1], k[:1, :1, :1],
                                       v[:1, :1, :1], enable_gqa=True)
    except TypeError:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        return lambda: F.scaled_dot_product_attention(q, k, v, **kw)
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)


def ssd_work(b, s, h, p, n, chunk) -> tuple[int, int]:
    """(bytes, operations) K9 must move and do at (b, s, h, p, n, chunk):
    x, dt, B, C read once, y_diag, states, decay and cum written once;
    2 l^2 n per (row, chunk) for C.B^T, 2 p per visible (i >= j) pair
    and head for y_diag, 2 l h p n per (row, chunk) for the states."""
    nc = s // chunk
    n_bytes = 4 * (2 * b * s * h * p + 2 * b * s * h + h + 2 * b * s * n
                   + b * nc * h * p * n + b * nc * h)
    cells = b * nc
    n_ops = cells * (2 * chunk * chunk * n + h * p * chunk * (chunk + 1)
                     + 2 * chunk * h * p * n)
    return n_bytes, n_ops


def window_pairs(S: int, window: int) -> int:
    """Visible (query, key) pairs of one causal (row, head) over S
    positions within ``window`` (0: none)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def kernel_rows(device, launches: dict, shapes: dict, max_err: dict,
                by_path: dict, decode_lengths, seed: int = 1,
                llm: dict | None = None, n_shards: int = 4) -> list[dict]:
    """Time each kernel at the largest shape its path's run gave it
    (``launches``/``shapes``: K1-K4 from ``e2e``, K5/K6 from
    ``e2e_hash``, K7/K8 from ``serve``, K9 from ``serve_ssm``; K8's rows
    hold the ``decode_lengths`` of a first decode round of the served
    prompts; ``llm`` adds K7 with the hybrid's window and K8 with its
    slot mask at ``serve_hybrid``'s and ``long_prefill``'s shapes, and
    K9 at ``long_prefill``'s and ``serve_hybrid``'s; K10 from
    ``e2e_sharded`` over ``n_shards`` buckets, with K6 at B = P and K10
    at P = 32 beside it):
    the kernel, its plain version and the library call each as
    CUDA-graph replays (device time only), and the kernel's wrapper also
    as one eager call between two events (``wrapper_eager_ms``, which
    adds the wrapper's host work where the card waits for it).
    ``by_path`` holds every path's launch counts."""
    import torch

    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels.attention_cases import TOLERANCE
    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.compact.ref import prefix_count_torch
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_kernel)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref)
    from repro_torch.kernels.expand.expand import running_segment_ids_kernel
    from repro_torch.kernels.expand.ref import running_segment_ids_torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.hash_dedup import hash_rows_kernel
    from repro_torch.kernels.hash_dedup.ref import (
        group_boundaries_ref, hash_rows_ref)
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.hash_join.ops import _radix_order
    from repro_torch.kernels.partition.partition import shard_rank_kernel
    from repro_torch.kernels.partition.ref import shard_rank_torch
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)
    from repro_torch.kernels import ssd_cases as SC
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd.ssd import head_groups, ssd_chunk_kernel

    g = torch.Generator(device=device).manual_seed(seed)
    llm = llm or {}
    rows = []

    def row(name, source, replaces, kern, plain, library, n_bytes, n_ops,
            shape, err=None, library_eager=False, tensor_cores=False,
            **extra):
        if err is None:
            outs, wants = kern(), plain()
            if not isinstance(outs, tuple):
                outs, wants = (outs,), (wants,)
            err = max([max_err.get(name, 0)] + [
                _same(a, b, name) for a, b in zip(outs, wants)])
        bounds = (tc_bounds(n_bytes, n_ops) if tensor_cores else
                  dict(zip(("bound_ms", "bound_by"),
                           bound_ms(n_bytes, n_ops))))
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": err, "shape": list(shape),
            "ms": time_ms(kern), "plain_ms": time_ms(plain), **bounds,
            "library_ms": (None if library is None else eager_ms(library)
                           if library_eager else time_ms(library)),
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
        8 * n, n, (n,), library_call="torch.cumsum(dtype=int32)",
        device_kernels=device_kernels(lambda: prefix_count_kernel(flags)))

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
    # the library yardstick: unique_consecutive's inverse is K3's gid;
    # it fetches its output size to the host, so it cannot be captured
    # in a CUDA graph and is timed eagerly, beside wrapper_eager_ms
    inverse = torch.unique_consecutive(sk, return_inverse=True)[1]
    if not torch.equal(inverse, group_boundaries_kernel(sk)[1].long()):
        raise AssertionError("K3's gid differs from unique_consecutive's "
                             "inverse")
    row("group_boundaries", "src/repro_torch/csrc/group_build.cu",
        "src/repro/kernels/hash_dedup/group_build.py:61",
        lambda: group_boundaries_kernel(sk),
        lambda: group_boundaries_ref(sk),
        lambda: torch.unique_consecutive(sk, return_inverse=True),
        12 * n, 3 * n, (n,), library_eager=True,
        library_call="torch.unique_consecutive(return_inverse=True), "
                     "eager (it syncs the host)",
        device_kernels=one_data_kernel(
            "K3", lambda: group_boundaries_kernel(sk),
            "lookback_scan_kernel", memset=True))

    n = shapes["running_segment_ids"][0]
    counts = torch.randint(0, 3, (n // 2 + 1,), generator=g, device=device)
    marks = _marks_from_counts(counts, n, device)
    row("running_segment_ids", "src/repro_torch/csrc/expand.cu",
        "src/repro/kernels/expand/expand.py:49",
        lambda: running_segment_ids_kernel(marks),
        lambda: running_segment_ids_torch(marks),
        lambda: torch.cumsum(marks, 0, dtype=torch.int32),
        8 * n, 2 * n, (n,), library_call="torch.cumsum(dtype=int32)",
        device_kernels=device_kernels(
            lambda: running_segment_ids_kernel(marks)))

    # K5 at the group-by's (rows, groups): float32 max, the aggregate
    # the path runs; min/max are exact, so held bit for bit here; and at
    # the radix histograms' (rows, 256): int32 sums of ones over 8-bit
    # digits (kernels/hash_join/ops.py::_radix_order), index_add_ the
    # library call there, and bincount (the same histogram of ones; it
    # fetches the largest digit to the host, so it is timed eagerly,
    # beside wrapper_eager_ms)
    n, gs = shapes["segment_reduce"]
    vals = torch.randn(n, generator=g, device=device) * 100
    seg = torch.randint(0, gs, (n,), generator=g, device=device,
                        dtype=torch.int32)
    seg64 = seg.long()
    kern5 = segment_reduce_kernel(vals, seg, gs, "max")
    if not torch.equal(kern5.view(torch.int32),
                       segment_reduce_torch(vals, seg, gs, "max")
                       .view(torch.int32)):
        raise AssertionError("K5 at the e2e_hash shape differs from its "
                             "plain version")
    nh = shapes["radix_rank"][0]
    digit = torch.randint(0, 256, (nh,), generator=g, device=device,
                          dtype=torch.int32)
    digit64 = digit.long()
    ones = torch.ones_like(digit)
    hist = segment_reduce_kernel(ones, digit, 256, "sum")
    if not torch.equal(hist, segment_reduce_torch(ones, digit, 256, "sum")):
        raise AssertionError("K5 at the radix histogram's shape differs "
                             "from its plain version")
    if not torch.equal(hist.long(), torch.bincount(digit, minlength=256)):
        raise AssertionError("K5 at the radix histogram's shape differs "
                             "from torch.bincount")
    hb, hby = bound_ms(8 * nh + 4 * 256, nh)
    histogram = {
        "shape": [nh, 256], "op": "sum", "dtype": "int32",
        "max_abs_err": 0,
        "ms": time_ms(lambda: segment_reduce_kernel(ones, digit, 256,
                                                    "sum")),
        "plain_ms": time_ms(lambda: segment_reduce_torch(ones, digit, 256,
                                                         "sum")),
        "bound_ms": hb, "bound_by": hby,
        "library_ms": time_ms(lambda: torch.zeros(
            256, dtype=torch.int32, device=device).index_add_(
                0, digit64, ones)),
        "library_call": "index_add_",
        "bincount_eager_ms": eager_ms(
            lambda: torch.bincount(digit, minlength=256)),
        "wrapper_eager_ms": eager_ms(lambda: segment_reduce_kernel(
            ones, digit, 256, "sum")),
        "device_kernels": one_data_kernel(
            "K5 histogram",
            lambda: segment_reduce_kernel(ones, digit, 256, "sum"),
            "segment_reduce_kernel", memset=True)}
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
        f32_sum_tolerance="count * 2^-23 * sum|v| per segment",
        device_kernels=one_data_kernel(
            "K5", lambda: segment_reduce_kernel(vals, seg, gs, "max"),
            "segment_reduce_kernel", memset=True),
        radix_histogram=histogram)
    del vals, seg, seg64, digit, digit64, ones

    # K6 at the largest radix pass: 8-bit digits of a slot key; the
    # chained order of a whole build side is timed beside it
    n = shapes["radix_rank"][0]
    hbits = max(int(2 * n - 1).bit_length(), 10)
    slot_key = torch.randint(0, 1 << hbits, (n,), generator=g,
                             device=device, dtype=torch.int32)
    digit = slot_key & 255
    base = RC.exclusive_bases(digit, 256)
    row("radix_rank", "src/repro_torch/csrc/radix_rank.cu",
        "src/repro/kernels/hash_join/hash_join.py:57",
        lambda: radix_rank_kernel(digit, base),
        lambda: radix_rank_torch(digit, base),
        lambda: torch.sort(digit, stable=True),
        8 * n, n, (n,), library_call="torch.sort(stable=True)",
        device_kernels=one_data_kernel(
            "K6", lambda: radix_rank_kernel(digit, base),
            "radix_rank_kernel", memset=True),
        order_key_bits=hbits,
        order_ms=time_ms(lambda: _radix_order(slot_key, key_bits=hbits)),
        order_argsort_ms=time_ms(
            lambda: torch.argsort(slot_key, stable=True)))
    order = _radix_order(slot_key, key_bits=hbits)
    if not torch.equal(order.long(), torch.argsort(slot_key, stable=True)):
        raise AssertionError("K6 chained order differs from the stable "
                             "argsort")

    # K10 at the largest source block the sharded e2e gave it: uniform
    # destinations (the key hash spreads rows evenly), the exchange's
    # fixed-stride offsets; K6 over the same P buckets, and K10 at P = 32,
    # beside it
    if "shard_rank" in shapes:
        n = shapes["shard_rank"][0]

        def k10_inputs(p):
            d = torch.randint(0, p, (n,), generator=g, device=device,
                              dtype=torch.int32)
            return d, torch.arange(p, dtype=torch.int32, device=device) * n

        dest, base = k10_inputs(n_shards)
        d32, b32 = k10_inputs(32)
        if not torch.equal(shard_rank_kernel(d32, b32),
                           shard_rank_torch(d32, b32, 32)):
            raise AssertionError("K10 at P = 32 differs from its plain "
                                 "version")
        if not torch.equal(radix_rank_kernel(dest, base),
                           shard_rank_kernel(dest, base)):
            raise AssertionError("K6 at B = P differs from K10")
        row("shard_rank", "src/repro_torch/csrc/shard_rank.cu",
            "src/repro/kernels/partition/partition.py:52",
            lambda: shard_rank_kernel(dest, base),
            lambda: shard_rank_torch(dest, base, n_shards),
            lambda: torch.sort(dest, stable=True),
            8 * n, n, (n, n_shards), library_call="torch.sort(stable=True)",
            k6_at_b_eq_p_ms=time_ms(lambda: radix_rank_kernel(dest, base)),
            at_p32_ms=time_ms(lambda: shard_rank_kernel(d32, b32)),
            at_p32_plain_ms=time_ms(lambda: shard_rank_torch(d32, b32, 32)),
            k6_at_p32_ms=time_ms(lambda: radix_rank_kernel(d32, b32)))
        del dest, base, d32, b32

    # K7 at a full admission: the (B, S, H, d) projections as the model
    # passes them; 4d operations per visible (query, key) pair
    B, H, K, S, _, d = shapes["flash_attention"]
    q, k, v = (torch.randn(B, S, n, d, generator=g, device=device)
               .transpose(1, 2) for n in (H, K, K))
    kern7 = flash_attention_kernel(q, k, v, causal=True)
    err7 = float((kern7 - attention_ref(q, k, v, causal=True)).abs().max())
    if not err7 <= TOLERANCE:
        raise AssertionError(f"K7 at the serve shape: {err7} > {TOLERANCE}")
    pairs = B * H * S * (S + 1) // 2

    def k7_window(shape, window):
        """K7 with the hybrid's window at ``shape`` (B, H, K, S, S, d):
        kernel, plain and SDPA (with the window as a boolean mask) as
        graph replays, the bound over the visible pairs."""
        B, H, K, S, _, d = shape
        q, k, v = (torch.randn(B, S, n, d, generator=g, device=device)
                   .transpose(1, 2) for n in (H, K, K))
        err = float((flash_attention_kernel(q, k, v, causal=True,
                                            window=window)
                     - attention_ref(q, k, v, causal=True, window=window))
                    .abs().max())
        if not err <= TOLERANCE:
            raise AssertionError(f"K7 window {window} at {shape}: {err}")
        dq = (torch.arange(S, device=device)[:, None]
              - torch.arange(S, device=device)[None, :])
        mask = (dq >= 0) & (dq < window)
        out = {"shape": list(shape), "window": window, "max_abs_err": err,
               "ms": time_ms(lambda: flash_attention_kernel(
                   q, k, v, causal=True, window=window)),
               "plain_ms": time_ms(lambda: attention_ref(
                   q, k, v, causal=True, window=window)),
               "library_ms": time_ms(sdpa_call(q, k, v, attn_mask=mask)),
               **tc_bounds(4 * (2 * B * H * S * d + 2 * B * K * S * d),
                           4 * d * B * H * window_pairs(S, window))}
        del q, k, v
        return out

    k7_extra = {f"window_{label}": k7_window(shape, w)
                for label, (shape, w) in llm.get("k7", {}).items()}
    row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:97",
        lambda: flash_attention_kernel(q, k, v, causal=True),
        lambda: attention_ref(q, k, v, causal=True),
        sdpa_call(q, k, v, is_causal=True),
        4 * (2 * B * H * S * d + 2 * B * K * S * d), 4 * d * pairs,
        (B, H, K, S, S, d),
        err=max([err7, max_err.get("flash_attention", 0.0),
                 max_err.get("flash_attention_window", 0.0)]
                + [x["max_abs_err"] for x in k7_extra.values()]),
        causal=True, tolerance=TOLERANCE, tensor_cores=True,
        library_call="scaled_dot_product_attention(is_causal, gqa)",
        device_kernels=one_data_kernel(
            "K7", lambda: flash_attention_kernel(q, k, v, causal=True),
            "flash_fwd_kernel"),
        **k7_extra)

    # K8 over a (B, T, K, d) cache with the first decode round's lengths
    B, H, K, T, d = shapes["decode_attention"]
    lengths = torch.tensor(list(decode_lengths)[:B], dtype=torch.int32,
                           device=device)
    qd = torch.randn(B, H, d, generator=g, device=device)
    kc, vc = (torch.randn(B, T, K, d, generator=g, device=device)
              .permute(0, 2, 1, 3) for _ in range(2))
    kern8 = decode_attention_kernel(qd, kc, vc, lengths)
    err8 = float((kern8 - decode_attention_ref(qd, kc, vc, lengths))
                 .abs().max())
    if not err8 <= TOLERANCE:
        raise AssertionError(f"K8 at the serve shape: {err8} > {TOLERANCE}")
    live = int(lengths.clamp(max=T).sum())
    mask = (torch.arange(T, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    k8_extra = {}
    if "k8" in llm:
        # the hybrid's first decode round: prefill wrote slots 0..S-1 and
        # the round's slot pos = len - 1 holds pos; the slot mask form
        shape, lens, window = llm["k8"]
        Bh, Hh, Kh, Th, dh = shape
        ph = torch.tensor(list(lens)[:Bh], dtype=torch.int32,
                          device=device) - 1
        sp = torch.arange(Th, dtype=torch.int32, device=device).expand(
            Bh, Th).contiguous()
        sp[:, llm["k8_prefill_len"]:] = -1
        qh = torch.randn(Bh, Hh, dh, generator=g, device=device)
        kh, vh = (torch.randn(Bh, Th, Kh, dh, generator=g, device=device)
                  .permute(0, 2, 1, 3) for _ in range(2))

        def k8s():
            return decode_attention_kernel(qh, kh, vh, slot_pos=sp, pos=ph,
                                           window=window)

        def k8p():
            return decode_attention_ref(qh, kh, vh, slot_pos=sp, pos=ph,
                                        window=window)

        errh = float((k8s() - k8p()).abs().max())
        if not errh <= TOLERANCE:
            raise AssertionError(f"K8 slot mask at {shape}: {errh}")
        ok_h = (sp >= 0) & (sp <= ph[:, None])
        live_h = int(ok_h.sum())
        b_ms, b_by = bound_ms(
            4 * (2 * Bh * Hh * dh + 2 * Kh * dh * live_h + Bh * Th + Bh),
            4 * dh * Hh * live_h)
        k8_extra["slot_mask_hybrid"] = {
            "shape": list(shape), "window": window, "live": live_h,
            "max_abs_err": errh, "ms": time_ms(k8s),
            "plain_ms": time_ms(k8p), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(sdpa_call(
                qh[:, :, None], kh, vh,
                attn_mask=ok_h[:, None, None, :])),
            "wrapper_eager_ms": eager_ms(k8s),
            "device_kernels": one_data_kernel(
                "K8 slot mask", k8s, "decode_kernel", memset=True)}
        del qh, kh, vh
    if "k8_long" in llm:
        # long_prefill's decode: the 2048-slot ring wrapped, every slot
        # live
        (Bl, Hl, Kl, Tl, dl), window = llm["k8_long"]
        sp_l, pos_l = AC.full_ring(Tl)
        spl = torch.tensor([sp_l] * Bl, dtype=torch.int32, device=device)
        pl_ = torch.full((Bl,), pos_l, dtype=torch.int32, device=device)
        ql = torch.randn(Bl, Hl, dl, generator=g, device=device)
        kl, vl = (torch.randn(Bl, Tl, Kl, dl, generator=g, device=device)
                  .permute(0, 2, 1, 3) for _ in range(2))

        def k8l():
            return decode_attention_kernel(ql, kl, vl, slot_pos=spl,
                                           pos=pl_, window=window)

        def k8lp():
            return decode_attention_ref(ql, kl, vl, slot_pos=spl, pos=pl_,
                                        window=window)

        errl = float((k8l() - k8lp()).abs().max())
        if not errl <= TOLERANCE:
            raise AssertionError(f"K8 at long_prefill's ring: {errl}")
        ok_l = (spl >= 0) & (spl <= pl_[:, None]) & \
            (pl_[:, None] - spl < window)
        live_l = int(ok_l.sum())
        b_ms, b_by = bound_ms(
            4 * (2 * Bl * Hl * dl + 2 * Kl * dl * live_l + Bl * Tl + Bl),
            4 * dl * Hl * live_l)
        k8_extra["slot_mask_long_prefill"] = {
            "shape": [Bl, Hl, Kl, Tl, dl], "window": window,
            "live": live_l, "max_abs_err": errl, "ms": time_ms(k8l),
            "plain_ms": time_ms(k8lp), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(sdpa_call(
                ql[:, :, None], kl, vl, attn_mask=ok_l[:, None, None, :])),
            "wrapper_eager_ms": eager_ms(k8l),
            "device_kernels": one_data_kernel(
                "K8 long_prefill ring", k8l, "decode_kernel", memset=True)}
        del ql, kl, vl
    row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:78",
        lambda: decode_attention_kernel(qd, kc, vc, lengths),
        lambda: decode_attention_ref(qd, kc, vc, lengths),
        sdpa_call(qd[:, :, None], kc, vc, attn_mask=mask),
        4 * (2 * B * H * d + 2 * K * d * live + B), 4 * d * H * live,
        (B, H, K, T, d),
        err=max([err8, max_err.get("decode_attention", 0.0),
                 max_err.get("decode_attention_ring", 0.0)]
                + [x["max_abs_err"] for x in k8_extra.values()]),
        lengths=lengths.tolist(), tolerance=TOLERANCE,
        library_call="scaled_dot_product_attention(attn_mask, gqa)",
        chunk=AC.DECODE_CHUNK,
        device_kernels=one_data_kernel(
            "K8", lambda: decode_attention_kernel(qd, kc, vc, lengths),
            "decode_kernel", memset=True),
        **k8_extra)

    # K9 at a full admission of the SSM model, then at the other shapes
    # its paths gave it; the model's strided layout and distribution
    def k9_case(shape):
        b, s, h, p, n, chunk = shape
        x, dt, A, B, C = SC.case_inputs(b, s, h, p, n, chunk, g, device)
        got = ssd_chunk_kernel(x, dt, A, B, C, chunk=chunk)
        want = ssd_chunk_ref(x, dt, A, B, C, chunk)
        tol = SC.tolerance(SC.cum_max(dt, A, chunk))
        err = 0.0
        for a, w in zip(got, want):
            e = float((a - w).abs().max())
            if not e <= tol * max(1.0, float(w.abs().max())):
                raise AssertionError(f"K9 at {shape}: {e}")
            err = max(err, e)
        return (x, dt, A, B, C, chunk), err

    def k9_blocks(args):
        """K9's head groups (``head_groups``) and blocks at ``args``."""
        x, _, _, B, _, chunk = args
        b, s, h, p = x.shape
        groups = head_groups(b, s // chunk, h, chunk, p, B.shape[-1],
                             device)
        return {"groups": groups, "blocks": b * (s // chunk) * groups}

    extra9 = {}
    for label, shape in llm.get("k9", {}).items():
        args, err = k9_case(shape)
        extra9[f"at_{label}"] = {
            "shape": list(shape), "max_abs_err": err,
            "ms": time_ms(lambda: ssd_chunk_kernel(*args[:5],
                                                   chunk=args[5])),
            "plain_ms": time_ms(lambda: ssd_chunk_ref(*args)),
            **tc_bounds(*ssd_work(*shape)),
            **k9_blocks(args)}
        del args
    if "ssd_chunk" in shapes:
        shape = shapes["ssd_chunk"]
        args, err9 = k9_case(shape)
        row("ssd_chunk", "src/repro_torch/csrc/ssd.cu",
            "src/repro/kernels/ssd/ssd.py:68",
            lambda: ssd_chunk_kernel(*args[:5], chunk=args[5]),
            lambda: ssd_chunk_ref(*args), None, *ssd_work(*shape), shape,
            err=max([err9, max_err.get("ssd_chunk", 0.0)]
                    + [x["max_abs_err"] for x in extra9.values()]),
            tolerance="ssd_cases.tolerance: 1e-5 + 2^-23 max|cum|, of "
                      "max(1, max|plain|)", library_call=None,
            tensor_cores=True, **k9_blocks(args),
            device_kernels=one_data_kernel(
                "K9", lambda: ssd_chunk_kernel(*args[:5], chunk=args[5]),
                "ssd_chunk_kernel"),
            **extra9)
    return rows


# ------------------------------------------------------------------- main

# kernels each main path must launch
SORT_MERGE_KERNELS = ("prefix_count", "hash_rows", "group_boundaries",
                      "running_segment_ids")
HASH_KERNELS = ("prefix_count", "running_segment_ids", "segment_reduce",
                "radix_rank")
ATTN_KERNELS = ("flash_attention", "decode_attention")
SHARDED_KERNELS = ("prefix_count", "hash_rows", "shard_rank",
                   "segment_reduce")
SHARED_CARD_NOTE = ("four shards on one card: these times measure the "
                    "tier's kernels, layout and host merges, not an "
                    "interconnect")


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
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels import reduce_cases as RD
    from repro_torch.kernels import scan_cases as SC

    device = torch.device("cuda", 0)
    # the reference computes in float32: no TF32 in matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    lib_tile = _build.library().repro_lookback_tile()
    if lib_tile != SC.TILE:
        raise AssertionError(f"scan_cases.TILE {SC.TILE} differs from the "
                             f"library's look-back tile {lib_tile}")
    lookback = check_lookback(device)
    for k, c in lookback.items():
        cases[k] += c
    lib = _build.library()
    if lib.repro_radix_rank_tiles(RC.TILE) != 1 or \
            lib.repro_radix_rank_tiles(RC.TILE + 1) != 2:
        raise AssertionError(f"radix_cases.TILE {RC.TILE} is not the "
                             f"library's K6 tile")
    radix = check_radix(device)
    cases["radix_rank"] += radix
    if (lib.repro_segment_reduce_batch(),
            lib.repro_segment_reduce_shared_max()) != (RD.BATCH,
                                                       RD.SHARED_MAX):
        raise AssertionError("reduce_cases.BATCH/SHARED_MAX differ from "
                             "the library's K5 batch and shared limit")
    reduce = check_reduce(device)
    cases["segment_reduce"] += reduce
    emit({"phase": "kernels", "bit_identical_cases": cases,
          "max_abs_err": errs, "tolerance": 0,
          "sizes": list(EDGE_SIZES),
          "lookback": {"tile": lib_tile, "sizes": list(SC.SIZES),
                       "kinds": list(SC.KINDS),
                       "key_kinds": list(SC.KEY_KINDS),
                       "repeats": SC.REPEATS,
                       "offsets": list(SC.OFFSETS),
                       "graph_replays": SC.REPLAYS, "streams": 2,
                       "cases": lookback},
          "radix": {"tile": RC.TILE, "sizes": list(RC.SIZES),
                    "kinds": list(RC.KINDS), "buckets": list(RC.BUCKETS),
                    "repeats": RC.REPEATS, "graph_replays": RC.REPLAYS,
                    "streams": 2, "cases": radix},
          "reduce": {"batch": RD.BATCH, "sizes": list(RD.SIZES),
                     "segments": list(RD.SEGMENTS),
                     "id_kinds": list(RD.ID_KINDS),
                     "offsets": list(RD.OFFSETS),
                     "graph_replays": RD.REPLAYS, "streams": 2,
                     "cases": reduce},
          "seconds": time.perf_counter() - t0, "gpu": smi})
    t0 = time.perf_counter()
    if lib.repro_decode_chunk() != AC.DECODE_CHUNK:
        raise AssertionError(f"attention_cases.DECODE_CHUNK "
                             f"{AC.DECODE_CHUNK} differs from the "
                             f"library's {lib.repro_decode_chunk()}")
    attn = check_attention(device)
    errs.update(attn["max_abs_err"])
    split = check_decode_split(device)
    errs["decode_attention_split"] = split["max_abs_err"]
    emit({"phase": "attention", **attn, "decode_split": split,
          "decode_chunk": AC.DECODE_CHUNK,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    t0 = time.perf_counter()
    ssd = check_ssd(device)
    errs["ssd_chunk"] = ssd["max_abs_err"]
    emit({"phase": "ssd", **ssd, "seconds": time.perf_counter() - t0,
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

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = run_e2e_sharded(device)
    emit({"phase": "e2e_sharded", **sharded,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": SHARED_CARD_NOTE})
    require_launched("e2e_sharded", sharded["cold"]["launches"],
                     SHARDED_KERNELS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sstream = run_sharded_stream(device)
    emit({"phase": "sharded_stream", **sstream,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": SHARED_CARD_NOTE})
    require_launched("sharded_stream (aggregate)",
                     sstream["aggregate"]["partitioned"]["launches"],
                     ("hash_rows", "shard_rank", "segment_reduce"))
    require_launched("sharded_stream (join)",
                     sstream["join"]["partitioned"]["launches"],
                     ("hash_rows", "shard_rank"))
    torch.cuda.empty_cache()

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve = run_serve(device)
    engines = serve.pop("engines")
    emit({"phase": "serve", **serve, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    require_launched("serve", serve["kernel"]["launches"], ATTN_KERNELS)

    t0 = time.perf_counter()
    llm = run_llm_query(device, engines)
    emit({"phase": "llm_query", **llm, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    require_launched("llm_query", llm["launches"], ATTN_KERNELS)
    del engines
    gc.collect()  # an engine and its scheduler refer to each other

    served = {}
    for phase, arch, need in (("serve_ssm", SSM_ARCH, ("ssd_chunk",)),
                              ("serve_hybrid", HYBRID_ARCH, LLM_KERNELS)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        served[phase] = run_serve(device, arch=arch, n_prompts=SSM_PROMPTS)
        out = {k: v for k, v in served[phase].items() if k != "engines"}
        emit({"phase": phase, **out, "seconds": time.perf_counter() - t0,
              "gpu": smi})
        require_launched(phase, out["kernel"]["launches"], need)
    ssm, hyb = served["serve_ssm"], served["serve_hybrid"]

    t0 = time.perf_counter()
    long = run_long_prefill(device, ssm["engines"][0], hyb["engines"][0])
    emit({"phase": "long_prefill", **long,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    require_launched("long_prefill (ssm)", long["ssm"]["launches"],
                     ("ssd_chunk",))
    require_launched("long_prefill (hybrid)", long["hybrid"]["launches"],
                     LLM_KERNELS)
    del ssm["engines"]
    gc.collect()

    t0 = time.perf_counter()
    llm_h = run_llm_query(device, hyb.pop("engines"), qids=HYBRID_QIDS)
    emit({"phase": "llm_query_hybrid", **llm_h,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    require_launched("llm_query_hybrid", llm_h["launches"], LLM_KERNELS)
    torch.cuda.empty_cache()

    launches = dict(e2e["launches"])
    shapes = dict(e2e["shapes"])
    for k in ("segment_reduce", "radix_rank"):
        launches[k] = e2e_hash["launches"][k]
        shapes[k] = e2e_hash["shapes"][k]
    launches["shard_rank"] = sharded["cold"]["launches"]["shard_rank"]
    shapes["shard_rank"] = sharded["cold"]["shapes"]["shard_rank"]
    for k in ATTN_KERNELS:
        launches[k] = serve["kernel"]["launches"][k]
        shapes[k] = serve["kernel"]["shapes"][k]
    launches["ssd_chunk"] = ssm["kernel"]["launches"]["ssd_chunk"]
    shapes["ssd_chunk"] = ssm["kernel"]["shapes"]["ssd_chunk"]
    hshapes = hyb["kernel"]["shapes"]
    lshapes = long["hybrid"]["shapes"]
    window = hyb["attn_window"]
    llm_shapes = {
        "k7": {"serve_hybrid": (hshapes["flash_attention"], window),
               "long_prefill": (lshapes["flash_attention"], window)},
        "k8": (hshapes["decode_attention"], hyb["decode_lengths"], window),
        "k8_prefill_len": hyb["max_seq"],
        "k8_long": (lshapes["decode_attention"], window),
        "k9": {"serve_hybrid": hshapes["ssd_chunk"],
               "long_prefill_ssm": long["ssm"]["shapes"]["ssd_chunk"],
               "long_prefill_hybrid": lshapes["ssd_chunk"]}}
    rows = kernel_rows(device, launches, shapes, errs,
                       {"e2e": e2e["launches"],
                        "e2e_hash": e2e_hash["launches"],
                        "e2e_sharded": sharded["cold"]["launches"],
                        "e2e_sharded_warm": sharded["warm"]["launches"],
                        "sharded_stream_aggregate":
                            sstream["aggregate"]["partitioned"]["launches"],
                        "sharded_stream_join":
                            sstream["join"]["partitioned"]["launches"],
                        "serve": serve["kernel"]["launches"],
                        "llm_query": llm["launches"],
                        "serve_ssm": ssm["kernel"]["launches"],
                        "serve_hybrid": hyb["kernel"]["launches"],
                        "long_prefill_ssm": long["ssm"]["launches"],
                        "long_prefill_hybrid": long["hybrid"]["launches"],
                        "llm_query_hybrid": llm_h["launches"]},
                       serve["decode_lengths"], llm=llm_shapes,
                       n_shards=sharded["n_shards"])
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
