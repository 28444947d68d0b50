"""Time K3 (group boundaries), K5 (segmented reduction), K10 (shard
rank), K6 (radix rank) and K7 (flash attention) at head_dim 256 on one
CUDA card at the shapes their main paths give them, for this tree's
kernels, for the same sources rebuilt with one design choice changed,
and for another tree's kernels:

    python chip_sweep.py [--root DIR ...] [--rounds 2] [--variant NAME ...]

Shapes: K3 at e2e's largest build, (12,584,948,) sorted keys with runs
of ~4 (``chip_smoke.kernel_rows``' input); K5 at e2e_hash's group-by,
(5,768,831,) float32 rows into 120 groups (max), and at its radix
histograms, (4,194,304,) int32 ones over 8-bit digits into 256 buckets
(sum); K1 at 2^24 0/1 flags beside them, the look-back's other client;
K10 at e2e_sharded's source block, (4,194,304,) uniform destinations
into P = 4 fixed-stride buckets, and into P = 32, each with K6 over the
same B = P buckets beside it; K6 at e2e_hash's largest radix pass,
(4,194,304,) uniform 8-bit digits into 256 buckets; K7 at the vlm
phase's prefix route, (16,8,1,288,288,256) causal and (16,8,1,256,256,
256) bidirectional (paligemma-3b's head), through the model's
transposed views. Each time is
``chip_smoke.time_ms`` (the median of 30 samples of 20 CUDA-graph
replays).

The variants (``VARIANTS``) copy ``src/repro_torch/csrc`` under the
git-ignored ``build/sweep/``, change one design choice there (a
``constexpr``) and build the library from the copy. Every tree and
variant is timed in a process of its own, all of them in turn,
``--rounds`` times; ``--variant`` runs only the named variants (all by
default, none with ``--variant none``). Prints one JSON line per
measurement, then the card's name and power limit. Needs a CUDA card;
imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# name -> (source, [(text, replacement), ...]): each text occurs once
VARIANTS = {
    # the look-back's tile (K1, K3 and K4 share it): items per thread
    "lookback_items_16": ("scan_lookback.cuh", [
        ("constexpr int kItems = 32;", "constexpr int kItems = 16;")]),
    "lookback_items_48": ("scan_lookback.cuh", [
        ("constexpr int kItems = 32;", "constexpr int kItems = 48;")]),
    # K5's loads in flight: 16-byte id (and value) loads per batch
    "k5_rounds_2": ("segment_reduce.cu", [
        ("constexpr int kRounds = 4;", "constexpr int kRounds = 2;")]),
    "k5_rounds_8": ("segment_reduce.cu", [
        ("constexpr int kRounds = 4;", "constexpr int kRounds = 8;")]),
    "k5_blocks_2": ("segment_reduce.cu", [
        ("constexpr int kBlocksPerSm = 4;",
         "constexpr int kBlocksPerSm = 2;")]),
    "k5_blocks_8": ("segment_reduce.cu", [
        ("constexpr int kBlocksPerSm = 4;",
         "constexpr int kBlocksPerSm = 8;")]),
    # K10's peers above kPerBucketMax buckets: __match_any_sync instead
    # of one ballot per bucket bit
    "k10_match_any": ("shard_rank.cu", [
        ("constexpr bool kMatchAny = false;",
         "constexpr bool kMatchAny = true;")]),
    # K10's per-bucket ballots (and register counts) up to 8 buckets
    "k10_per_bucket_8": ("shard_rank.cu", [
        ("constexpr int kPerBucketMax = 4;",
         "constexpr int kPerBucketMax = 8;")]),
    # K10's look-back window: one warp or four read a row of status words
    "k10_window_1": ("shard_rank.cu", [
        ("constexpr int kWindowWarps = kWarps;",
         "constexpr int kWindowWarps = 1;")]),
    "k10_window_4": ("shard_rank.cu", [
        ("constexpr int kWindowWarps = kWarps;",
         "constexpr int kWindowWarps = 4;")]),
    # K10's tile: rows per lane (the tile is 256 times as many rows)
    "k10_runs_16": ("shard_rank.cu", [
        ("constexpr int kRuns = 32;", "constexpr int kRuns = 16;")]),
    # K7 above head_dim 128: the score product's 8-column steps unrolled
    # 1, 2 or 4 at a time (8 in the tree)
    **{f"k7_wide_unroll_{u}": ("flash_attention.cu", [
        ("DP <= 128 ? DP / 8 : 8;", f"DP <= 128 ? DP / 8 : {u};")])
       for u in (1, 2, 4)},
}


def variant_csrc(name: str) -> Path:
    """A copy of this tree's kernel sources with the variant's
    replacements made; returns its directory."""
    source, subs = VARIANTS[name]
    dst = ROOT / "build" / "sweep" / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", dst)
    path = dst / source
    text = path.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in {source} once")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def measure(src: Path, csrc: Path | None) -> dict:
    """Times of this process's kernels: the package under ``src``, built
    from ``csrc`` when given."""
    import torch

    sys.path.insert(0, str(src))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.ref import group_boundaries_ref
    from repro_torch.kernels.partition.partition import shard_rank_kernel
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)

    if csrc is not None:
        _build.CSRC = csrc
        _build.BUILD_DIR = csrc.parent / "lib"
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    n = 12_584_948
    keys = torch.sort(torch.randint(0, n // 4, (n,), generator=g,
                                    device=dev, dtype=torch.int32))[0]
    if not all(torch.equal(a, b) for a, b in zip(
            group_boundaries_kernel(keys), group_boundaries_ref(keys))):
        raise AssertionError("K3 differs from its plain version")
    out["k3_ms"] = chip_smoke.time_ms(lambda: group_boundaries_kernel(keys))
    n, gs = 5_768_831, 120
    vals = torch.randn(n, generator=g, device=dev) * 100
    seg = torch.randint(0, gs, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    got = segment_reduce_kernel(vals, seg, gs, "max")
    if not torch.equal(got.view(torch.int32),
                       segment_reduce_torch(vals, seg, gs, "max")
                       .view(torch.int32)):
        raise AssertionError("K5 max differs from its plain version")
    out["k5_max_ms"] = chip_smoke.time_ms(
        lambda: segment_reduce_kernel(vals, seg, gs, "max"))
    n = 1 << 22
    digit = torch.randint(0, 256, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    ones = torch.ones_like(digit)
    if not torch.equal(segment_reduce_kernel(ones, digit, 256, "sum"),
                       segment_reduce_torch(ones, digit, 256, "sum")):
        raise AssertionError("K5 histogram differs from its plain version")
    out["k5_histogram_ms"] = chip_smoke.time_ms(
        lambda: segment_reduce_kernel(ones, digit, 256, "sum"))
    flags = torch.randint(0, 2, (1 << 24,), generator=g, device=dev,
                          dtype=torch.int32)
    out["k1_ms"] = chip_smoke.time_ms(lambda: prefix_count_kernel(flags))
    n = 1 << 22
    for p in (4, 32):
        dest = torch.randint(0, p, (n,), generator=g, device=dev,
                             dtype=torch.int32)
        base = torch.arange(p, dtype=torch.int32, device=dev) * n
        got = shard_rank_kernel(dest, base)
        if not torch.equal(got, radix_rank_torch(dest, base)) or \
                not torch.equal(got, radix_rank_kernel(dest, base)):
            raise AssertionError(f"K10 at P = {p} differs from its plain "
                                 f"version or from K6")
        out[f"k10_p{p}_ms"] = chip_smoke.time_ms(
            lambda: shard_rank_kernel(dest, base))
        out[f"k6_b{p}_ms"] = chip_smoke.time_ms(
            lambda: radix_rank_kernel(dest, base))
    digit = torch.randint(0, 256, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    base = RC.exclusive_bases(digit, 256)
    if not torch.equal(radix_rank_kernel(digit, base),
                       radix_rank_torch(digit, base)):
        raise AssertionError("K6 differs from its plain version")
    out["k6_ms"] = chip_smoke.time_ms(lambda: radix_rank_kernel(digit, base))
    for S, causal in ((288, True), (256, False)):
        q, k, v = (torch.randn(16, S, n, 256, generator=g, device=dev)
                   .transpose(1, 2) for n in (8, 1, 1))
        err = float((flash_attention_kernel(q, k, v, causal=causal)
                     - attention_ref(q, k, v, causal=causal)).abs().max())
        if not err <= AC.TOLERANCE:
            raise AssertionError(f"K7 at S = {S}, d = 256: {err}")
        out[f"k7_d256_{'causal' if causal else 'bidir'}_ms"] = \
            chip_smoke.time_ms(lambda: flash_attention_kernel(
                q, k, v, causal=causal))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[],
                    help="another tree to time (its src/repro_torch)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", action="append", choices=[*VARIANTS, "none"],
                    help="time only these variants (default: all)")
    ap.add_argument("--child", nargs=2, metavar=("SRC", "CSRC"))
    args = ap.parse_args()
    if args.child:
        src, csrc = args.child
        print(json.dumps(measure(Path(src),
                                 None if csrc == "-" else Path(csrc))))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device", file=sys.stderr)
        return 2
    runs = [("this tree", ROOT / "src", "-")]
    runs += [(name, ROOT / "src", str(variant_csrc(name)))
             for name in args.variant or VARIANTS if name != "none"]
    runs += [(root, Path(root).resolve() / "src", "-") for root in args.root]
    for r in range(args.rounds):
        for label, src, csrc in runs:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", str(src), csrc],
                capture_output=True, text=True, cwd=ROOT, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"{label}: {proc.stderr[-4000:]}")
            times = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"round": r, "run": label, **times}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
