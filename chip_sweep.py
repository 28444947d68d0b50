"""Time K3 (group boundaries) and K5 (segmented reduction) on one CUDA
card at the shapes their main paths give them, for this tree's kernels,
for the same sources rebuilt with one design choice changed, and for
another tree's kernels:

    python chip_sweep.py [--root DIR ...] [--rounds 2]

Shapes: K3 at e2e's largest build, (12,584,948,) sorted keys with runs
of ~4 (``chip_smoke.kernel_rows``' input); K5 at e2e_hash's group-by,
(5,768,831,) float32 rows into 120 groups (max), and at its radix
histograms, (4,194,304,) int32 ones over 8-bit digits into 256 buckets
(sum); K1 at 2^24 0/1 flags beside them, the look-back's other client.
Each time is ``chip_smoke.time_ms`` (the median of 30 samples of 20
CUDA-graph replays).

The variants (``VARIANTS``) copy ``src/repro_torch/csrc`` under the
git-ignored ``build/sweep/``, change one design choice there (a
``constexpr``) and build the library from the copy. Every tree and
variant is timed in a process of its own, all of them in turn,
``--rounds`` times. Prints one JSON line per measurement, then the
card's name and power limit. Needs a CUDA card; imports nothing of the
JAX package.
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
    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.ref import group_boundaries_ref
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
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[],
                    help="another tree to time (its src/repro_torch)")
    ap.add_argument("--rounds", type=int, default=2)
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
             for name in VARIANTS]
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
