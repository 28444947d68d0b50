"""Time K8 (decode attention) and K6 (radix rank) on one CUDA card at the
shapes their main paths give them, for this tree's kernels, for the
same sources rebuilt with one design choice changed, and for another
tree's kernels:

    python chip_sweep.py [--root DIR ...] [--rounds 2]

Shapes: K8 with lengths at starcoder2-3b's first decode round
(16, 24, 2, 131, 128) (lengths pos + 1 of the first 16 of
``chip_smoke.serve_prompts``), K8 with the slot mask at hymba-1.5b's
(16, 25, 5, 131, 64) (the same rows, window 2048) and at long_prefill's
2048-slot ring wrapped with every slot live (1, 25, 5, 2048, 64); K6 at
(4,194,304,) over 256 uniform digits. Each time is ``chip_smoke.time_ms``
(the median of 30 samples of 20 CUDA-graph replays).

The variants (``VARIANTS``) copy ``src/repro_torch/csrc`` under the
git-ignored ``build/sweep/``, change one design choice there (a
``constexpr``, or a line) and build the library from the copy. Every
tree and variant is timed in a process of its own, all of them in turn,
``--rounds`` times. Prints one JSON line
per measurement, then the card's name and power limit. Needs a CUDA
card; imports nothing of the JAX package.
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
    "k8_chunk_16": ("decode_attention.cu", [
        ("constexpr int kChunk = 64;", "constexpr int kChunk = 16;")]),
    "k8_chunk_32": ("decode_attention.cu", [
        ("constexpr int kChunk = 64;", "constexpr int kChunk = 32;")]),
    "k8_threads_256": ("decode_attention.cu", [
        ("constexpr int kThreads = 384;", "constexpr int kThreads = 256;")]),
    # timing only, the output left unwritten: the last arrival returns
    # without combining; every block returns at once (the memset and the
    # launch)
    "k8_no_combine": ("decode_attention.cu", [
        ("  if (!s_flag[1]) return;", "  return;")]),
    "k8_empty": ("decode_attention.cu", [
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
         "  if (a.T > 0) return;\n"
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;")]),
    "k6_rows_16": ("radix_rank.cu", [
        ("constexpr int kRuns = 32;", "constexpr int kRuns = 16;")]),
    "k6_window_16": ("radix_rank.cu", [
        ("constexpr int kWindow = 8;", "constexpr int kWindow = 16;")]),
    "k6_match_any": ("radix_rank.cu", [
        ("    peers[j] = peers_of(d[j] >= 0 ? d[j] : buckets, bits);",
         "    peers[j] = __match_any_sync(kFull, d[j] >= 0 ? d[j] : -1 - lane);"
         )]),
    "k6_acquire_release": ("radix_rank.cu", [
        ("      w[i] = t >= 0 ? lb::load_relaxed(",
         "      w[i] = t >= 0 ? lb::load_acquire("),
        ("        w[i] = lb::load_relaxed(", "        w[i] = lb::load_acquire("),
        ("    lb::store_relaxed(mine + b,\n",
         "    lb::store_release(mine + b,\n"),
        ("      lb::store_relaxed(mine + b, lb::pack(lb::kPrefix",
         "      lb::store_release(mine + b, lb::pack(lb::kPrefix")]),
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
    import numpy as np
    import torch

    sys.path.insert(0, str(src))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_kernel)
    from repro_torch.kernels.hash_join.hash_join import radix_rank_kernel

    if csrc is not None:
        _build.CSRC = csrc
        _build.BUILD_DIR = csrc.parent / "lib"
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    lens = [min(len(p.split()) + 2, 128)
            for p in chip_smoke.serve_prompts(16)]
    out = {"live": int(np.sum(lens))}

    def cache(B, H, K, T, d):
        q = torch.randn(B, H, d, generator=g, device=dev)
        k, v = (torch.randn(B, T, K, d, generator=g, device=dev)
                .permute(0, 2, 1, 3) for _ in range(2))
        return q, k, v

    q, k, v = cache(16, 24, 2, 131, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    out["k8_lengths_ms"] = chip_smoke.time_ms(
        lambda: decode_attention_kernel(q, k, v, lengths))
    q, k, v = cache(16, 25, 5, 131, 64)
    sp = torch.arange(131, dtype=torch.int32, device=dev).expand(
        16, 131).contiguous()
    sp[:, 128:] = -1
    pos = lengths - 1
    out["k8_slot_mask_ms"] = chip_smoke.time_ms(
        lambda: decode_attention_kernel(q, k, v, slot_pos=sp, pos=pos,
                                        window=2048))
    q, k, v = cache(1, 25, 5, 2048, 64)
    p = 3 * 2048 + 7
    ring = torch.tensor([[p - (p - t) % 2048 for t in range(2048)]],
                        dtype=torch.int32, device=dev)
    pr = torch.tensor([p], dtype=torch.int32, device=dev)
    out["k8_ring_2048_ms"] = chip_smoke.time_ms(
        lambda: decode_attention_kernel(q, k, v, slot_pos=ring, pos=pr,
                                        window=2048))
    digits = torch.randint(0, 256, (1 << 22,), generator=g, device=dev,
                           dtype=torch.int32)
    hist = torch.bincount(digits, minlength=256)
    base = (torch.cumsum(hist, 0) - hist).to(torch.int32)
    out["k6_ms"] = chip_smoke.time_ms(lambda: radix_rank_kernel(digits,
                                                                base))
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
