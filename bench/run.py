"""Run one cell of the benchmark on the card and print its result line.

    python3 bench/run.py --workload semsql.starcoder2-3b --seed 7 \
        --seconds 30 --trace 0

Exits 2 without a result when CUDA is missing or has fewer devices than
the cell asks for. Every build and kernel cache stays under ``build/``
in this checkout."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    # the bench package and the port, never this directory as top level
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import main

    sys.exit(main(sys.argv[1:]))
