"""The dry-run sweep: every (arch x shape) x {single, multi} cell in its
own process, one after another (the reference's
``src/repro/launch/sweep.py``).

    PYTHONPATH=src python -m repro_torch.launch.sweep --out artifacts/dryrun

Artifacts already present are skipped, so the sweep resumes. A cell that
fails (or passes ``--timeout``) leaves ``<cell>.FAILED`` with the tail
of its stderr, and the sweep goes on.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

from .specs import all_cells


def cell_path(out: Path, arch: str, shape: str, mesh: str) -> Path:
    return out / f"{arch}__{shape}__{mesh}.json"


def cell_command(arch: str, shape: str, mesh: str, out: Path,
                 probe: bool) -> list[str]:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh,
           "--out", str(out)]
    if not probe or mesh == "multi":
        cmd.append("--no-probe")
    return cmd


def run(out_dir: str, meshes: list[str], only_arch: str | None = None,
        timeout_s: int = 2400, probe: bool = True):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cells = all_cells()
    todo = []
    for mesh in meshes:
        for arch, shape in cells:
            if only_arch and arch != only_arch:
                continue
            p = cell_path(out, arch, shape, mesh)
            if p.exists():
                continue
            todo.append((arch, shape, mesh))
    print(f"sweep: {len(todo)} cells to run "
          f"({len(cells)} defined per mesh, skips excluded)")
    t_start = time.time()
    for i, (arch, shape, mesh) in enumerate(todo):
        cmd = cell_command(arch, shape, mesh, out, probe)
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout_s)
            ok = r.returncode == 0
        except subprocess.TimeoutExpired as e:
            ok = False
            r = e
        dt = time.time() - t0
        status = "ok" if ok else "FAIL"
        print(f"[{i+1}/{len(todo)}] {arch} x {shape} x {mesh}: {status} "
              f"({dt:.0f}s, total {(time.time()-t_start)/60:.1f}m)",
              flush=True)
        if not ok:
            tail = getattr(r, "stderr", "") or ""
            if isinstance(tail, bytes):
                tail = tail.decode(errors="replace")
            cell_path(out, arch, shape, mesh).with_suffix(
                ".FAILED").write_text(tail[-4000:])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    run(args.out, meshes, args.arch, args.timeout)


if __name__ == "__main__":
    main()
