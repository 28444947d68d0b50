"""The readings a cell's correctness limits are set from (not run by the
benchmark's own runs).

    python3 bench/control.py --workload semsql.starcoder2-3b \
        --seeds 101 102 103 --control 3 --seconds 0

For each seed, in one process: the cell's set-up and a window of
``--seconds`` (0: one pass after the warm one) at the cell's own load,
then the comparison as a run makes it. It prints, one JSON line a
seed, every number compared, and for the first ``--control`` seeds the
control's reading of the same sample: the reference put in the
program's place at the next lower precision (TF32 for float32 with TF32
off), the widest gap under the float32 reference of the token TF32
puts first."""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import torch

    from bench import check, harness, manifest

    ap = argparse.ArgumentParser(prog="bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs the card", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.manifest(), args.workload)
    cfg, mix = cell.config, cell.mix
    ref = manifest.reference(cfg["family"])
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        ses = harness.session(cell, seed, args.seconds, False, dev)
        checks = check.judge(ref, cfg, ses.work, ses.passes, ses.warm,
                             ses.params, seed, ses.steps)
        out = {"seed": seed, "passes": len(ses.passes),
               **{k: v for k, v, _, _ in checks}}
        if i < args.control:
            low = check.replay(ref, cfg, ses.params, ses.steps, tf32=True)
            out.update({f"control_{k}": v for k, v in low.items()})
        if i < args.control and cfg["check"]["mode"] == "teacher_forced":
            eng = cfg["engine"]
            reqs = [r for ps in ses.passes for q in ps
                    for r in q["requests"] if r[1]]
            idx = check.sample(reqs, mix["check_requests"],
                               mix["check_longest"], seed, eng["max_seq"],
                               cfg["vocab_size"])
            rows, _, _ = check.teacher_rows(reqs, idx, eng["max_seq"],
                                            cfg["vocab_size"])
            out["control_teacher_gap"] = check.control_gap(
                ref, cfg, ses.params, rows)
        print(json.dumps(out), flush=True)
        del ses
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
