"""Run one cell of the benchmark traced, with the port's span recorder
(``repro_torch.trace``) on for the window, and read its spans against
the device records (``bench/spans.py``):

    python chip_spans.py --workload semsql.olmoe-1b-7b --seed 7 \
        --seconds 30
    python chip_spans.py --clock

The run is ``bench/run.py --trace 1``'s (``bench.harness.run_cell``),
with its window (``bench.devtrace.Window``) replaced by one that turns
the recorder on after the window's spin kernels, keeps the profiler's
runtime calls (their launch records among them) and each device
record's correlation id, and closes with three clock checks (a span
around a synchronised ``torch.cuda._sleep``, whose device record the
span must enclose). Prints one JSON line: the harness's result line
(``correct``, the per-layer metrics, the breakdown) with
``span_metrics`` (the six readings of ``bench/spans.py``),
``prefill_fill`` (the share of prefilled positions that held a prompt
token, from the admissions' span attributes), ``spans``
(each span name's count, mean and self ms, idle ms inside it and share
of the device's busy time launched with it innermost), ``host_calls``
(where the host's time goes inside the serving spans, by runtime
call), ``launch_match`` (the share of device time whose launch record
was found), ``clock`` and the card's name and power limit. ``--clock``
runs the clock checks alone, before and after 30 s of waiting. Needs a
CUDA card; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECK = "clock.check"
CHECK_CYCLES = 2_000_000

METRICS = {
    "queue_wait_p95_s": lambda sp, run: sp.queue_wait_p95_s(run),
    "round_launch_ms": lambda sp, run: sp.mean_ms(run,
                                                  "serving.round.launch"),
    "round_idle_ms": lambda sp, run: sp.idle_ms(run, "serving.round"),
    "admit_idle_ms": lambda sp, run: sp.idle_ms(run, "serving.admit"),
    "expert_share": lambda sp, run: sp.share(run, "model.moe.experts"),
    "route_share": lambda sp, run: sp.share(run, "model.moe.route"),
}


def records(prof) -> tuple[list, dict, list]:
    """(name, start_ns, end_ns, correlation) of every device record,
    {correlation: start_ns} of the host calls that launched them, and
    (name, start_ns, end_ns) of every runtime call. A device record's
    correlation is its ``correlation_id``, or its
    ``linked_correlation_id`` where the first matches no host call."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, calls = [], {}, []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == cuda:
            dev.append((e.name(), s, s + e.duration_ns(),
                        e.correlation_id(), e.linked_correlation_id()))
            continue
        calls.append((e.name(), s, s + e.duration_ns()))
        if e.correlation_id():
            c = e.correlation_id()
            host[c] = min(s, host.get(c, s))
    k = 3 if sum(r[3] in host for r in dev) >= \
        sum(r[4] in host for r in dev) else 4
    return [(r[0], r[1], r[2], r[k]) for r in dev], host, calls


def clock_checks(rec, n: int = 3) -> None:
    import torch

    for _ in range(n):
        with rec.span(CHECK):
            torch.cuda._sleep(CHECK_CYCLES)
            torch.cuda.synchronize()


def clock_report(spans, dev, launches) -> list:
    """Per clock check: ns from the span's start to its kernel's launch
    and to the kernel's start, and from the kernel's end to the span's
    end (all three > 0 when the clocks agree)."""
    from bench.devtrace import SPIN

    sleeps = [r for r in dev if SPIN in r[0] and r[3] in launches]
    out = []
    for sp in (s for s in spans if s[0] == CHECK):
        mine = [r for r in sleeps if sp[1] <= launches[r[3]] <= sp[2]]
        if len(mine) != 1:
            out.append({"kernels": len(mine)})
            continue
        (_, s, e, c), = mine
        out.append({"to_launch_ns": launches[c] - sp[1],
                    "to_kernel_ns": s - sp[1], "after_kernel_ns": sp[2] - e})
    return out


def window_class():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench import devtrace
    from repro_torch.trace import RECORDER

    class SpanWindow(devtrace.Window):
        """``devtrace.Window`` with the span recorder on inside it and
        the runtime calls kept."""

        last = None

        def __init__(self, body):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(devtrace.SPINS):
                    torch.cuda._sleep(devtrace.SPIN_CYCLES)
                torch.cuda.synchronize()
                RECORDER.enable()
                clock_checks(RECORDER)
                self.t0 = time.time_ns()
                self.result = body()
                torch.cuda.synchronize()
                self.t1 = time.time_ns()
                clock_checks(RECORDER)
                RECORDER.disable()
            self.spans = RECORDER.take()
            dev, self.launches, calls = records(prof)
            self.spins_kept = sum(devtrace.SPIN in r[0] for r in dev)
            if not self.spins_kept:
                raise RuntimeError("the profiler kept none of the window's "
                                   "spin kernels")
            self.clock = clock_report(self.spans, dev, self.launches)
            self.records = [(n, max(s, self.t0), min(e, self.t1), c)
                            for n, s, e, c in dev
                            if devtrace.SPIN not in n and e > self.t0
                            and s < self.t1]
            self.calls = [c for c in calls
                          if c[2] > self.t0 and c[1] < self.t1]
            self.events = [r[:3] for r in self.records]
            SpanWindow.last = self

    return SpanWindow


def span_table(sp, run) -> dict:
    """Each span name's count, mean and self ms, idle ms inside it and
    % of device busy time launched with it innermost."""
    tr = run["trace"]
    spans = tr["spans"]
    self_ns = sp.self_ns(spans)
    g = sp.gaps(tr["records"], tr["t0_ns"], tr["t1_ns"])
    starts = [a for a, _ in g]
    busy = sum(e - s for s, e in sp.busy(tr["records"]))
    launched: dict = {}
    for r, inner in sp.kernel_spans(run):
        if inner is not None:
            launched[inner[0]] = launched.get(inner[0], 0) + r[2] - r[1]
    out = {}
    for name in sorted({s[0] for s in spans}):
        mine = [s for s in spans if s[0] == name]
        n = len(mine)
        out[name] = {
            "count": n,
            "mean_ms": sum(s[2] - s[1] for s in mine) / n / 1e6,
            "self_ms": sum(self_ns[s[3]] for s in mine) / n / 1e6,
            "idle_ms": sum(sp.overlap_ns(g, starts, s[1], s[2])
                           for s in mine) / n / 1e6,
            "busy_pct": 100 * launched.get(name, 0) / busy if busy else None}
    return out


def prefill_fill(spans):
    """Share of the positions the window's admissions prefilled that held
    a prompt token, from the ``serving.admit`` spans' ``tokens`` and
    ``positions``; None where the spans carry no ``positions``."""
    admits = [s for s in spans if s[0] == "serving.admit"]
    if not admits or any("positions" not in s[6] for s in admits):
        return None
    return sum(s[6]["tokens"] for s in admits) / \
        sum(s[6]["positions"] for s in admits)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def host_calls(sp, run, top: int = 4) -> dict:
    """For each serving span that waits or launches, ``calls_in``'s
    reading with its ``top`` runtime calls by time."""
    out = {}
    for name in ("serving.round.launch", "serving.round.fetch",
                 "serving.admit.upload", "serving.admit.prefill"):
        got = sp.calls_in(run, name)
        if got:
            got["calls"] = dict(sorted(got["calls"].items(),
                                       key=lambda kv: -kv[1]["ms"])[:top])
        out[name] = got
    return out


def run_cell(workload: str, seed: int, seconds: float) -> dict:
    import torch

    from bench import devtrace, harness, manifest
    from bench import spans as sp

    cell = manifest.cell(manifest.manifest(), workload)
    cls = window_class()
    devtrace.Window = cls  # the harness opens its window through this
    result = harness.run_cell(cell, seed, seconds, True,
                              torch.device("cuda", 0))
    w = cls.last
    run = {"trace": {"spans": w.spans, "records": w.records,
                     "launches": w.launches, "calls": w.calls,
                     "t0_ns": w.t0, "t1_ns": w.t1}}
    busy = sum(r[2] - r[1] for r in w.records)
    found = sum(r[2] - r[1] for r in w.records if r[3] in w.launches)
    out = {"workload": workload, "seed": seed,
           "correct": result["correct"], "attempted": result["attempted"],
           "window_s": result["device"]["window_s"],
           "traced_query_s": result["device"]["window_s"]
           / result["attempted"],
           "span_metrics": {k: f(sp, run) for k, f in METRICS.items()},
           "prefill_fill": prefill_fill(w.spans),
           "launch_match": found / busy if busy else None,
           "clock": w.clock, "spans": span_table(sp, run),
           "host_calls": host_calls(sp, run)}
    out["result"] = {k: result[k] for k in ("metrics", "breakdown",
                                            "device")}
    return out


def clock_only() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.trace import RECORDER

    torch.cuda._sleep(CHECK_CYCLES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        RECORDER.enable()
        clock_checks(RECORDER, 5)
        time.sleep(30)
        clock_checks(RECORDER, 5)
        RECORDER.disable()
    dev, launches, _ = records(prof)
    return {"clock": clock_report(RECORDER.take(), dev, launches)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_spans.py")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--clock", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_spans.py needs a CUDA card", file=sys.stderr)
        return 2
    if args.clock:
        out = clock_only()
    else:
        out = run_cell(args.workload, args.seed, args.seconds)
    out["card"] = card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main(sys.argv[1:]))
