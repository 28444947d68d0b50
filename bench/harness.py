"""One run of one cell: set-up, the measured window, the comparison
with the plain references, the metrics, the result line.

The window is a closed loop of whole passes of the cell's mix: each
query runs from ``optimize`` to materialized rows before the next
starts; the cache scope resets at the start of every pass; passes run
until ``--seconds`` have gone by, and the pass in progress then
finishes. ``--trace 1`` runs the same window under the device profiler
with CUDA events around the serving tier's admissions and rounds, and
reports the per-layer metrics; ``--trace 0`` reports the end-to-end
ones. Both compare what the window produced."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch


from . import check, devtrace, manifest, port, probes, traffic, weights
from .ref import tokenizer as tk

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list:
    """JAX or the JAX package among ``modules`` (default
    ``sys.modules``), compared by whole top-level name."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test as one analyst session drives it: a
    ``Database`` and a ``FrontDoor`` a schema, all sharing one
    ``SemanticRunner`` over ``ModelBackend.from_engine`` on one
    ``ServingEngine``."""

    def __init__(self, cfg: dict, work, params, device, trace: bool):
        from repro_torch.engine import FrontDoor
        from repro_torch.semantic import ModelBackend, SemanticRunner
        from repro_torch.serving import ServingEngine

        e = cfg["engine"]
        if e["mode"] != "continuous":
            raise ValueError(f"serving mode {e['mode']!r}")
        self.device, self.work = device, work
        self.engine = ServingEngine(
            port.model_config(cfg), params, device=device,
            batch_size=e["batch_size"], max_seq=e["max_seq"],
            max_new_tokens=e["max_new_tokens"], attn_impl=e["attn_impl"],
            ssd_impl=e["attn_impl"])
        self.backend = ModelBackend.from_engine(self.engine)
        self.runner = SemanticRunner(self.backend)
        self.dbs = {s: port.database(t, device)
                    for s, t in work.tables.items()}
        self.doors = {s: FrontDoor(db, self.runner,
                                   n_lanes=work.mix["lanes"])
                      for s, db in self.dbs.items()}
        self.requests = probes.Requests(self.engine)
        self.phases = probes.Phases()
        self.timers = (probes.Timers(self.engine, self.phases)
                       if trace else None)

    def query(self, spec: dict) -> dict:
        from repro_torch.core import CostParams, optimize

        mix, ph = self.work.mix, self.phases
        db, door = self.dbs[spec["schema"]], self.doors[spec["schema"]]
        calls0 = self.backend.calls
        ph.enter("optimize")
        t0 = time.perf_counter()
        plan = optimize(port.plan(spec, self.work.templates[spec["schema"]]),
                        db.catalog(), strategy=mix["strategy"],
                        params=CostParams(**mix["cost_params"])).plan
        t1 = time.perf_counter()
        ph.leave()
        ph.enter("execute")
        table, stats = door.execute(plan)
        sync(self.device)
        ph.leave()
        ph.enter("materialize")
        rows = db.materialize(table, list(spec["out"]))
        ph.leave()
        return {"qid": spec["qid"], "out": spec["out"], "rows": rows,
                "optimize_s": t1 - t0,
                "llm_calls": stats.llm_calls,
                "cache_hits": stats.cache_hits,
                "pipeline_syncs": stats.pipeline_syncs,
                "backend_calls": self.backend.calls - calls0,
                "requests": self.requests.pop()}

    def one_pass(self) -> list:
        if self.work.mix["cache_scope"] != "pass":
            raise ValueError(f"cache scope {self.work.mix['cache_scope']!r}")
        self.runner.reset_query_scope()
        return [self.query(sp) for sp in self.work.queries]

    def window(self, seconds: float) -> tuple[list, float]:
        """Whole passes until ``seconds`` have gone by."""
        from repro_torch.serving import ServingStats

        self.engine.stats = ServingStats()
        passes = []
        t0 = time.perf_counter()
        while True:
            passes.append(self.one_pass())
            if time.perf_counter() - t0 >= seconds:
                return passes, time.perf_counter() - t0


def _k7_k8(shape_launches: dict) -> tuple[dict, dict]:
    k7, k8 = {}, {}
    for (name, variant, shape), n in shape_launches.items():
        if name == "flash_attention":
            k7[(shape, variant)] = n
        elif name == "decode_attention":
            k8[(shape, variant)] = n
    return k7, k8


@dataclass
class Session:
    """What one set-up and window left: the inputs, the passes, the
    run's record for the metric readers."""

    work: object
    params: dict
    warm: list  # the set-up's pass
    passes: list  # the window's passes
    run: dict
    breakdown: dict | None
    peak: int
    steps: object  # probes.Steps: the sampled admissions and rounds


def sampled_steps(cfg: dict, engine, warm: list, seed: int):
    """The window's admissions and rounds the check replays (the
    configuration's ``check``), drawn from ``seed``, with those that
    first serve the longest prompts."""
    chk = cfg["check"]
    if chk["mode"] not in ("teacher_forced", "step_replay"):
        raise ValueError(f"check mode {chk['mode']!r}")
    rng = np.random.default_rng(seed)
    n_adm, n_rnd = chk["within"]
    admits = set(rng.choice(n_adm, chk["admissions"], replace=False).tolist())
    rounds = set(rng.choice(n_rnd, chk["rounds"], replace=False).tolist())
    S, V = cfg["engine"]["max_seq"], cfg["vocab_size"]
    lens = {p: len(tk.prompt_tokens(p, S, V))
            for q in warm for p, _ in q["requests"]}
    top = max(lens.values())
    # a slot's position never passes its prompt's last plus the tokens
    # it serves, so these cache positions hold all that a step reads
    return probes.Steps(engine, admits, rounds,
                        {p for p, n in lens.items() if n == top},
                        positions=top + cfg["engine"]["max_new_tokens"])


def session(cell, seed: int, seconds: float, trace: bool,
            device) -> Session:
    """Set-up, then the window; the program's state is freed on return
    (the weights are the benchmark's and stay)."""
    cfg = cell.config
    cuda = device.type == "cuda"
    if cfg["dtype"] != "float32":
        raise ValueError(f"{cfg['name']}: dtype {cfg['dtype']!r}")
    # the configurations state float32: no TF32 in the program's products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if cuda:
        from repro_torch.kernels import _build

        _build.library()  # builds into build/repro_torch once a checkout
    work = traffic.build(cell.mix)
    params = weights.make(cfg, seed, device)
    prog = Program(cfg, work, params, device, trace)
    warm = prog.one_pass()  # every admission width, kernel, cached fetch
    sync(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    t_chk = time.perf_counter()
    steps = sampled_steps(cfg, prog.engine, warm, seed)
    log(f"check buffers {time.perf_counter() - t_chk:.3f} s")

    if cuda:
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
    prog.phases.marks.clear()
    if prog.timers:
        prog.timers.admits.clear()
        prog.timers.rounds.clear()
        prog.timers.k8_lengths.clear()
    win = None
    if trace:
        win = devtrace.Window(lambda: prog.window(seconds))
        passes, window_s = win.result
    else:
        passes, window_s = prog.window(seconds)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    steps.close()

    queries = [q for ps in passes for q in ps]
    run = {"config": cfg, "mix": cell.mix, "setup_s": setup_s,
           "window_s": window_s, "passes": len(passes),
           "queries": len(queries),
           "optimize_s": [q["optimize_s"] for q in queries],
           "pipeline_syncs": [q["pipeline_syncs"] for q in queries],
           "backend_calls": sum(q["backend_calls"] for q in queries),
           "ttv_s": list(prog.engine.stats.ttv_s),
           "requests": [(p, ids) for q in queries
                        for p, ids in q["requests"]],
           "trace": None}
    breakdown = None
    if trace:
        tm = prog.timers
        admit_ms, round_ms = tm.admit_ms(), tm.round_ms()
        events_s = (sum(admit_ms) + sum(round_ms)) / 1e3
        if cuda and win.busy_s < 0.5 * events_s:
            raise RuntimeError(f"the profiler kept {win.busy_s:.3f} s of "
                               f"device time against {events_s:.3f} s of "
                               f"CUDA events around admissions and rounds")
        k7, k8 = _k7_k8(_build.SHAPE_LAUNCHES) if cuda else ({}, {})
        by_name = win.by_name()
        run["trace"] = {"window_s": win.window_s, "busy_s": win.busy_s,
                        "by_name": by_name, "admit_ms": admit_ms,
                        "round_ms": round_ms, "k7": k7, "k8": k8,
                        "k8_lengths": tm.k8_lengths}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(win.idle_by_phase(prog.phases.marks).items(),
                      key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [list(kv) for kv in top],
                     "idle_gaps": [list(kv) for kv in idle]}
    del prog, win
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return Session(work, params, warm, passes, run, breakdown, peak, steps)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device) -> dict:
    """One run of ``cell``: its result line, the ``checks`` last."""
    cfg = cell.config
    cuda = device.type == "cuda"
    ses = session(cell, seed, seconds, trace, device)
    run = ses.run
    t_ref = time.perf_counter()
    checks = check.judge(manifest.reference(cfg["family"]), cfg, ses.work,
                         ses.passes, ses.warm, ses.params, seed, ses.steps)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.metric_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": ses.peak}
    if trace:
        dev.update(busy_s=run["trace"]["busy_s"],
                   window_s=run["trace"]["window_s"])
    result = {"correct": all(check.holds(v, op, lim)
                             for _, v, op, lim in checks),
              "attempted": run["queries"],
              "failed": dict((k, v) for k, v, _, _ in checks)["rows_wrong"],
              "metrics": metrics, "device": dev}
    if ses.breakdown is not None:
        result["breakdown"] = ses.breakdown
    result["checks"] = {k: {"value": v, "limit": lim, "op": op}
                        for k, v, op, lim in checks}
    return result


def emit(result: dict, out=None) -> None:
    """Each number compared beside its limit as the last lines on
    stderr, then the result as the last line on ``out`` (stdout)."""
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']} {c['op']} {c['limit']}")
    print(json.dumps(result), file=out or sys.stdout, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    man = manifest.manifest()
    bad = manifest.check_names(man)
    if bad:
        log("BENCHMARK.json breaks its naming rules:", *bad)
        return 2
    cell = manifest.cell(man, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count()} visible")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_loaded()
    if found:
        log(f"the run loaded {found}: the benchmark drives the port alone")
        return 3
    emit(result)
    return 0
