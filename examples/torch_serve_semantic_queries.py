"""End-to-end example on PyTorch: hybrid queries whose semantic
operators are answered by the backend this repo trains
(``examples/torch_train_backend.py``), served with batched requests —
no oracle in the execution path (the port's counterpart of
``examples/serve_semantic_queries.py``).

    PYTHONPATH=src python examples/torch_serve_semantic_queries.py
    PYTHONPATH=src python examples/torch_serve_semantic_queries.py --device cpu

Pipeline: train (or reuse) the 13M-parameter backend -> wrap it in
``ServingEngine`` (continuous slot scheduler) -> ``ModelBackend`` parses
YES/NO -> PLOP optimizes placement (``none`` and ``cost``) -> the
executor sends only distinct uncached prompts to the model. Reports F1
against the noise-free oracle, LLM calls and cache hits.
"""
import argparse
import time

from repro_torch.core import Q, col, optimize
from repro_torch.data import make_ecommerce
from repro_torch.data.schemas import (
    ECOM_REVIEW_POSITIVE,
    PRODUCT_IS_ELECTRONICS,
)
from repro_torch.engine import Executor, result_f1
from repro_torch.engine.table import resolve_device
from repro_torch.semantic import ModelBackend, OracleBackend, SemanticRunner
from repro_torch.serving import ServingEngine
from repro_torch.training import CheckpointManager, HashTokenizer
from repro_torch.training.backend import backend_config

OUT_COLS = ["products.title", "previews.review_id"]
CKPT_DIR = "artifacts/torch_backend_ckpt"


def backend_plan():
    """products ⋈ previews, rating >= 4, two semantic filters."""
    return (Q.scan("products")
            .join(Q.scan("previews"), "products.product_id",
                  "previews.product_id")
            .where(col("previews.rating") >= 4)
            .sem_filter(PRODUCT_IS_ELECTRONICS)
            .sem_filter(ECOM_REVIEW_POSITIVE)
            .select(*OUT_COLS)
            .build())


def serve_plan(engine, device, strategies=("none", "cost")) -> dict:
    """The plan under each strategy through ``ModelBackend.from_engine``
    on ``engine``, over a fresh ``make_ecommerce(seed=4)`` each: rows,
    F1 against the oracle's rows, LLM calls, cache hits, the backend's
    raw answers and parsed verdicts in the order it gave them, and the
    wall time, by strategy."""
    db = make_ecommerce(seed=4, device=device)
    plan = backend_plan()
    oracle = SemanticRunner(OracleBackend(truths=db.truths))
    ref_table, _ = Executor(db, oracle).execute(plan)
    ref = db.materialize(ref_table, OUT_COLS)
    out = {}
    for strategy in strategies:
        db = make_ecommerce(seed=4, device=device)
        opt = optimize(plan, db.catalog(), strategy=strategy)
        backend = ModelBackend.from_engine(engine)
        answers, verdicts = [], []
        parse = backend._parse

        def parse_recorded(r, ctx, _parse=parse, _a=answers, _v=verdicts):
            _a.append(r)
            _v.append(_parse(r, ctx))
            return _v[-1]

        backend._parse = parse_recorded  # on the instance: records only
        t0 = time.perf_counter()
        table, stats = Executor(db, SemanticRunner(backend)).execute(
            opt.plan)
        recs = db.materialize(table, OUT_COLS)
        out[strategy] = {"rows": recs, "oracle_rows": len(ref),
                         "f1": result_f1(ref, recs),
                         "llm_calls": stats.llm_calls,
                         "cache_hits": stats.cache_hits,
                         "answers": answers, "verdicts": verdicts,
                         "wall_s": time.perf_counter() - t0}
    return out


def get_backend_params(device):
    mgr = CheckpointManager(CKPT_DIR)
    if mgr.latest_step() is None:
        print("[serve] no backend checkpoint — training one (300 steps)")
        from torch_train_backend import main as train_backend_main

        train_backend_main(["--steps", "300", "--device", str(device)])
    tree, manifest = mgr.restore(device=device)
    print(f"[serve] backend checkpoint: step={manifest['step']} "
          f"trained-accuracy={manifest.get('accuracy'):.3f}")
    return tree["params"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = backend_config()
    engine = ServingEngine(cfg, get_backend_params(device),
                           tokenizer=HashTokenizer(cfg.vocab_size),
                           batch_size=32, max_seq=48, max_new_tokens=2,
                           device=device)
    for strategy, r in serve_plan(engine, device).items():
        yes = sum(v is True for v in r["verdicts"])
        print(f"\n=== strategy={strategy} (real model serving) ===")
        print(f"rows={len(r['rows'])} (oracle says {r['oracle_rows']})  "
              f"F1 vs oracle={r['f1']:.3f}")
        print(f"distinct model calls={r['llm_calls']}  "
              f"cache hits={r['cache_hits']}  YES verdicts={yes}/"
              f"{len(r['verdicts'])}  wall={r['wall_s']:.1f}s")
        print(f"serving: {engine.stats.batches} batches, "
              f"{engine.stats.decode_steps} decode rounds, "
              f"{engine.stats.prefill_tokens} prefill tokens, "
              f"occupancy={engine.stats.occupancy:.2f}")


if __name__ == "__main__":
    main()
