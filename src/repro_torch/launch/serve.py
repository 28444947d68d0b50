"""Serving entry point: stand up an LM (dense, MoE, SSM or hybrid)
behind the serving tier and answer prompts, on the card unless ``--device cpu``.

    # full-width olmoe-1b-7b (the default), random weights (seed 0), on
    # the card
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --prompts "is product 3 electronics?"

    # the dense, SSM and hybrid families: starcoder2-3b, mamba2-370m,
    # hymba-1.5b, ...
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch hymba-1.5b --prompts "is product 3 electronics?"

    # tiny random-weight smoke on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
        --tiny --device cpu --prompts "hello" "world"

Dense, MoE, SSM and hybrid configurations are served. There are no
trained weights to restore yet (``--ckpt`` waits for the training
slice) and no model-parallel mesh (``--dp``/``--tp`` wait for it; the
partitioned data tier's mesh shards tables, not a model).
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config, get_tiny
from ..engine.table import resolve_device
from ..models import init_params
from ..serving.engine import ServingEngine
from ..training.data import HashTokenizer


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a dense, MoE, SSM or hybrid LM with random "
                    "weights (seed 0). "
                    "Not ported: --ckpt (training slice), --dp/--tp "
                    "(the model-parallel mesh).")
    ap.add_argument("--arch", default="olmoe-1b-7b",
                    help="a dense, MoE, SSM or hybrid configuration "
                         "(default olmoe-1b-7b)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--prompts", nargs="+", required=True)
    args = ap.parse_args(argv)

    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    print(f"[serve] random-weight {cfg.name} on {dev} (smoke mode)")
    engine = ServingEngine(cfg, params,
                           tokenizer=HashTokenizer(cfg.vocab_size),
                           batch_size=args.batch, max_seq=args.max_seq,
                           device=dev)
    answers = engine.answer(args.prompts)
    for p, a in zip(args.prompts, answers):
        print(f"  {p!r} -> {a}")
    s = engine.stats
    print(f"[serve] {s.prompts} prompts, {s.batches} batches, "
          f"{s.decode_steps} decode steps, {s.wall_s:.2f}s")


if __name__ == "__main__":
    main()
