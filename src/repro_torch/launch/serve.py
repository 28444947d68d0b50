"""Serving entry point: stand up an LM (dense, MoE, SSM, hybrid or MLA)
behind the serving tier and answer prompts, on the card unless
``--device cpu``.

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

    # MLA with a shared expert (deepseek-v3-671b's tiny config; its full
    # width, 704 B parameters, fits no card), also over a mesh
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --tiny --prompts "hello" "world"
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --tiny --device cpu --dp 2 --tp 2 \\
        --prompts "hello" "world"

    # the trained 13M backend (examples/torch_train_backend.py)
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --ckpt artifacts/torch_backend_ckpt \\
        --prompts "is product 3 electronics?"

    # tensor- and expert-parallel over a (dp, tp) mesh of distinct cards
    # (--device cpu repeats the CPU); the SSM and the hybrid over the
    # same meshes (hymba-1.5b's 25 query heads 13 + 12 at --tp 2)
    PYTHONPATH=src python -m repro_torch.launch.serve --dp 2 --tp 2 \\
        --prompts "is product 3 electronics?"
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --tp 2 --prompts "is product 3 electronics?"

Dense, MoE, SSM, hybrid and MLA configurations are served, with random
weights or, with ``--ckpt``, the trained semantic backend
(``training/backend.py::backend_config``) restored from its checkpoint.
The encoder-decoder and VLM configurations (whisper-small,
paligemma-3b) are refused: the engine feeds tokens only, as the
reference's does, and they need frames or patches beside them (run
them through ``repro_torch.models``' ``prefill`` / ``decode_step``).
``--dp``/``--tp`` serve over a model mesh (``launch/mesh.py``) under
``ShardingPolicy.for_mesh`` when it has more than one position, as the
reference's entry point builds it (every token-fed family; hymba-1.5b's
25 query heads over 5 KV heads split in ceil chunks, a rank's heads
attending in runs inside one KV head's group or over whole groups): on
the card the mesh
takes dp·tp distinct cards and refuses with fewer, with ``--device
cpu`` it repeats the CPU.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config, get_tiny
from ..engine.table import resolve_device
from ..models import check_tokens_only, init_params
from ..models.params import shard_params
from ..serving.engine import ServingEngine
from ..sharding import model as sm
from ..sharding.policy import ShardingPolicy
from ..training.backend import backend_config
from ..training.checkpoint import CheckpointManager
from ..training.data import HashTokenizer
from .mesh import make_mesh


def main(argv=None):
    """Parse ``argv``, stand up the engine and print its answers."""
    ap = argparse.ArgumentParser(
        description="Serve a dense, MoE, SSM, hybrid or MLA LM with random "
                    "weights (seed 0), or the trained backend (--ckpt), "
                    "on one device or over a (dp, tp) model mesh.")
    ap.add_argument("--arch", default="olmoe-1b-7b",
                    help="a dense, MoE, SSM, hybrid or MLA configuration "
                         "(default olmoe-1b-7b)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir of the trained backend (e.g. "
                         "artifacts/torch_backend_ckpt)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--prompts", nargs="+", required=True)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n = args.dp * args.tp
    # on the card one distinct card a position (make_mesh raises with
    # fewer); on the CPU the positions share it
    mesh = make_mesh(args.dp, args.tp, devices=[dev] * n
                     if dev.type == "cpu" else None) if n > 1 else None
    policy = (ShardingPolicy.for_mesh(mesh) if mesh is not None
              else ShardingPolicy.single())
    if mesh is not None:
        dev = sm.home_device(policy)
    if args.ckpt:
        cfg = backend_config()
        tree, manifest = CheckpointManager(args.ckpt).restore(device=dev)
        params = tree["params"]
        print(f"[serve] restored {cfg.name} @ step {manifest['step']} "
              f"on {dev}")
    else:
        cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
        check_tokens_only(cfg, "launch/serve")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, device=dev)
        print(f"[serve] random-weight {cfg.name} on {dev} (smoke mode)")
    if policy.active:
        params = shard_params(cfg, params, policy, consume=True)
        print(f"[serve] sharded over {mesh}")
    engine = ServingEngine(cfg, params,
                           tokenizer=HashTokenizer(cfg.vocab_size),
                           batch_size=args.batch, max_seq=args.max_seq,
                           device=dev, policy=policy)
    answers = engine.answer(args.prompts)
    for p, a in zip(args.prompts, answers):
        print(f"  {p!r} -> {a}")
    s = engine.stats
    print(f"[serve] {s.prompts} prompts, {s.batches} batches, "
          f"{s.decode_steps} decode steps, {s.wall_s:.2f}s")


if __name__ == "__main__":
    main()
