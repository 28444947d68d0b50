"""Training entry point on one device or over a (dp, tp) model mesh, on
the card unless ``--device cpu``.

    # a tiny configuration on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --tiny --device cpu --steps 200 --batch 8 --seq 64 \\
        --ckpt-dir /tmp/ckpt

    # MLA and the multi-token-prediction loss (deepseek-v3-671b's tiny
    # config) on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v3-671b --tiny --device cpu --steps 20

    # stablelm-3b (the default) at full width on one card
    PYTHONPATH=src python -m repro_torch.launch.train --steps 10 \\
        --seq 128 --microbatches 2

    # over a (2, 2) mesh: four positions on the CPU, or four distinct
    # cards without --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
        --tiny --device cpu --dp 2 --tp 2 --steps 20 --ckpt-dir /tmp/ck

Fault tolerance: checkpoints are atomic and asynchronous
(``training/checkpoint.py``); ``--simulate-failure K`` exits with code
42 after step K; running the same command again resumes from the latest
checkpoint and replays the exact batch schedule (step-addressable data),
so the final ``loss=`` line equals an uninterrupted run's. Weights come
from ``init_params`` with a generator seeded 0 on the device, the data
from ``TokenStream(seed=7)``, which holds tokens only, so the
encoder-decoder and VLM configurations, which need frames or patches
beside them, are refused (as the reference's ``TokenStream`` cannot
feed them; ``build_train_step`` trains them from a batch that carries
them).

``--dp``/``--tp`` (dp·tp > 1) train over ``make_mesh(dp, tp)`` under
``ShardingPolicy.for_mesh``, as the reference's entry point builds it
(every token-fed family: dense, MoE, SSM, hybrid and MLA,
deepseek-v3-671b's MTP loss included; hymba-1.5b's 25 query heads split
13 + 12 at ``--tp 2``, 7 + 7 + 7 + 4 at ``--tp 4``; ``--tiny`` on the
CPU): one distinct card a position on the card (``make_mesh`` raises with fewer), every
position on the CPU with ``--device cpu``. The weights are made on the
mesh's first device and laid out by ``shard_params``. Checkpoints hold
global arrays, so a run resumes under another ``--dp``/``--tp`` (or
none): ``CheckpointManager.restore(policy=, cfg=)`` lays the tree out
over the new mesh (elastic restore).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..configs import get_config, get_tiny
from ..engine.table import resolve_device
from ..models import check_tokens_only, init_params
from ..models.params import shard_params
from ..sharding import model as sm
from ..sharding.policy import ShardingPolicy
from ..training.checkpoint import CheckpointManager
from ..training.data import TokenStream
from ..training.optimizer import MOMENT_DTYPES, AdamWConfig, init_state
from ..training.train_step import build_train_step
from .mesh import make_mesh


def main(argv=None):
    """Parse ``argv``, train (resuming from ``--ckpt-dir`` when it holds
    a checkpoint) and return the last step's loss."""
    ap = argparse.ArgumentParser(
        description="Train an LM (dense, MoE, SSM, hybrid or MLA with "
                    "MTP) on one device or over a (dp, tp) model mesh.")
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--tiny", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moment-dtype", default="fp32", choices=MOMENT_DTYPES)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure", type=int, default=None,
                    help="hard-abort at this step (fault-tolerance test)")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    check_tokens_only(cfg, "launch/train (TokenStream)")
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
        print(f"[train] {cfg.name} over {mesh}")
    opt_cfg = AdamWConfig(lr=args.lr, moment_dtype=args.moment_dtype)
    # refuses a family the mesh does not train before any weight exists
    step_fn = build_train_step(cfg, opt_cfg,
                               num_microbatches=args.microbatches,
                               remat=None, policy=policy)
    data = TokenStream(vocab_size=cfg.vocab_size, batch_size=args.batch,
                       seq_len=args.seq, seed=7)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        if policy.active:
            tree, manifest = mgr.restore(policy=policy, cfg=cfg)
        else:
            tree, manifest = mgr.restore(device=dev)
        params, opt_state = tree["params"], tree["opt"]
        start_step = int(manifest["step"])
        print(f"[train] resumed from step {start_step}")
    else:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        params = shard_params(cfg, params, policy, consume=True)
        opt_state = init_state(params, opt_cfg)

    t0 = time.perf_counter()
    metrics = None
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data[step].items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == start_step:
            dt = time.perf_counter() - t0
            print(f"[train] step {step+1:5d} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt/(step-start_step+1):.3f}s/step)", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1,
                           {"params": params, "opt": opt_state},
                           extra={"arch": cfg.name})
        if args.simulate_failure is not None \
                and step + 1 == args.simulate_failure:
            print(f"[train] SIMULATED FAILURE at step {step+1}", flush=True)
            if mgr is not None:
                mgr.wait()
            sys.exit(42)
    if mgr is not None:
        mgr.save(args.steps, {"params": params, "opt": opt_state},
                 extra={"arch": cfg.name})
        mgr.wait()
    if metrics is None:
        raise SystemExit(f"[train] nothing to run: already at step "
                         f"{start_step} of {args.steps}")
    print(f"[train] done: {args.steps} steps, "
          f"final loss={float(metrics['loss']):.4f}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
