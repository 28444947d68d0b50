"""Train a small LM (~13M params, olmoe-family MoE) to BE the semantic
backend, on PyTorch: it learns to answer the benchmark's YES/NO
predicates from labelled prompts, is scored on held-out batches and
saved as a checkpoint (the port's counterpart of
``examples/train_backend.py``).

    # on the card
    PYTHONPATH=src python examples/torch_train_backend.py --steps 300
    # on the CPU (about 0.5 s a step)
    PYTHONPATH=src python examples/torch_train_backend.py --device cpu

``examples/torch_serve_semantic_queries.py`` serves the checkpoint
inside hybrid query plans; ``python -m repro_torch.launch.serve --ckpt
artifacts/torch_backend_ckpt --prompts ...`` answers single prompts.
"""
import argparse

from repro_torch.engine.table import resolve_device
from repro_torch.training import CheckpointManager
from repro_torch.training.backend import train_backend

CKPT_DIR = "artifacts/torch_backend_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    params, info = train_backend(args.steps, args.batch, args.seq,
                                 device=resolve_device(args.device))
    mgr = CheckpointManager(args.ckpt_dir)
    mgr.save(args.steps, {"params": params},
             extra={"arch": info["arch"], "accuracy": info["accuracy"]})
    print(f"[backend] checkpoint saved to {args.ckpt_dir}")
    return info["accuracy"]


if __name__ == "__main__":
    main()
