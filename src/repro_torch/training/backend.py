"""The semantic backend the repo trains for itself: an olmoe-tiny
derivative of ~13M parameters that learns the benchmark's YES/NO
predicates from labelled prompts (``PromptStream`` over
``make_ecommerce(seed=4)``) and is then served inside hybrid plans
(``examples/torch_serve_semantic_queries.py``, ``launch/serve.py
--ckpt``). The reference keeps this configuration and loop in
``examples/train_backend.py``; a package module may not import from
``examples/``, so the port keeps them here and its example
(``examples/torch_train_backend.py``) calls them."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..configs import get_tiny
from ..models import forward, init_params
from ..models.config import ModelConfig
from .data import HashTokenizer, PromptStream
from .optimizer import AdamWConfig, init_state
from .train_step import build_train_step

HELD_OUT = 10_000  # first step index of the held-out batches
EVAL_BATCHES = 5


def backend_config() -> ModelConfig:
    """backend-13m: a slightly larger olmoe "tiny", enough capacity to
    learn the predicates."""
    return get_tiny("olmoe-1b-7b").replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, moe_d_ff=256, vocab_size=4096, name="backend-13m")


def prompt_stream(cfg: ModelConfig, batch: int = 32, seq: int = 48
                  ) -> PromptStream:
    """The labelled prompts of ``make_ecommerce(seed=4)``, seed 0 (the
    prompts come from the host payloads: the tables stay on the CPU)."""
    from ..data import make_ecommerce

    return PromptStream(db=make_ecommerce(seed=4, device="cpu"),
                        tokenizer=HashTokenizer(cfg.vocab_size),
                        batch_size=batch, seq_len=seq, seed=0)


def train_backend(steps: int = 300, batch: int = 32, seq: int = 48,
                  device="cuda", log=print) -> tuple[dict, dict]:
    """Train the backend from ``init_params`` (a generator seeded 0 on
    ``device``) with AdamW(lr 1e-3, weight decay 0.01) and no remat,
    one ``stream[step]`` batch a step, then score it on held-out
    batches. Returns (params, info): the loss every 50 steps, the
    held-out accuracy and majority-class share, the training seconds."""
    cfg = backend_config()
    stream = prompt_stream(cfg, batch, seq)
    log(f"[backend] {len(stream)} labelled prompts, model={cfg.name}")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    state = init_state(params, opt_cfg)
    step_fn = build_train_step(cfg, opt_cfg, remat=None)
    losses = {}
    t0 = time.perf_counter()
    for step in range(steps):
        toks = torch.from_numpy(stream[step]["tokens"]).to(device)
        params, state, m = step_fn(params, state, {"tokens": toks})
        if (step + 1) % 50 == 0 or step + 1 == steps:
            losses[step + 1] = float(m["loss"])
            log(f"[backend] step {step+1} loss={losses[step + 1]:.4f} "
                f"({(time.perf_counter()-t0)/(step+1):.3f}s/step)")
    seconds = time.perf_counter() - t0
    acc, majority = evaluate_backend(cfg, params, stream)
    log(f"[backend] YES/NO accuracy on held-out prompts: {acc:.3f} "
        f"(majority class {majority:.3f})")
    return params, {"arch": cfg.name, "steps": steps, "losses": losses,
                    "accuracy": acc, "majority_share": majority,
                    "train_s": seconds, "prompts": len(stream)}


@torch.no_grad()
def evaluate_backend(cfg: ModelConfig, params: dict, stream: PromptStream,
                     batches: int = EVAL_BATCHES) -> tuple[float, float]:
    """(accuracy, majority-class share) of the argmax at each row's SEP
    position against its label, over ``batches`` held-out batches
    (step indices from ``HELD_OUT``, which training never reaches)."""
    sep = stream.tokenizer.SEP
    dev = params["embed"].device
    preds, labels = [], []
    for s in range(batches):
        batch = stream[HELD_OUT + s]
        toks = batch["tokens"]
        logits, _ = forward(cfg, params,
                            {"tokens": torch.from_numpy(toks).to(dev)})
        pos = np.argmax(toks == sep, axis=1)
        rows = torch.arange(len(toks), device=dev)
        preds.append(torch.argmax(logits[rows, torch.from_numpy(pos)
                                         .to(dev)], dim=-1).cpu().numpy())
        labels.append(batch["labels"])
    pred, lab = np.concatenate(preds), np.concatenate(labels)
    majority = max(np.mean(lab == v) for v in np.unique(lab))
    return float(np.mean(pred == lab)), float(majority)
