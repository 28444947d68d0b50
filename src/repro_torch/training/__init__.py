"""Training on one device: the tokenizer and step-addressable data
streams, AdamW with fp32/bf16/int8 moments, the microbatched train step
with remat, atomic checkpoints, and the in-repo semantic backend's
configuration (the reference's ``repro.training``)."""
from .backend import backend_config
from .checkpoint import CheckpointManager
from .data import HashTokenizer, PromptStream, TokenStream
from .optimizer import (
    AdamWConfig,
    apply_updates,
    dequantize_i8,
    init_state,
    quantize_i8,
)
from .train_step import build_train_step

__all__ = [
    "backend_config", "CheckpointManager", "HashTokenizer", "PromptStream",
    "TokenStream", "AdamWConfig", "apply_updates", "dequantize_i8",
    "init_state", "quantize_i8", "build_train_step",
]
