"""Training on one device or over a model-parallel mesh: the tokenizer
and step-addressable data streams, AdamW with fp32/bf16/int8 moments
(their shapes and specs by ``abstract_state``/``state_specs``), the
microbatched train step with remat, atomic checkpoints that restore
under another mesh, and the in-repo semantic backend's configuration
(the reference's ``repro.training``)."""
from .backend import backend_config
from .checkpoint import CheckpointManager
from .data import HashTokenizer, PromptStream, TokenStream
from .optimizer import (
    AdamWConfig,
    abstract_state,
    apply_updates,
    dequantize_i8,
    init_state,
    quantize_i8,
    state_specs,
)
from .train_step import build_train_step

__all__ = [
    "backend_config", "CheckpointManager", "HashTokenizer", "PromptStream",
    "TokenStream", "AdamWConfig", "abstract_state", "apply_updates",
    "dequantize_i8", "init_state", "quantize_i8", "state_specs",
    "build_train_step",
]
