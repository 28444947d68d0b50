"""The LM of the serving and training tiers: config, parameters,
layers, forward/forward_loss/encode/prefill/decode (the reference's
``repro.models`` on one device: the dense, MoE, SSM and hybrid
families, MLA and multi-token prediction, the encoder-decoder and the
VLM)."""
from .config import ModelConfig
from .lm import (
    build_cache_spec,
    decode_step,
    encode,
    forward,
    forward_loss,
    init_cache,
    prefill,
)
from .layers import moe_block, moe_reference
from .params import (
    build_params,
    check_supported,
    check_tokens_only,
    count_params,
    init_params,
    params_from_numpy,
)

__all__ = [
    "ModelConfig",
    "build_cache_spec", "decode_step", "encode", "forward", "forward_loss",
    "init_cache", "prefill",
    "moe_block", "moe_reference",
    "build_params", "check_supported", "check_tokens_only", "count_params",
    "init_params",
    "params_from_numpy",
]
