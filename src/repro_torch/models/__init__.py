"""The LM of the serving and training tiers: config, parameters,
layers, forward/forward_loss/prefill/decode (the dense, MoE, SSM and
hybrid subset of the reference's ``repro.models``, with MLA and
multi-token prediction)."""
from .config import ModelConfig
from .lm import (
    build_cache_spec,
    decode_step,
    forward,
    forward_loss,
    init_cache,
    prefill,
)
from .layers import moe_block, moe_reference
from .params import (
    build_params,
    check_supported,
    count_params,
    init_params,
    params_from_numpy,
)

__all__ = [
    "ModelConfig",
    "build_cache_spec", "decode_step", "forward", "forward_loss",
    "init_cache", "prefill",
    "moe_block", "moe_reference",
    "build_params", "check_supported", "count_params", "init_params",
    "params_from_numpy",
]
