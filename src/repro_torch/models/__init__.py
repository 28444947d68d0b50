"""The LM of the serving and training tiers: config, parameters,
layers, forward/forward_loss/encode/prefill/decode (the reference's
``repro.models``: the dense, MoE, SSM and hybrid families, MLA and
multi-token prediction, the encoder-decoder and the VLM, on one device;
the dense and MoE families also over a model-parallel mesh)."""
from .config import ModelConfig
from .lm import (
    abstract_cache,
    build_cache_spec,
    cache_specs,
    decode_step,
    encode,
    forward,
    forward_loss,
    init_cache,
    prefill,
)
from .layers import moe_block, moe_reference
from .params import (
    abstract_params,
    build_params,
    check_supported,
    check_tokens_only,
    count_params,
    init_params,
    param_axes,
    param_shardings,
    param_specs,
    params_from_numpy,
    shard_params,
)

__all__ = [
    "ModelConfig",
    "abstract_cache", "build_cache_spec", "cache_specs", "decode_step",
    "encode", "forward", "forward_loss", "init_cache", "prefill",
    "moe_block", "moe_reference",
    "abstract_params", "build_params", "check_supported",
    "check_tokens_only", "count_params", "init_params", "param_axes",
    "param_shardings", "param_specs", "params_from_numpy", "shard_params",
]
