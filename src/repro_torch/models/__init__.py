"""The dense LM of the serving tier: config, parameters, layers,
forward/prefill/decode (the dense subset of the reference's
``repro.models``)."""
from .config import ModelConfig
from .lm import (
    build_cache_spec,
    decode_step,
    forward,
    init_cache,
    prefill,
)
from .params import (
    build_params,
    check_supported,
    count_params,
    init_params,
    params_from_numpy,
)

__all__ = [
    "ModelConfig",
    "build_cache_spec", "decode_step", "forward", "init_cache", "prefill",
    "build_params", "check_supported", "count_params", "init_params",
    "params_from_numpy",
]
