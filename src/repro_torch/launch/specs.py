"""(architecture × input-shape) cell definitions and abstract inputs, the
reference's ``src/repro/launch/specs.py`` on PyTorch.

Shapes:
    train_4k     seq 4 096   global_batch 256   -> train step
    prefill_32k  seq 32 768  global_batch 32    -> prefill
    decode_32k   seq 32 768  global_batch 128   -> decode step (1 new token)
    long_500k    seq 524 288 global_batch 1     -> decode step; only for
                 the sub-quadratic architectures (mamba2, hymba)

``input_specs`` returns ``device="meta"`` tensors (shapes and dtypes, no
memory) where the reference returns ``ShapeDtypeStruct``s: bfloat16 by
default, int32 tokens and positions, the cache from
``models.lm.abstract_cache``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs import get_config
from ..models import abstract_cache
from ..models.config import ModelConfig
from ..sharding.policy import PartitionSpec, ShardingPolicy


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class RunProfile:
    """Per-architecture launch knobs of the train cells."""

    microbatches: int = 1
    remat: Optional[str] = "full"
    moment_dtype: str = "fp32"
    accum_dtype: str = "float32"
    param_dtype: str = "bfloat16"


PROFILES: dict[str, RunProfile] = {
    "olmoe-1b-7b": RunProfile(microbatches=2, moment_dtype="fp32"),
    "deepseek-v3-671b": RunProfile(microbatches=16, moment_dtype="int8",
                                   accum_dtype="bfloat16"),
    "internlm2-20b": RunProfile(microbatches=4, moment_dtype="int8"),
    "qwen2.5-32b": RunProfile(microbatches=4, moment_dtype="int8"),
    "stablelm-3b": RunProfile(microbatches=2),
    "starcoder2-3b": RunProfile(microbatches=2),
    "hymba-1.5b": RunProfile(microbatches=2),
    "mamba2-370m": RunProfile(microbatches=1),
    "whisper-small": RunProfile(microbatches=1),
    "paligemma-3b": RunProfile(microbatches=2),
}

ARCH_IDS = list(PROFILES)


def shape_applicable(cfg: ModelConfig, shape: Shape) -> bool:
    if shape.name == "long_500k":
        return cfg.sub_quadratic  # skip pure full-attention archs
    return True


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if shape_applicable(cfg, shape):
                out.append((arch, sname))
    return out


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, B: int, S: int, dtype=torch.bfloat16):
    """Training / prefill batch. For the VLM the text is shortened so
    that the whole sequence (image prefix + text) is S."""
    batch = {}
    s_text = S
    if cfg.family == "vlm":
        s_text = S - cfg.num_image_tokens
        batch["patches"] = _meta((B, cfg.num_image_tokens, cfg.d_model),
                                 dtype)
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), dtype)
    batch["tokens"] = _meta((B, s_text), torch.int32)
    return batch


def input_specs(arch: str, shape_name: str,
                cfg: Optional[ModelConfig] = None,
                dtype=torch.bfloat16) -> dict:
    """Abstract inputs of the cell. train/prefill: {'batch': ...};
    decode: {'cache': ..., 'tokens': ..., 'pos': ...}."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq
    if shape.kind in ("train", "prefill"):
        return {"batch": _batch_specs(cfg, B, S, dtype)}
    return {
        "cache": abstract_cache(cfg, B, S, dtype),
        "tokens": _meta((B,), torch.int32),
        "pos": _meta((B,), torch.int32),
    }


def batch_partition_specs(cfg: ModelConfig, policy: ShardingPolicy, B: int):
    """PartitionSpecs of the batch leaves; the batch axis is sharded only
    when the global batch divides the data-parallel size."""
    dp = policy.dp_size()
    baxis = None
    if dp > 1 and B % dp == 0:
        baxis = (policy.dp_axes if len(policy.dp_axes) > 1
                 else policy.dp_axes[0])
    specs = {"tokens": PartitionSpec(baxis, None)}
    if cfg.family == "vlm":
        specs["patches"] = PartitionSpec(baxis, None, None)
    if cfg.family == "encdec":
        specs["frames"] = PartitionSpec(baxis, None, None)
    return specs
