"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, non-gated GELU MLP, RoPE. [arXiv:2402.19173; hf]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
        d_ff=12288, vocab_size=49152,
        gated_mlp=False,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        gated_mlp=False,
    )
