"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias. [hf:Qwen/Qwen2.5; hf]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=27648, vocab_size=152064,
        qkv_bias=True, gated_mlp=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        qkv_bias=True, gated_mlp=True,
    )
