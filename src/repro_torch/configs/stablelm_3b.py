"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32) d_ff=6912
vocab=50304. [hf:stabilityai/stablelm; unverified]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=6912, vocab_size=50304,
        gated_mlp=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="stablelm-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        gated_mlp=True,
    )
