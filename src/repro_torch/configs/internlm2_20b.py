"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. [arXiv:2403.17297; hf]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=92544,
        gated_mlp=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="internlm2-tiny", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        gated_mlp=True,
    )
