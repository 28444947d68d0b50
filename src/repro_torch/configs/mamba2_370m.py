"""mamba2-370m [ssm]: 48L d_model=1024, attention-free SSD,
ssm_state=128, vocab=50280. [arXiv:2405.21060; unverified]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="mamba2-tiny", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    )
