"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H d_ff=3072
vocab=51865; conv frontend is a STUB (input_specs provides precomputed
frame embeddings, 1500 x 768). [arXiv:2212.04356; unverified]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        encoder_layers=12, encoder_seq=1500,
        gated_mlp=False,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        encoder_layers=2, encoder_seq=32,
        gated_mlp=False,
    )
