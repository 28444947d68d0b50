"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216; SigLIP frontend is a STUB (input_specs provides precomputed
patch embeddings, 256 tokens); prefix-LM mask over the image prefix.
[arXiv:2407.07726; hf]"""
from ..models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256,
        d_ff=16384, vocab_size=257216,
        num_image_tokens=256,
        gated_mlp=True,
    )


def tiny() -> ModelConfig:
    return ModelConfig(
        name="paligemma-tiny", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256,
        num_image_tokens=8,
        gated_mlp=True,
    )
