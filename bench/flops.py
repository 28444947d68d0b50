"""Operations and bytes, computed from the published shapes.

``model_flops`` counts what the served requests need: every real prompt
token through every layer's products and its attention over its own
context, and per served token the output head, plus, for each served
token after the first, one more step through the layers at its
context. Products count 2 x (weights the token touches): a mixture of
experts touches its router and ``num_experts_per_tok`` experts.
``k7_work`` and ``k8_work`` are the attention kernels' operations and
bytes at a launch's own shape, each input read once and each output
written once, float32."""
from __future__ import annotations

F32 = 4


def layer_weights(cfg: dict) -> int:
    """Weights one token multiplies in one layer (norms excluded)."""
    D, H, K = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["num_key_value_heads"])
    d, F = cfg["head_dim"], cfg["intermediate_size"]
    mats = 3 if cfg["hidden_act"] == "silu" else 2
    attn = D * H * d + 2 * D * K * d + H * d * D
    if cfg["family"] == "moe":
        ffn = D * cfg["num_experts"] + \
            cfg["num_experts_per_tok"] * mats * D * F
    else:
        ffn = mats * D * F
    return attn + ffn


def attention_flops(cfg: dict, context: int) -> int:
    """QK and PV of one query over ``context`` keys, every layer."""
    return 4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * \
        cfg["head_dim"] * context


def model_flops(cfg: dict, requests: list) -> int:
    """``requests``: (prompt tokens n, served tokens m) pairs."""
    body = 2 * cfg["num_hidden_layers"] * layer_weights(cfg)
    head = 2 * cfg["hidden_size"] * cfg["vocab_size"]
    total = 0
    for n, m in requests:
        total += n * body + sum(attention_flops(cfg, i + 1)
                                for i in range(n))
        total += m * head
        total += sum(body + attention_flops(cfg, n + j + 1)
                     for j in range(max(m - 1, 0)))
    return total


def k7_work(shape: tuple, variant: str) -> tuple[int, int]:
    """(operations, bytes) of one K7 launch at (B, H, K, Sq, Sk, d)."""
    B, H, K, Sq, Sk, d = shape
    if variant.startswith("causal"):
        off = Sk - Sq  # query i sees keys [0, i + off]
        pairs = sum(min(i + 1 + off, Sk) for i in range(Sq))
    else:
        pairs = Sq * Sk
    ops = 4 * B * H * d * pairs
    nbytes = F32 * (2 * B * Sq * H * d + 2 * B * Sk * K * d)
    return ops, nbytes


def k8_work(shape: tuple, lengths: list) -> tuple[int, int]:
    """(operations, bytes) of one K8 launch at (B, H, K, T, d) over the
    live cache lengths of its rows."""
    B, H, K, T, d = shape
    live = sum(lengths)
    ops = 4 * H * d * live
    nbytes = F32 * (2 * B * H * d + 2 * K * d * live) + 4 * B
    return ops, nbytes


def bound_s(ops: int, nbytes: int, peak_flops: float,
            peak_bytes: float) -> float:
    return max(ops / peak_flops, nbytes / peak_bytes)
