"""The model's weights, made by the benchmark from ``--seed``.

One tensor a leaf in the layout the program and the reference both read
(layers stacked on a leading axis): norm gains 1, every other leaf
normal / sqrt(fan_in), drawn on the device by one ``torch.Generator``,
one call a leaf, in float32 as the configurations are served."""
from __future__ import annotations

import torch

ONES = 0  # fan_in marking a norm gain


def leaves(cfg: dict) -> list:
    """``(path, shape, fan_in)`` of every leaf of a dense or MoE
    configuration file, in the order they are drawn."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, F, V = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    gated = cfg["hidden_act"] == "silu"
    out = [(("embed",), (V, D), D),
           (("blocks", "ln1"), (L, D), ONES),
           (("blocks", "ln2"), (L, D), ONES),
           (("blocks", "attn", "wq"), (L, D, H, hd), D),
           (("blocks", "attn", "wk"), (L, D, K, hd), D),
           (("blocks", "attn", "wv"), (L, D, K, hd), D),
           (("blocks", "attn", "wo"), (L, H, hd, D), H * hd)]
    if cfg["family"] == "moe":
        E = cfg["num_experts"]
        out += [(("blocks", "moe", "router"), (L, D, E), D),
                (("blocks", "moe", "w_in"), (L, E, D, F), D),
                (("blocks", "moe", "w_out"), (L, E, F, D), F)]
        if gated:
            out.append((("blocks", "moe", "w_gate"), (L, E, D, F), D))
    elif cfg["family"] == "dense":
        out += [(("blocks", "mlp", "w_in"), (L, D, F), D),
                (("blocks", "mlp", "w_out"), (L, F, D), F)]
        if gated:
            out.append((("blocks", "mlp", "w_gate"), (L, D, F), D))
    else:
        raise ValueError(f"no weights for family {cfg['family']!r}")
    out.append((("final_ln",), (D,), ONES))
    if not cfg["tie_word_embeddings"]:
        out.append((("lm_head",), (D, V), D))
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """The nested weight tree of ``cfg`` drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for path, shape, fan_in in leaves(cfg):
        if fan_in == ONES:
            t = torch.ones(shape, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device)
            t.mul_(fan_in ** -0.5)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree
