"""Tiny versions of the benchmark's cells for CPU tests: the published
configuration files with every width and depth cut, the same mix."""
from __future__ import annotations

import dataclasses

from bench import manifest

TINY = {"dense": dict(num_hidden_layers=2, hidden_size=64,
                      num_attention_heads=4, num_key_value_heads=2,
                      head_dim=16, intermediate_size=128, vocab_size=256),
        "moe": dict(num_hidden_layers=2, hidden_size=64,
                    num_attention_heads=4, num_key_value_heads=4,
                    head_dim=16, intermediate_size=96, vocab_size=256,
                    num_experts=8, num_experts_per_tok=2)}


def tiny(cfg: dict) -> dict:
    """``cfg`` cut to the tiny widths; the sampled steps lie within the
    one or two passes a CPU window holds."""
    cfg = dict(cfg, **TINY[cfg["family"]])
    cfg["check"] = dict(cfg["check"], within=[24, 40])
    return cfg


def config(name: str) -> dict:
    return tiny(manifest.config(name))


def cell(workload: str = "semsql.starcoder2-3b"):
    c = manifest.cell(manifest.manifest(), workload)
    return dataclasses.replace(c, config=tiny(c.config))
