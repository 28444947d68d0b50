"""What the benchmark hands the program under test (the port,
``repro_torch``), in the program's own terms.

``plan(spec, templates)`` builds a query file's logical plan with the
port's ``Q``/``col`` builder; ``database(tables, device)`` loads the
benchmark's records into the port's ``Database``; ``model_config(cfg)``
is a configuration file as the port's ``ModelConfig``. Nothing here is
read by the reference."""
from __future__ import annotations

CMPS = (">=", ">", "<=", "<", "==", "!=")


def _pred(col, where):
    name, op, value = where
    c = col(name)
    if op == "between":
        return c.between(*value)
    if op not in CMPS:
        raise ValueError(f"unknown comparison {op!r}")
    return {">=": c.__ge__, ">": c.__gt__, "<=": c.__le__, "<": c.__lt__,
            "==": c.__eq__, "!=": c.__ne__}[op](value)


def _build(node: dict, templates: dict, Q, col):
    q = Q.scan(node["scan"])
    for op in node["ops"]:
        if "join" in op:
            q = q.join(_build(op["join"], templates, Q, col), *op["on"])
        elif "where" in op:
            q = q.where(_pred(col, op["where"]))
        elif "sem_filter" in op:
            q = q.sem_filter(templates[op["sem_filter"]])
        elif "sem_join" in op:
            q = q.sem_join(_build(op["sem_join"], templates, Q, col),
                           templates[op["template"]])
        elif "group_by" in op:
            q = q.group_by(op["group_by"], [tuple(a) for a in op["aggs"]])
        elif "select" in op:
            q = q.select(*op["select"])
        else:
            raise ValueError(f"unknown operator {sorted(op)}")
    return q


def plan(spec: dict, templates: dict):
    """The port's logical plan of query file ``spec``."""
    from repro_torch.core import Q, col

    return _build(spec["plan"], templates, Q, col).build()


def database(tables: dict, device):
    """A port ``Database`` on ``device`` holding ``tables``."""
    from repro_torch.engine import Database

    db = Database(device=device)
    for name, (records, text_columns) in tables.items():
        db.add_table(name, records, text_columns=set(text_columns))
    return db


ACTS = {"gelu_pytorch_tanh": False, "silu": True}  # -> gated MLP


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of configuration file ``cfg``; raises
    where the file states what the port does not run."""
    from repro_torch.models.config import ModelConfig

    if cfg["norm_type"] != "rms_norm" or cfg["dtype"] != "float32":
        raise ValueError(f"{cfg['name']}: the port runs float32 RMSNorm")
    if cfg.get("use_bias") or cfg.get("attention_bias") or \
            cfg.get("qk_norm") or cfg.get("sliding_window"):
        raise ValueError(f"{cfg['name']}: biases, q/k norms and windows "
                         f"are not run by the dense and MoE blocks")
    moe = cfg["family"] == "moe"
    if moe and not cfg["norm_topk_prob"]:
        raise ValueError(f"{cfg['name']}: the port renormalises top-k")
    return ModelConfig(
        name=cfg["name"], family=cfg["family"],
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], gated_mlp=ACTS[cfg["hidden_act"]],
        num_experts=cfg.get("num_experts", 0),
        experts_per_tok=cfg.get("num_experts_per_tok", 0),
        moe_d_ff=cfg["intermediate_size"] if moe else 0,
        moe_capacity_factor=cfg.get("moe_capacity_factor", 1.25),
        rope_theta=cfg["rope_theta"],
        norm_eps=cfg.get("norm_epsilon", cfg.get("rms_norm_eps")),
        tie_embeddings=cfg["tie_word_embeddings"])
