"""The general generator of semantic-SQL traffic.

A mix file (``bench/mixes/<name>.json``) names its queries in the order
a pass runs them, the scale and seeds of their tables and the cache
scope. From it this module makes the run's inputs: the tables (one copy
for the program, another for the reference) and the queries of a pass.
Tables come from each schema's fixed seed in the mix, so every run does
the same work in the same order; ``--seed`` draws the weights
(``weights.py``)."""
from __future__ import annotations

import copy
from dataclasses import dataclass

from . import manifest


@dataclass
class Workload:
    mix: dict
    queries: list  # query specs of one pass, in the order they run
    tables: dict  # schema -> {table: (records, text columns)}
    ref_tables: dict  # an independent copy for the reference
    templates: dict  # schema -> {template name: text}


def build(mix: dict) -> Workload:
    specs = [manifest.query(q) for q in mix["queries"]]
    tables, templates = {}, {}
    for sp in specs:
        name = sp["schema"]
        if name in tables:
            continue
        mod = manifest.schema(name)
        tables[name] = mod.make(seed=int(mix["table_seeds"][name]),
                                scale=float(mix["scale"]))
        templates[name] = dict(mod.TEMPLATES)
    return Workload(mix=mix, queries=specs, tables=tables,
                    ref_tables=copy.deepcopy(tables), templates=templates)
