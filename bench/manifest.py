"""The benchmark's files, found by the names ``BENCHMARK.json`` gives.

Everything that belongs to one configuration, traffic mix, query,
schema, metric or model family sits in a file of its own:

* ``bench/configs/<config>.json`` — a model configuration as it is run;
* ``bench/mixes/<traffic>.json`` — a traffic mix's parameters;
* ``bench/queries/<qid>.json`` — one query of a mix, as data;
* ``bench/schemas/<schema>.py`` — a table generator (``make``,
  ``TEMPLATES``);
* ``bench/metrics/<metric>.py`` — one reader per metric (``read``);
* ``bench/ref/<family>.py`` — the plain reference of a model family.

A later change adds a cell, a mix, a query or a metric by adding such a
file and an entry, never by editing a file that is there.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(root / "BENCHMARK.json")


def check_names(man: dict) -> list[str]:
    """Every name, unit and ``better`` that breaks the manifest's rules
    (empty when all hold)."""
    bad = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in man.get(kind, []):
            if not NAME.match(e["name"]):
                bad.append(f"{kind}: name {e['name']!r}")
            if e["name"] in seen:
                bad.append(f"{kind}: {e['name']!r} twice")
            seen.add(e["name"])
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(f"{kind}: unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                bad.append(f"{kind}: better {e['better']!r}")
    return bad


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(BENCH / "mixes" / f"{name}.json")


def query(qid: str) -> dict:
    return load_json(BENCH / "queries" / f"{qid}.json")


def schema(name: str):
    """The generator module of schema ``name``."""
    return importlib.import_module(f"bench.schemas.{name}")


def reference(family: str):
    """The plain reference of model family ``family``."""
    return importlib.import_module(f"bench.ref.{family}")


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(run) -> float | None`` of metric ``name``, from
    ``bench/metrics/<name>.py`` (any name: the file is loaded by
    path)."""
    path = BENCH / "metrics" / f"{name}.py"
    return _load_file(path, "bench_metric_" + re.sub(r"\W", "_", name)).read


@dataclass(frozen=True)
class Cell:
    """One workload of the manifest with its configuration and mix."""

    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: tuple  # metric entries read in a plain run
    per_layer: tuple  # and in a traced run (a reader that finds nothing
    # to read in a cell returns None, and the metric is left out)


def cell(man: dict, name: str) -> Cell:
    """The workload ``name`` of manifest ``man`` (KeyError if absent)."""
    w = {e["name"]: e for e in man["workloads"]}[name]
    cfgs = {e["name"]: e for e in man["configs"]}
    cfg = load_json(ROOT / cfgs[w["config"]]["file"])
    return Cell(name=name, config=cfg, mix=mix(w["traffic"]),
                chips=int(w["chips"]),
                end_to_end=tuple(man["end_to_end"]),
                per_layer=tuple(man["per_layer"]))
