"""A run of the harness on the CPU at a tiny size: past the look for a
card, the whole run (set-up, window, comparison, result line), sound
and with the timed path broken underneath, where ``correct`` must come
out false; and a run that loads nothing of JAX or the JAX package."""
import io
import json
import subprocess
import sys

import pytest
import torch

from bench import harness, manifest
from bench.tests import tiny

SEED = 2**31 + 17


def run(seconds=0.05, cell=None):
    res = harness.run_cell(cell or tiny.cell(), SEED, seconds, False,
                           torch.device("cpu"))
    out = io.StringIO()
    harness.emit(res, out=out)
    assert json.loads(out.getvalue().splitlines()[-1]) == res
    return res


def test_a_sound_run_is_correct():
    res = run()
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert {e["name"] for e in manifest.cell(
        manifest.manifest(), "semsql.starcoder2-3b").end_to_end} == \
        set(res["metrics"])
    assert res["checks"]["tokens_checked"]["value"] >= 200


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    from repro_torch.serving import ServingEngine

    real = ServingEngine._decode_round

    def altered(self, cache, cur, pos, live, rem):
        packed = real(self, cache, cur, pos, live, rem)
        b = self.batch_size
        emit = packed[:b]
        packed[:b] = torch.where(emit >= 0, (emit + 9) % self.cfg.vocab_size,
                                 emit)
        return packed

    monkeypatch.setattr(ServingEngine, "_decode_round", altered)
    res = run()
    assert not res["correct"]
    assert res["checks"]["served_gap"]["value"] > \
        res["checks"]["served_gap"]["limit"]


def test_an_answer_altered_is_caught(monkeypatch):
    from repro_torch.semantic import ModelBackend

    monkeypatch.setattr(ModelBackend, "_parse", lambda self, r, ctx: True)
    res = run()
    assert not res["correct"]
    assert res["checks"]["rows_wrong"]["value"] > 0


def test_rows_altered_are_caught(monkeypatch):
    from repro_torch.engine import Database

    real = Database.materialize

    def extra(self, table, cols=None):
        rows = real(self, table, cols)
        return rows + [{c: 1 for c in cols}]

    monkeypatch.setattr(Database, "materialize", extra)
    res = run()
    assert not res["correct"]
    assert res["checks"]["rows_wrong"]["value"] > 0


def test_a_cache_scope_that_leaks_between_passes_is_caught(monkeypatch):
    from repro_torch.semantic import SemanticRunner

    monkeypatch.setattr(SemanticRunner, "reset_query_scope",
                        lambda self: None)
    res = run(seconds=0.0)  # one pass after the set-up's warm one
    assert not res["correct"]
    assert res["checks"]["pass_spread"]["value"] > 0


def test_a_run_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "semsql.starcoder2-3b", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_run_loads_nothing_of_jax(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from bench import harness\n"
        "from bench.tests import tiny\n"
        "res = harness.run_cell(tiny.cell(), 5, 0.0, False,\n"
        "                       torch.device('cpu'))\n"
        "bad = {m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro'}\n"
        "assert res['correct'] and not bad, bad\n")
    root = manifest.ROOT
    env = {"PYTHONPATH": f"{root}:{root / 'src'}", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]


def test_a_moe_run_replays_its_steps_and_catches_dropped_capacity(
        monkeypatch):
    cell = tiny.cell("semsql.olmoe-1b-7b")
    res = run(cell=cell, seconds=0.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["kv_err"]["value"] < 1e-5
    from repro_torch.models import layers

    real = layers.moe_capacity
    monkeypatch.setattr(layers, "moe_capacity",
                        lambda cfg, n: 4 * real(cfg, n))
    res = run(cell=cell, seconds=0.0)
    assert not res["correct"]
    assert res["checks"]["kv_err"]["value"] > \
        res["checks"]["kv_err"]["limit"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    assert harness.forbidden_loaded(
        {"jax.numpy": 0, "repro.engine": 0, "repro_torch": 0,
         "torch": 0}) == ["jax", "repro"]
    assert harness.forbidden_loaded({"repro_torch.models": 0,
                                     "jaxtyping": 0}) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a: {"correct": True, "checks": {}})
    argv = ["--workload", "semsql.starcoder2-3b", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    monkeypatch.setattr(harness, "forbidden_loaded", lambda: ["jax"])
    assert harness.main(argv) != 0
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(harness, "forbidden_loaded", lambda: [])
    assert harness.main(argv) == 0
    assert capsys.readouterr().out.strip() == json.dumps(
        {"correct": True, "checks": {}})
