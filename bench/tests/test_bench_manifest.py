"""BENCHMARK.json against the contract's rules, and files found by
name: a new configuration, mix, query or metric is picked up from its
own file with no edit to a file that is there."""
import json
import shutil

import pytest

from bench import manifest

MAN = manifest.manifest()


def test_names_and_units_follow_the_rules():
    assert manifest.check_names(MAN) == []
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert manifest.UNIT.match(e["unit"]), e
        assert e["better"] in ("lower", "higher")
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for e in MAN["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25


def test_every_file_a_name_needs_is_there():
    for c in MAN["configs"]:
        assert (manifest.ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
        cfg = manifest.load_json(manifest.ROOT / c["file"])
        manifest.reference(cfg["family"])
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(manifest.metric_reader(e["name"]))
    for w in MAN["workloads"]:
        cell = manifest.cell(MAN, w["name"])
        for q in cell.mix["queries"]:
            spec = manifest.query(q)
            manifest.schema(spec["schema"])
        names = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_moves_names_an_end_to_end_metric_each_cell_reports():
    e2e = {e["name"] for e in MAN["end_to_end"]}
    for e in MAN["per_layer"]:
        assert e["moves"] in e2e
        assert len(e["layer"]) <= 200 and "\n" not in e["layer"]


def test_command_and_paths():
    assert MAN["paths"] == ["bench"]
    assert MAN["command"][1] == "bench/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, and
    # 2 x 90 s of compile a cell, in 43200 s less 1200 spare, at 24 cells
    full = (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180
    assert full <= 43200 - 1200, full
    assert cells <= 24


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """A copy of the benchmark's data and metric files, as a later
    change would find them."""
    dst = tmp_path / "bench"
    for d in ("configs", "mixes", "queries", "metrics"):
        shutil.copytree(manifest.BENCH / d, dst / d)
    monkeypatch.setattr(manifest, "BENCH", dst)
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    return dst


def test_new_files_are_found_by_name(bench_copy):
    cfg = manifest.config("starcoder2-3b")
    cfg["name"] = "starcoder2-3b-b64"
    (bench_copy / "configs" / "starcoder2-3b-b64.json").write_text(
        json.dumps(cfg))
    mix = manifest.mix("semsql")
    mix.update(name="semsql.q13", queries=["Q13", "Q13x"])
    (bench_copy / "mixes" / "semsql.q13.json").write_text(json.dumps(mix))
    q = manifest.query("Q13")
    q["qid"] = "Q13x"
    (bench_copy / "queries" / "Q13x.json").write_text(json.dumps(q))
    (bench_copy / "metrics" / "calls.per-pass.py").write_text(
        "def read(run):\n    return run['backend_calls'] / run['passes']\n")
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "starcoder2-3b-b64",
                           "file": "bench/configs/starcoder2-3b-b64.json"})
    man["workloads"].append({"name": "semsql.q13.b64",
                             "config": "starcoder2-3b-b64",
                             "traffic": "semsql.q13", "chips": 1})
    man["per_layer"].append({"name": "calls.per-pass", "unit": "calls",
                             "better": "lower", "moves": "query_s"})
    cell = manifest.cell(man, "semsql.q13.b64")
    assert cell.config["name"] == "starcoder2-3b-b64"
    assert manifest.query(cell.mix["queries"][1])["qid"] == "Q13x"
    assert "calls.per-pass" in {e["name"] for e in cell.per_layer}
    read = manifest.metric_reader("calls.per-pass")
    assert read({"backend_calls": 10, "passes": 4}) == 2.5


ALLOWED = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_entries_hold_only_their_keys_and_short_lines():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    for kind, keys in ALLOWED.items():
        for e in MAN[kind]:
            assert set(e) <= keys, (kind, e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(manifest.NAME.match(k) for k in c["reduced"])
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    assert len(json.dumps(MAN)) <= 64 * 1024
