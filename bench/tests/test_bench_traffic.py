"""The generator's inputs: the same pass for a seed, the frozen table
generators equal to the port's, the weight layout the port reads."""
import pytest
import torch

from bench import manifest, traffic, weights
from bench.tests import tiny

MIX = manifest.mix("semsql")


def test_a_seed_gives_the_same_pass():
    a, b = traffic.build(MIX), traffic.build(MIX)
    assert [q["qid"] for q in a.queries] == [q["qid"] for q in b.queries]
    assert a.tables == b.tables == a.ref_tables
    assert a.tables is not a.ref_tables


def test_every_seed_gives_the_same_work_in_its_own_order():
    """The tables come from the mix's own seeds and a pass runs the
    mix's queries in the order the file gives: ``--seed`` draws only the
    weights."""
    w = traffic.build(MIX)
    assert [q["qid"] for q in w.queries] == MIX["queries"] == \
        ["Q5", "Q13", "Q16", "Q23", "q8"]
    for name, seed in MIX["table_seeds"].items():
        if name in w.tables:
            assert w.tables[name] == manifest.schema(name).make(
                seed=seed, scale=MIX["scale"])


@pytest.mark.parametrize("name", ["bookreview", "yelp", "googlelocal",
                                  "tpch", "ecommerce"])
def test_frozen_schemas_equal_the_ports(name):
    from repro_torch.data import SCHEMAS
    from repro_torch.data import schemas as S

    mine = manifest.schema(name)
    db = SCHEMAS[name](seed=9, scale=0.05, device="cpu")
    tables = mine.make(seed=9, scale=0.05)
    assert set(tables) == set(db.payloads)
    for t, (records, text) in tables.items():
        assert records == db.payloads[t]
        assert {f"{t}.{c}" for c in text} == {
            c for c in db.text_cols if c.startswith(t + ".")}
    for k, v in mine.TEMPLATES.items():
        assert getattr(S, k) == v


@pytest.mark.parametrize("name", ["starcoder2-3b", "olmoe-1b-7b"])
def test_weights_have_the_ports_layout(name):
    from bench import port
    from repro_torch.models import build_params

    cfg = tiny.config(name)
    want = build_params(port.model_config(cfg),
                        lambda path, shape, scale: tuple(shape))
    got = weights.make(cfg, 5, "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(got) == want
    again = weights.make(cfg, 5, "cpu")
    assert torch.equal(got["embed"], again["embed"])
    assert not torch.equal(got["embed"], weights.make(cfg, 6, "cpu")["embed"])


def test_full_configs_count_the_ports_parameters():
    from bench import port
    from repro_torch.models import count_params

    for name, n in (("starcoder2-3b", 3_029_523_456),
                    ("olmoe-1b-7b", 6_919_096_320)):
        cfg = manifest.config(name)
        total = 0
        for _, shape, _ in weights.leaves(cfg):
            k = 1
            for s in shape:
                k *= s
            total += k
        assert total == n == count_params(port.model_config(cfg))
