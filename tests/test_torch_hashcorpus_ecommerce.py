"""Corpus queries of the ecommerce schema: the port against the reference,
under the default ``CostParams()`` — the configuration users run, in
which the planner stamps every join ``hash`` (see
torch_corpus_check.py)."""
import pytest

torch = pytest.importorskip("torch")

from torch_corpus_check import (  # noqa: E402
    check,
    default_join_physicals,
    specs,
)

SPECS = specs("ecommerce")


def test_default_plans_stamp_every_join_hash():
    assert default_join_physicals("ecommerce") == {"hash": 5}


@pytest.mark.parametrize("impl", ("ref", "host"))
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.qid)
def test_query_matches_reference(spec, impl):
    check(spec, impl, config="default")
