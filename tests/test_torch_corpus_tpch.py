"""Corpus queries of the tpch schema: the port against the reference,
under the sort-merge join configuration (see torch_corpus_check.py)."""
import pytest

torch = pytest.importorskip("torch")

from torch_corpus_check import check, specs  # noqa: E402

SPECS = specs("tpch")


def test_schema_has_queries():
    assert SPECS


@pytest.mark.parametrize("impl", ("ref", "host"))
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.qid)
def test_query_matches_reference(spec, impl):
    check(spec, impl)
