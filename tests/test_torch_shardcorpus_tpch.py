"""Corpus queries of the tpch schema through the port's mesh executor
(four shards on the CPU) against the reference: rows, order, stats and
backend calls against its single-device run, and collective_ops,
join_physical and pipeline_syncs against its own mesh executor on four
forced host devices (one subprocess for the file; see
torch_shard_check.py)."""
import pytest

torch = pytest.importorskip("torch")

from torch_shard_check import (  # noqa: E402
    check,
    reference_mesh,
    reference_single,
    specs,
)

SPECS = specs("tpch")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return reference_mesh("tpch", tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("impl", ("ref", "kernel"))
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.qid)
def test_query_partitioned_matches_reference(spec, impl, mesh_runs):
    check(spec, impl, reference_single(spec), mesh_runs[spec.qid])
