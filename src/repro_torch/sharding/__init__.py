"""Sharding: the model tier's logical-axis policies
(``sharding/policy.py``), its execution over a model mesh
(``sharding/model.py``), and the key-partitioned data tier
(``sharding/data.py``)."""
from .data import (
    DATA_AXIS,
    DataMesh,
    PartitionCache,
    ShardedTable,
    make_data_mesh,
    merge_partitions,
    partition_columns,
    partition_table,
    sharded_join_match,
    sharded_segment_reduce,
)
from .policy import PartitionSpec, Placement, ShardingPolicy, spec_tree

__all__ = ["ShardingPolicy", "PartitionSpec", "Placement", "spec_tree",
           "DATA_AXIS", "DataMesh", "make_data_mesh", "PartitionCache",
           "ShardedTable", "partition_table", "partition_columns",
           "merge_partitions", "sharded_join_match",
           "sharded_segment_reduce"]
