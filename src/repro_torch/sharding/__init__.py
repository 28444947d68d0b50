"""Sharding: the key-partitioned data tier (``sharding.data``). The
reference's model-tier policies (``sharding/policy.py``) come with the
training and launch slice."""
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

__all__ = ["DATA_AXIS", "DataMesh", "make_data_mesh", "PartitionCache",
           "ShardedTable", "partition_table", "partition_columns",
           "merge_partitions", "sharded_join_match",
           "sharded_segment_reduce"]
