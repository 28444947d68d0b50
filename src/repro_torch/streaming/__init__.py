"""Streaming ingestion + incremental standing-query maintenance.

The append contract is in ``ingest.py``, the incremental-update
invariants of the shared hash table in ``state.py`` and the delta
semantics in ``standing.py``. Sync sites: ``stream_probe`` (one per
probe), ``stream_build`` (the lazy distinct count), ``stream_groups``
(one per group snapshot); ingest costs none.
"""
from .ingest import StreamContext, append_rows
from .standing import (BatchDelta, StandingQuery, StreamSession,
                       freeze_record)
from .state import GroupSnapshot, StreamJoinBuild

__all__ = [
    "append_rows",
    "StreamContext",
    "StreamJoinBuild",
    "GroupSnapshot",
    "StandingQuery",
    "StreamSession",
    "BatchDelta",
    "freeze_record",
]
