"""PyTorch relational engine + hybrid-plan executor."""
from .exec import ExecStats, ExecutionError, Executor, FrontDoor
from .metrics import result_f1
from .table import Database, Table, TextStore, database_from_numpy

__all__ = [
    "ExecStats", "ExecutionError", "Executor", "FrontDoor",
    "result_f1",
    "Database", "Table", "TextStore", "database_from_numpy",
]
