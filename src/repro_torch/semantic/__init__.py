"""Semantic-operator runtime: function cache, backends, batched runner."""
from .backend import Backend, OracleBackend
from .cache import CacheStats, FunctionCache, VerdictTable
from .runner import SemanticResult, SemanticRunner, render_prompt

__all__ = [
    "Backend", "OracleBackend",
    "CacheStats", "FunctionCache", "VerdictTable",
    "SemanticResult", "SemanticRunner", "render_prompt",
]
