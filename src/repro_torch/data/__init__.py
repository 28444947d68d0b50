"""Synthetic data: benchmark schemas + token streams for LM training."""
from .schemas import (
    SCHEMAS,
    make_bookreview,
    make_ecommerce,
    make_googlelocal,
    make_tpch,
    make_yelp,
)

__all__ = [
    "SCHEMAS", "make_bookreview", "make_ecommerce", "make_googlelocal",
    "make_tpch", "make_yelp",
]
