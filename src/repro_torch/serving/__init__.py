"""Serving tier: continuous-batching engine over the dense LM."""
from .engine import ServingEngine, ServingStats
from .scheduler import Request, SlotScheduler, Ticket

__all__ = ["ServingEngine", "ServingStats", "Request", "SlotScheduler",
           "Ticket"]
