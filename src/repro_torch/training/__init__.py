"""Training-side pieces the serving tier needs: the tokenizer. The
data streams, the trainer and checkpoints wait for the training slice
(ROADMAP)."""
from .data import HashTokenizer

__all__ = ["HashTokenizer"]
