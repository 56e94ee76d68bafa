"""Synthetic training data (port of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticTokens, make_train_iterator

__all__ = ["SyntheticTokens", "make_train_iterator"]
