"""Assigned-architecture configs.  ``get_config("<id>")`` resolves by the
public id (dashes/dots as listed in the assignment); module filenames are
sanitised python identifiers.
"""
from repro_torch.configs.registry import ARCH_IDS, get_config, input_shapes

__all__ = ["ARCH_IDS", "get_config", "input_shapes"]
