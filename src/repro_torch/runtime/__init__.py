"""Straggler detection and elastic mesh sizing (port of ``repro.runtime``)."""
from repro_torch.runtime.elastic import derive_mesh_shape
from repro_torch.runtime.watchdog import StragglerWatchdog

__all__ = ["StragglerWatchdog", "derive_mesh_shape"]
