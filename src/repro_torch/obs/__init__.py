"""Runtime observability of the port: the process-wide metrics registry.

Only :mod:`repro_torch.obs.registry` is ported so far; the drivers
publish their ``em.*`` counters into it.
"""

from repro_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    reset,
)

__all__ = ["MetricsRegistry", "get_registry", "reset"]
