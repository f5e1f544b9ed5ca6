"""Observability sinks (spans, metrics, journal): off unless installed."""
from repro_torch.obs import journal, metrics, trace  # noqa: F401
