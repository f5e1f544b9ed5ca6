"""Observability plane: spans, metrics and the run journal, off unless
installed.

Three module-global sinks (``obs.trace``, ``obs.metrics``,
``obs.journal``), each ``None`` until installed, so a disabled plane
costs one pointer read and a ``None`` check per call site.
``ObservabilityPlane`` bundles all three for one run directory and wires
the tracer's sink into the journal; ``observed(run_dir)`` is the
context-manager form the CLI uses::

    from repro_torch.obs import observed
    with observed(run_dir):
        ...   # dumps/restores/orchestration in here are traced

``repro_torch.obs.export`` turns the journal back into a Chrome
trace-event file, a filtered event timeline or a flat metrics dict: what
``python -m repro_torch trace|events|metrics`` print.
"""
from repro_torch.obs import journal, metrics, trace  # noqa: F401
from repro_torch.obs.journal import RunJournal  # noqa: F401
from repro_torch.obs.metrics import METRIC_SCHEMA, MetricsRegistry  # noqa: F401
from repro_torch.obs.plane import ObservabilityPlane, observed  # noqa: F401
from repro_torch.obs.trace import SPAN_SCHEMA, Span, Tracer, span  # noqa: F401
