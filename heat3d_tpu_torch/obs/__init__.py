"""Unified telemetry: run ledger, metrics registry, named-span tracing —
plus the :mod:`~heat3d_tpu_torch.obs.perf` layer that judges what they record
(profile capture, roofline attribution, the perf-regression gate,
multihost ledger merge). The PyTorch counterpart of ``heat3d_tpu.obs``:
the same JSONL schema, event and metric names and CLI surface.

Three instruments, one package:

- :mod:`~heat3d_tpu_torch.obs.ledger` — append-only JSONL event stream (spans +
  points, run-id/generation/process tagging) written by every entry point.
- :mod:`~heat3d_tpu_torch.obs.metrics` — counters/gauges/histograms with a
  Prometheus-textfile/JSON exporter and a final per-run summary record.
- :mod:`~heat3d_tpu_torch.obs.trace` — ``torch.profiler.record_function``
  and NVTX ranges so profiler traces attribute device time to *our*
  phases.

Library code uses the module-level conveniences and pays a no-op when
nothing is configured::

    from heat3d_tpu_torch import obs

    obs.get().event("fault_injected", kind_="backend-loss", step=8)
    with obs.get().span("chunk", steps=4) as sp:
        ...
    obs.REGISTRY.counter("retries_total").inc()
    with obs.named_phase("halo_exchange"):
        ...  # the phase's launches
"""

from heat3d_tpu_torch.obs.ledger import (  # noqa: F401
    ENV_LEDGER,
    NULL,
    Ledger,
    NullLedger,
    activate,
    deactivate,
    get,
)
from heat3d_tpu_torch.obs.metrics import (  # noqa: F401
    ENV_METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    export_at_exit,
)
from heat3d_tpu_torch.obs.trace import annotate, named_phase, scoped  # noqa: F401
