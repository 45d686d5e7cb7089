"""Batched scenario engine: the ensemble axis, the synchronous
solver-as-a-service front end and the always-on async engine.

Port of ``heat3d_tpu.serve``:

- :mod:`heat3d_tpu_torch.serve.scenario` / :mod:`heat3d_tpu_torch.serve.ensemble`:
  a ``ScenarioBatch`` (per-member initial condition, boundary value,
  diffusivity/dt, step budget over one shared structural config) and an
  ``EnsembleSolver`` that threads a leading batch dimension through the
  exchange and the plain tap chain — one batched loop advances every
  member.
- :mod:`heat3d_tpu_torch.serve.queue` / ``python -m heat3d_tpu_torch serve``:
  a request queue that packs compatible scenario submissions into
  shape-bucketed batches, executes them through cached ensembles, and
  streams per-member results back with ledger spans and queue metrics;
  :mod:`heat3d_tpu_torch.serve.bench`, the ensemble throughput row.

- :mod:`heat3d_tpu_torch.serve.engine` (``serve --async``): the always-on
  engine, bucket workers on CUDA streams of their own, requeue on a
  backend loss; :mod:`heat3d_tpu_torch.serve.aot`, its warm-up (one eager
  pass a key, remembered in the process); :mod:`heat3d_tpu_torch.serve.loadgen`
  (``serve --loadgen``), the open-loop soak with SLO and burn monitoring.
"""

from heat3d_tpu_torch.serve.scenario import Scenario, ScenarioBatch  # noqa: F401
from heat3d_tpu_torch.serve.ensemble import EnsembleSolver  # noqa: F401
from heat3d_tpu_torch.serve.queue import ScenarioQueue  # noqa: F401
