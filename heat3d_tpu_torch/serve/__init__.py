"""Batched scenario engine: the ensemble axis and the synchronous
solver-as-a-service front end.

Port of ``heat3d_tpu.serve``, part one:

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

Not ported yet (part two): the always-on async engine
(``heat3d_tpu.serve.engine``), its executable cache (``serve/aot.py``) and
the load generator (``serve/loadgen.py``).
"""

from heat3d_tpu_torch.serve.scenario import Scenario, ScenarioBatch  # noqa: F401
from heat3d_tpu_torch.serve.ensemble import EnsembleSolver  # noqa: F401
from heat3d_tpu_torch.serve.queue import ScenarioQueue  # noqa: F401
