"""Autotuning: searched, cached, ledger-audited config selection.

Port of ``heat3d_tpu.tune``:

- :mod:`~heat3d_tpu_torch.tune.space` — the knob lattice over
  ``SolverConfig`` with validity pruning through the port's own gates
  (and the mesh factorizations of the elastic re-plan);
- :mod:`~heat3d_tpu_torch.tune.measure` — the budgeted search over
  ``bench.harness.bench_throughput`` (``tune_trial`` ledger events, early
  stopping, ``rtt_dominated`` exclusion);
- :mod:`~heat3d_tpu_torch.tune.decide` — the pairwise single-knob decision
  logic;
- :mod:`~heat3d_tpu_torch.tune.cache` — the JSON tuning store, keyed by
  (chip, processes, devices, grid bucket, equation, dtype[, shards per
  card]); ``backend``/``halo``/``halo_plan``/``fused_rdma`` 'auto' and
  ``time_blocking=0`` resolve through it with a static fallback, every
  hit/miss/stale in the run ledger. It also holds the calibrated peaks;
- :mod:`~heat3d_tpu_torch.tune.cli` — ``python -m heat3d_tpu_torch tune
  run|show|apply|clear|lint``.
"""

from heat3d_tpu_torch.tune.cache import (  # noqa: F401
    ENV_CACHE,
    cache_key,
    cache_path,
    chip_generation,
    load_peak,
    resolve_config,
    store_peak,
)
