"""Performance observability: is a run FAST for its hardware, and did it
regress?

The base obs package (ledger / metrics / trace) makes runs *explainable*;
this layer makes them *judged*. Six instruments:

- :mod:`~heat3d_tpu_torch.obs.perf.profiling` — ``--profile DIR``
  ``torch.profiler`` capture on every entry point, with the artifact path
  and the capture overhead recorded into the run ledger (a profiled run
  must say it was profiled — capture cost is measurement perturbation).
- :mod:`~heat3d_tpu_torch.obs.perf.roofline` — per-config FLOPs/bytes from
  the package's analytic cost model (the one yardstick of every bound)
  joined with per-backend peak specs: ``obs roofline`` prints a per-phase
  achieved-vs-peak table (the phases are the same ``heat3d.*`` names the
  phase ranges use — ``parallel.step.phase_programs`` is the keying), and
  the bench-row model lives here too.
- :mod:`~heat3d_tpu_torch.obs.perf.regress` — ``obs regress``: the
  perf-regression gate comparing a session's bench rows against history
  with per-metric tolerance bands and platform/cpu_fallback-aware
  baselines (a CPU run never fails against an on-card record).
- :mod:`~heat3d_tpu_torch.obs.perf.merge` — ``obs merge``: join the
  per-process ledgers of a multi-process run into one timeline with
  cross-process skew stats.
- :mod:`~heat3d_tpu_torch.obs.perf.timeline` — ``obs timeline``: one
  normalized event model over ledger + merged streams + profile captures;
  Chrome-trace/Perfetto export, per-phase device totals and the device
  busy share of a capture (the measured side of ``roofline
  --from-profile``), and step-time drift / straggler detection
  (``obs_anomaly`` events).

- :mod:`~heat3d_tpu_torch.obs.perf.slo` — ``obs slo``: declarative
  service-level objectives (serve latency per bucket, step time, halo
  share, the degraded-serving budget) judged from a ledger into a
  burn-rate verdict; rc 1 only on a breach.

Failure posture (inherited from obs): perf telemetry never kills the run
it observes — profiling and cost errors degrade to a ledger note.
"""

from heat3d_tpu_torch.obs.perf.profiling import profile_capture  # noqa: F401
