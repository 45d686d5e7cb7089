"""Canonical registries the port's checkers (and the data lints) consume.

Three vocabularies drift silently as the port grows unless one module
holds them, the port's counterpart of the JAX package's
``analysis/registry.py``:

- :data:`LEDGER_EVENTS` — every event/span name either package may emit,
  with its kind, so one ledger lint (``obs check --taxonomy``) holds both
  packages' ledgers to one vocabulary. The taxonomy checker
  (:mod:`~heat3d_tpu_torch.analysis.taxonomy`) fails the lint when the
  port emits an unregistered name or the wrong kind, and when a
  registered name has no row in the port's
  ``heat3d_tpu_torch/docs/OBSERVABILITY.md``. Events only the JAX package
  emits are marked ``reference`` (their emission is not the port's to
  check; :data:`REFERENCE_EVENTS`).
- :data:`ENV_VARS` — every ``HEAT3D_*`` name the port reads: an
  environment variable (``kind: env``) or a compile-time macro the
  wrappers pass to ``nvcc`` (``kind: define``). Referenced but
  unregistered fails, registered but undocumented fails, registered but
  referenced nowhere warns (a stale entry).
- :data:`FAIL_SOFT_CONTRACT` — the telemetry functions production code
  calls unconditionally, which may never raise an environmental failure
  into the run they observe (:mod:`~heat3d_tpu_torch.analysis.failsoft`).

Adding an event or a knob is a three-line change by design: emit or read
it, register it here, add its row to the port's docs — and the lint holds
the three together from then on.
"""

from __future__ import annotations

from typing import Any, Dict

# ---- ledger-event taxonomy -------------------------------------------------
# name -> {kind: point|span, module: emitter, desc, external: emitted by
# generated/child code the AST scan cannot see (registry + docs only)}

LEDGER_EVENTS: Dict[str, Dict[str, Any]] = {
    # lifecycle (obs/ledger.py writes the open/close frames itself)
    "ledger_open": {"kind": "point", "module": "obs/ledger.py",
                    "desc": "stream header: schema, pid, argv, meta"},
    "ledger_close": {"kind": "point", "module": "obs/ledger.py",
                     "desc": "stream footer: rc, error if any"},
    "run_start": {"kind": "point", "module": "cli.py",
                  "desc": "resolved config of the run about to execute"},
    "run_summary": {"kind": "point", "module": "cli.py",
                    "desc": "machine mirror of the stdout JSON summary"},
    "metrics_summary": {"kind": "point", "module": "cli.py, bench/__main__.py",
                        "desc": "final metrics-registry snapshot"},
    "residual": {"kind": "point", "module": "cli.py",
                 "desc": "mid-run L2 residual at a reporting boundary"},
    # stepping
    "warmup": {"kind": "span", "module": "cli.py",
               "desc": "executable warmup outside the timed window"},
    "run_loop": {"kind": "span", "module": "cli.py",
                 "desc": "the whole timed stepping loop (steps field)"},
    "chunk": {"kind": "span", "module": "resilience/supervisor.py",
              "desc": "one supervised checkpoint window (force-synced)"},
    "init_state": {"kind": "span", "module": "models/heat3d.py",
                   "desc": "sharded initial-state construction"},
    "cg_solve": {"kind": "point", "module": "models/heat3d.py",
                 "desc": "implicit-cg run finished: steps, last solve's "
                         "iteration count and relative residual (the "
                         "stiff-dt convergence audit trail)"},
    # resilience
    "supervised_start": {"kind": "point", "module": "resilience/supervisor.py",
                         "desc": "supervisor engaged: target step, cadence"},
    "supervised_end": {"kind": "point", "module": "resilience/supervisor.py",
                       "desc": "supervisor done: steps, recoveries"},
    "fault_injected": {"kind": "point", "module": "resilience/faults.py",
                       "desc": "deterministic fault fired (kind_ field)"},
    "retry_attempt": {"kind": "point", "module": "resilience/retry.py",
                      "desc": "one RetryPolicy attempt (ok, delay)"},
    "retry_outcome": {"kind": "point", "module": "resilience/retry.py",
                      "desc": "RetryPolicy.run verdict (stop_reason)"},
    "heal_wait": {"kind": "span", "module": "resilience/supervisor.py",
                  "desc": "backend heal wait (priced outage)"},
    "recovery": {"kind": "point", "module": "resilience/supervisor.py",
                 "desc": "survived failure: kind_, resumed_from"},
    "generation_save": {"kind": "point", "module": "resilience/supervisor.py",
                        "desc": "checkpoint generation written"},
    # elastic degradation (resilience/elastic.py + supervisor)
    "elastic_refactor": {"kind": "point", "module": "resilience/elastic.py",
                         "desc": "survivor-mesh re-factorization: "
                                 "direction (degrade|expand), old/new "
                                 "mesh, survivors, re-stitch seconds"},
    "degraded_mode_enter": {"kind": "point",
                            "module": "resilience/supervisor.py",
                            "desc": "supervised run continuing on a "
                                    "survivor mesh (step, mesh, "
                                    "survivors)"},
    "degraded_mode_exit": {"kind": "point",
                           "module": "resilience/supervisor.py",
                           "desc": "re-expand restored the original "
                                   "mesh (step, degraded seconds)"},
    "backend_probe": {"kind": "span", "module": "utils/backendprobe.py",
                      "desc": "out-of-process backend liveness probe"},
    # checkpoints
    "ckpt_save": {"kind": "span", "module": "utils/checkpoint.py",
                  "desc": "checkpoint write (path, step)"},
    "ckpt_load": {"kind": "span", "module": "utils/checkpoint.py",
                  "desc": "checkpoint read (path)"},
    "ckpt_corrupt": {"kind": "point", "module": "utils/checkpoint.py",
                     "desc": "shard checksum mismatch detected"},
    "ckpt_quarantine": {"kind": "point", "module": "utils/checkpoint.py",
                        "desc": "corrupt generation renamed aside"},
    # bench
    "bench_row": {"kind": "point", "module": "bench/harness.py",
                  "desc": "full measured row mirrored into the ledger (ts_)"},
    "bench_row_measure": {"kind": "span", "module": "bench/harness.py",
                          "desc": "one row's measurement bracket"},
    "bench_row_replayed": {"kind": "point", "module": "bench/harness.py",
                           "desc": "row re-emitted from a sweep journal"},
    "bench_row_pending": {"kind": "point", "module": "bench/harness.py",
                          "desc": "row measured off-platform, deferred"},
    "probe_skipped": {"kind": "point", "module": "bench.py (child code)",
                      "external": True,
                      "desc": "bench probe ladder skipped (fast path)"},
    # perf observability
    "profile_capture": {"kind": "point", "module": "obs/perf/profiling.py",
                        "desc": "profiler bracket: artifact, overhead, ok"},
    "step_cost": {"kind": "point", "module": "obs/perf/roofline.py",
                  "desc": "cost of the step program (XLA's cost_analysis; "
                          "the port's analytic count)"},
    "peak_calibrated": {"kind": "point", "module": "obs/perf/roofline.py",
                        "desc": "measured per-chip vector peak stored"},
    "obs_anomaly": {"kind": "point", "module": "obs/perf/timeline.py",
                    "desc": "step-time drift or host straggler flagged "
                            "(kind_, delta_pct, regress bands)"},
    "timeline_export": {"kind": "point", "module": "obs/perf/timeline.py",
                        "desc": "Chrome-trace export written (path, "
                                "events, streams)"},
    "slo_verdict": {"kind": "point", "module": "obs/perf/slo.py",
                    "desc": "SLO evaluation: verdict + per-objective "
                            "burn rates"},
    # comm observatory (obs/comm/)
    "comm_probe": {"kind": "point", "module": "obs/comm/probe.py",
                   "desc": "one probed halo link (axis, direction, "
                           "sub_block): plan-predicted bytes joined to "
                           "measured p50 time -> GB/s"},
    "clock_align": {"kind": "point", "module": "obs/perf/merge.py",
                    "desc": "merge --align applied: anchor event, "
                            "per-source offsets, confidence interval"},
    "adjudicate_verdict": {"kind": "point", "module":
                           "obs/comm/adjudicate.py",
                           "desc": "A/B stage verdicts "
                                   "(pass/fail/no-data per stage + rc)"},
    # exchange plans (parallel/plan.py)
    "exchange_plan_built": {"kind": "point", "module": "parallel/plan.py",
                            "desc": "persistent exchange plan constructed "
                                    "(mode, transport, width, messages) — "
                                    "once per plan key per run"},
    "plan_cache_hit": {"kind": "point", "module": "parallel/plan.py",
                       "desc": "exchange plan reused from the process "
                               "cache (once per plan key per run)"},
    "fused_rdma_dispatch": {"kind": "point", "module": "parallel/step.py",
                            "desc": "fused in-kernel RDMA superstep route "
                                    "selected (plan key, tb, sub-block "
                                    "count, emulated flag) — once per "
                                    "plan key per run"},
    # autotuning
    "tune_search_start": {"kind": "point", "module": "tune/measure.py",
                          "desc": "search opened: space, budget, key"},
    "tune_trial": {"kind": "point", "module": "tune/measure.py",
                   "desc": "one candidate: measured/pruned/dominated/error"},
    "tune_winner": {"kind": "point", "module": "tune/measure.py",
                    "desc": "search verdict: winning knobs + metric"},
    "tune_budget_exhausted": {"kind": "point", "module": "tune/measure.py",
                              "desc": "unmeasured candidates at budget end"},
    "tune_probe": {"kind": "span", "module": "tune/measure.py",
                   "desc": "short-probe bracket (early stopping)"},
    "tune_trial_measure": {"kind": "span", "module": "tune/measure.py",
                           "desc": "full trial measurement bracket"},
    "tune_cache_hit": {"kind": "point", "module": "tune/cache.py",
                       "desc": "auto knobs resolved from a cache entry"},
    "tune_cache_miss": {"kind": "point", "module": "tune/cache.py",
                        "desc": "no entry for this context (static fallback)"},
    "tune_cache_stale": {"kind": "point", "module": "tune/cache.py",
                         "desc": "entry rejected: jax/schema/env mismatch"},
    # IR lint (heat3d lint --ir)
    "ir_lint_start": {"kind": "point", "module": "analysis/ir/__init__.py",
                      "desc": "IR verifier opened: families, judged-"
                              "matrix case count, device posture"},
    "ir_lint_verdict": {"kind": "point", "module": "analysis/ir/__init__.py",
                        "desc": "IR verifier verdict: per-severity "
                                "finding counts per family set"},
    # kernel lint (heat3d lint --kernel)
    "kernel_lint_start": {"kind": "point",
                          "module": "analysis/kernel/__init__.py",
                          "desc": "kernel verifier opened: families, "
                                  "judged-kernel case count, device "
                                  "posture"},
    "kernel_lint_verdict": {"kind": "point",
                            "module": "analysis/kernel/__init__.py",
                            "desc": "kernel verifier verdict: per-"
                                    "severity finding counts per family "
                                    "set"},
    # serving (batched scenario engine)
    "serve_submit": {"kind": "point", "module": "serve/queue.py",
                     "desc": "scenario request enqueued (request_id, depth)"},
    "serve_batch_start": {"kind": "point", "module": "serve/queue.py",
                          "desc": "packed batch about to execute (members, "
                                  "padded size, request ids, bucket)"},
    "serve_batch": {"kind": "span", "module": "serve/queue.py",
                    "desc": "one packed batch's execution bracket"},
    "serve_result": {"kind": "point", "module": "serve/queue.py",
                     "desc": "one request delivered (queue latency)"},
    "serve_metrics_summary": {"kind": "point",
                              "module": "serve/queue.py, serve/engine/",
                              "desc": "drain-final per-bucket latency "
                                      "p50/p95/max + depth high-water "
                                      "mark (the SLO layer's source)"},
    # async serving engine (serve/engine/) + AOT cache (serve/aot.py)
    "serve_dispatch": {"kind": "point", "module": "serve/engine/core.py",
                       "desc": "dispatcher handed a packed chunk to a "
                               "bucket worker (request ids, in-flight "
                               "count at dispatch)"},
    "serve_requeue": {"kind": "point", "module": "serve/engine/core.py",
                      "desc": "backend-loss batch requeued with backoff "
                              "instead of failed (bucket, request ids, "
                              "attempt, backoff seconds) — opens the "
                              "degraded window the SLO serve_degraded "
                              "objective budgets"},
    "serve_batch_ready": {"kind": "point", "module": "serve/engine/core.py",
                          "desc": "a batch's device futures resolved in "
                                  "its worker (execute seconds; the "
                                  "dispatch->ready gap is the overlap "
                                  "window)"},
    "aot_cache_hit": {"kind": "point", "module": "serve/aot.py",
                      "desc": "serialized executables loaded — no trace, "
                              "no compile (measured load_s)"},
    "aot_cache_miss": {"kind": "point", "module": "serve/aot.py",
                       "desc": "no AOT store entry for this bucket key — "
                               "compiling fresh"},
    "aot_cache_stale": {"kind": "point", "module": "serve/aot.py",
                        "desc": "store entry unusable (jax/platform/"
                                "device drift, torn payload — reason "
                                "field); recompile fallback"},
    "aot_export": {"kind": "point", "module": "serve/aot.py",
                   "desc": "compiled executables serialized into the AOT "
                           "store (key, programs, bytes)"},
    "compile_stall": {"kind": "point", "module": "serve/aot.py",
                      "desc": "trace+compile stall actually paid for a "
                              "serving bucket (measured seconds; absent "
                              "on a warm AOT hit — the cold-start "
                              "acceptance signal)"},
    # sustained-traffic soak (serve/loadgen.py) + overload control
    "serve_shed": {"kind": "point",
                   "module": "serve/queue.py, serve/engine/core.py",
                   "desc": "a submission rejected by admission control "
                           "(reason depth|stream_cap, per-stream "
                           "occupancy) — shed traffic is accounted, "
                           "never silent"},
    "serve_admission": {"kind": "point", "module": "serve/engine/core.py",
                        "desc": "first submission admitted on a new "
                                "stream (its admission cap + the global "
                                "depth cap)"},
    "worker_scale": {"kind": "point", "module": "serve/engine/core.py",
                     "desc": "execution-slot count moved with load "
                             "(direction, slots from/to, backlog, last "
                             "batch-execute seconds)"},
    "aot_prewarm": {"kind": "point", "module": "serve/engine/core.py",
                    "desc": "an executable built/loaded ahead of traffic "
                            "(bucket, padded size, forecast members, "
                            "build seconds)"},
    "loadgen_start": {"kind": "point", "module": "serve/loadgen.py",
                      "desc": "soak replay begins: seed, duration, "
                              "arrival count, streams"},
    "soak_verdict": {"kind": "point", "module": "serve/loadgen.py",
                     "desc": "machine-checked soak outcome: accounting "
                             "(admitted + shed == submitted), order, "
                             "post-warmup compile stalls, sustained "
                             "member-Gcell/s, degraded seconds"},
    # request tracing + live monitoring (obs/burn.py, serve/loadgen.py)
    "serve_span": {"kind": "point", "module": "serve/queue.py",
                   "desc": "one phase of a request's trace (trace_id, "
                           "span queue|pack|compute|deliver|requeue_gap "
                           "under parent 'request'), written at delivery "
                           "with explicit t0_wall/t1_wall — a POINT "
                           "event, not a ledger span: per-request "
                           "windows from worker threads interleave and "
                           "would break laminar nesting"},
    "monitor_start": {"kind": "point", "module": "serve/loadgen.py",
                      "desc": "live SLO monitor attached to the soak "
                              "(fast/slow window seconds, burn "
                              "threshold, tick interval, abort flag, "
                              "objective names)"},
    "slo_burn_alert": {"kind": "point", "module": "serve/loadgen.py",
                       "desc": "an objective entered alerting: burn >= "
                               "threshold on BOTH sliding windows "
                               "(rising edge only — one event per "
                               "excursion, not per tick)"},
    "monitor_summary": {"kind": "point", "module": "serve/loadgen.py",
                        "desc": "monitor final state at soak end: alert "
                                "count, aborted flag, final verdict "
                                "from the shared SLO core (test-pinned "
                                "equal to post-hoc obs slo on the same "
                                "ledger)"},
}

# Events of the shared vocabulary that only the JAX package emits:
# registered so the ledger lint reads the JAX package's ledgers, documented
# in the port's taxonomy table, and exempt from the taxonomy checker's
# "emitted somewhere in the port" leg. The IR tier has no counterpart (the
# port builds no traced programs); the port's warm-up writes no executable
# (aot_export); its plans belong to their solver, with no process-wide plan
# cache keyed by plan key (exchange_plan_built, plan_cache_hit,
# fused_rdma_dispatch: the JAX package's plan_for events).
REFERENCE_EVENTS = frozenset({
    "ir_lint_start", "ir_lint_verdict", "aot_export",
    "exchange_plan_built", "plan_cache_hit", "fused_rdma_dispatch",
})

# Wrapper functions whose first argument is an event name (the taxonomy
# checker treats `_event_once("tune_cache_miss", ...)` like
# `.event("tune_cache_miss", ...)`); `_write` carries (name, kind).
EVENT_WRAPPERS = ("_event_once",)


# ---- HEAT3D_* registry -------------------------------------------------------
# name -> {kind: env|define, module: primary reader (under
# heat3d_tpu_torch/), desc}. The taxonomy checker scans heat3d_tpu_torch/
# and chip_smoke.py for HEAT3D_* tokens and fails on any not registered
# here; heat3d_tpu_torch/docs/OBSERVABILITY.md must carry every row.

ENV_VARS: Dict[str, Dict[str, str]] = {
    "HEAT3D_LEDGER": {"kind": "env", "module": "obs/ledger.py",
                      "desc": "run-ledger path (--ledger fallback)"},
    "HEAT3D_LEDGER_MAX_MB": {"kind": "env", "module": "obs/ledger.py",
                             "desc": "size-capped ledger rollover past this "
                                     "many MB (unset/0 = never; fail-soft)"},
    "HEAT3D_METRICS": {"kind": "env", "module": "obs/metrics.py",
                       "desc": "metrics snapshot path (.prom = textfile)"},
    "HEAT3D_PEAK_MEM_GBPS": {"kind": "env", "module": "obs/perf/roofline.py",
                             "desc": "memory-rate override of the cost model"},
    "HEAT3D_PEAK_GFLOPS": {"kind": "env", "module": "obs/perf/roofline.py",
                           "desc": "fp32-rate override of the cost model"},
    "HEAT3D_CKPT_VERIFY": {"kind": "env", "module": "utils/checkpoint.py",
                           "desc": "0 skips shard CRC verification on load"},
    "HEAT3D_COMM_PROBE": {"kind": "env", "module": "obs/comm/probe.py",
                          "desc": "1 times each halo link alone after "
                                  "bench_halo rows (comm_probe events)"},
    "HEAT3D_COMM_PROBE_ITERS": {"kind": "env", "module": "obs/comm/probe.py",
                                "desc": "timed samples per probed link "
                                        "(default 5)"},
    "HEAT3D_PROBE_TIMEOUT": {"kind": "env", "module": "utils/backendprobe.py",
                             "desc": "backend-probe child budget seconds "
                                     "(default 60)"},
    "HEAT3D_COORDINATOR": {"kind": "env", "module": "parallel/distributed.py",
                           "desc": "process-group address HOST:PORT "
                                   "(--coordinator fallback)"},
    "HEAT3D_NUM_PROCESSES": {"kind": "env", "module": "parallel/distributed.py",
                             "desc": "process count (--num-processes "
                                     "fallback)"},
    "HEAT3D_PROCESS_ID": {"kind": "env", "module": "parallel/distributed.py",
                          "desc": "this process's rank (--process-id "
                                  "fallback)"},
    "HEAT3D_AUTO_DISTRIBUTED": {"kind": "env", "module": "parallel/distributed.py",
                                "desc": "1 = torchrun's env:// rendezvous"},
    "HEAT3D_DIST_TIMEOUT_S": {"kind": "env", "module": "parallel/distributed.py",
                              "desc": "bound of every collective and of a "
                                      "cross-process device wait, seconds "
                                      "(default 300)"},
    "HEAT3D_WIRE": {"kind": "env", "module": "parallel/wire.py",
                    "desc": "faces between processes: auto | peer (CUDA "
                            "IPC on one host) | host (gloo, host-staged)"},
    "HEAT3D_FACTOR_7PT": {"kind": "env", "module": "ops/stencil_stream.py",
                          "desc": "0 disables 7pt x-reflection factoring "
                                  "(1 forces the generic instance)"},
    "HEAT3D_FACTOR_Y": {"kind": "env", "module": "ops/stencil_stream.py",
                        "desc": "0 disables y-reflection factoring (27pt "
                                "then takes the generic instance)"},
    "HEAT3D_MEHRSTELLEN": {"kind": "env", "module": "ops/stencil_direct.py",
                           "desc": "1 takes the Mehrstellen q-ring instance "
                                   "of the direct kernels (27pt)"},
    "HEAT3D_CHAIN_7PT": {"kind": "define", "module": "ops/stencil_stream.py",
                         "desc": "nvcc -D string literal: the 7pt "
                                 "compile-time tap chain (CHAINS)"},
    "HEAT3D_CHAIN_27PT": {"kind": "define", "module": "ops/stencil_stream.py",
                          "desc": "nvcc -D string literal: the 27pt "
                                  "compile-time tap chain (CHAINS)"},
    "HEAT3D_NO_DIRECT": {"kind": "env", "module": "parallel/step.py",
                         "desc": "1 puts tb 1/2 on the exchange path"},
    "HEAT3D_EQN_LEGACY": {"kind": "env", "module": "eqn/__init__.py",
                          "desc": "1 routes the heat family through the "
                                  "pre-spec tap derivation (parity arm)"},
    "HEAT3D_NO_PLAN": {"kind": "env", "module": "parallel/plan.py",
                       "desc": "1 bypasses the exchange-plan layer "
                               "(partitioned runs monolithic)"},
    "HEAT3D_FUSED_RDMA": {"kind": "env", "module": "parallel/step.py",
                          "desc": "overrides the fused_rdma knob: 1/on "
                                  "forces the fused RDMA route, anything "
                                  "else stands it down"},
    "HEAT3D_PLAN_PART_MIN_BYTES": {"kind": "env", "module": "parallel/plan.py",
                                   "desc": "partition floor in bytes "
                                           "(default 1 MiB; 0 = genuine "
                                           "sub-blocks)"},
    "HEAT3D_DIRECT_INTERPRET": {"kind": "env", "module": "resilience/sweepstate.py",
                                "desc": "the JAX package's interpreter knob, "
                                        "kept in a sweep row's identity; "
                                        "no effect on the port"},
    "HEAT3D_DIRECT_FORCE": {"kind": "env", "module": "resilience/sweepstate.py",
                            "desc": "the JAX package's compile-only knob, "
                                    "kept in a sweep row's identity; no "
                                    "effect on the port"},
    "HEAT3D_FAULTS": {"kind": "env", "module": "resilience/faults.py",
                      "desc": "deterministic fault-injection plan"},
    "HEAT3D_FAULT_STATE": {"kind": "env", "module": "resilience/faults.py",
                           "desc": "fault-injection state file (fire-once)"},
    "HEAT3D_HEAL_MODE": {"kind": "env", "module": "resilience/elastic.py",
                         "desc": "supervised heal mode default "
                                 "(wait|elastic|auto)"},
    "HEAT3D_HEAL_DEADLINE_S": {"kind": "env", "module": "resilience/elastic.py",
                               "desc": "heal-wait deadline seconds "
                                       "(default 1800)"},
    "HEAT3D_CG_MAX_ITERS": {"kind": "env", "module": "timeint/cg.py",
                            "desc": "implicit-cg trips per solve (default "
                                    "64, always run, keep-masked)"},
    "HEAT3D_CG_TOL": {"kind": "env", "module": "timeint/cg.py",
                      "desc": "implicit-cg relative-residual stop "
                              "(default 1e-6)"},
    "HEAT3D_TUNE_CACHE": {"kind": "env", "module": "tune/cache.py",
                          "desc": "tuning-store path"},
    "HEAT3D_TUNE_DISABLE": {"kind": "env", "module": "tune/cache.py",
                            "desc": "1 skips store lookup (the search "
                                    "driver sets it)"},
    "HEAT3D_SERVE_QUEUE": {"kind": "env", "module": "serve/queue.py",
                           "desc": "pending-request depth cap (default "
                                   "1024)"},
    "HEAT3D_SERVE_MAX_BATCH": {"kind": "env", "module": "serve/queue.py",
                               "desc": "members per packed batch cap "
                                       "(default 64)"},
    "HEAT3D_SERVE_MAX_PER_STREAM": {"kind": "env", "module": "serve/engine/core.py",
                                    "desc": "per-stream open-request cap "
                                            "(default: the depth cap)"},
    "HEAT3D_SERVE_WORKERS": {"kind": "env", "module": "serve/engine/core.py",
                             "desc": "async engine bucket workers "
                                     "(default 2)"},
    "HEAT3D_LOADGEN_SEED": {"kind": "env", "module": "serve/loadgen.py",
                            "desc": "default soak schedule seed (the "
                                    "spec's seed wins)"},
    "HEAT3D_AOT_CACHE": {"kind": "env", "module": "serve/aot.py",
                         "desc": "the JAX executable-store directory; the "
                                 "port keys its in-process warm-up on it "
                                 "and writes nothing there"},
    "HEAT3D_SLO_SPEC": {"kind": "env", "module": "obs/perf/slo.py",
                        "desc": "SLO spec path (obs slo / serve --slo "
                                "default)"},
    "HEAT3D_SLO_WARN_RATIO": {"kind": "env", "module": "obs/perf/slo.py",
                              "desc": "warn at this fraction of an SLO "
                                      "ceiling (default 0.9)"},
    "HEAT3D_BURN_FAST_S": {"kind": "env", "module": "obs/burn.py",
                           "desc": "burn-rate fast window seconds "
                                   "(default 60)"},
    "HEAT3D_BURN_SLOW_S": {"kind": "env", "module": "obs/burn.py",
                           "desc": "burn-rate slow window seconds "
                                   "(default 300)"},
    "HEAT3D_BURN_THRESHOLD": {"kind": "env", "module": "obs/burn.py",
                              "desc": "burn multiple both windows must "
                                      "reach to alert (default 1.0)"},
    "HEAT3D_KERNEL_LINT_TIMEOUT_S": {"kind": "env",
                                     "module": "analysis/kernel/sanitize.py",
                                     "desc": "bound of one sanitizer child, "
                                             "seconds (default 600)"},
}


# ---- fail-soft contract ------------------------------------------------------
# The telemetry functions production code calls unconditionally; the
# posture (docs/OBSERVABILITY.md "Failure posture") is that none of them
# can propagate an environmental failure (IO, serialization) into the run
# it observes. Module path -> qualnames under contract.

FAIL_SOFT_CONTRACT: Dict[str, tuple] = {
    "heat3d_tpu_torch/obs/ledger.py": (
        "activate",
        "get",
        "deactivate",
        "Ledger.event",
        "Ledger.span",
        "Ledger.set_context",
        "Ledger.close",
        "NullLedger.event",
        "NullLedger.span",
    ),
    "heat3d_tpu_torch/obs/metrics.py": (
        "export_at_exit",
    ),
    "heat3d_tpu_torch/obs/trace.py": (
        "named_phase",
        "annotate",
    ),
    "heat3d_tpu_torch/obs/perf/profiling.py": (
        "profile_capture",
        "_ProfileCapture.__enter__",
        "_ProfileCapture.__exit__",
    ),
    "heat3d_tpu_torch/obs/perf/slo.py": (
        "record_verdict",
    ),
}

# Modules whose functions participate in fail-soft call-graph resolution
# (the contract functions may call helpers here; risk propagates through).
FAIL_SOFT_MODULES = tuple(FAIL_SOFT_CONTRACT)
