"""The canonical ledger-event registry the ledger lint consumes.

A copy of ``LEDGER_EVENTS`` from the JAX package's
``analysis/registry.py``: every event/span name either package may emit,
with its kind, so one ledger lint (``obs check --taxonomy``) holds both
packages' ledgers to one vocabulary. The ledger data lint flags unknown
names in actual ledger files against it, and a registered kind that
disagrees with the record's. The source checkers of that module (the
environment-knob and fail-soft registries) are not ported.
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
