"""The continuously-batching async serving engine.

Port of ``heat3d_tpu.serve.engine.core``: the same admission control,
packing, scaling, prewarm, delivery order, requeue and ledger events.
The port's differences: each bucket worker launches on CUDA streams of
its own (one per card it uses), so buckets run side by side on the card
and a worker's waits (``utils.timing.stream_sync``, the gather's copy)
cover its own work only; a bucket's warm-up is the eager ensemble's
first-use pass (``serve/aot.py``), not a compiled executable; and
:func:`is_backend_loss` reads torch's CUDA errors where JAX reads
jaxlib's. Eager launches hold the GIL, so small launch-bound members
overlap little across workers.

``ScenarioQueue`` (serve/queue.py) is submit-then-drain: ``drain()``
holds the caller while every batch executes, and nothing can be
submitted meanwhile — correct for certification, wrong for a service.
This engine is the always-on posture the ROADMAP's "millions of users"
axis needs (the GPU-aware-async-tasks paper's thesis: the scaling win is
overlapping dispatch with in-flight work):

- :meth:`AsyncServeEngine.submit` is thread-safe, returns immediately,
  and applies explicit ADMISSION CONTROL (docs/SERVING.md "Load,
  overload & soak"): the global ``HEAT3D_SERVE_QUEUE`` outstanding-
  request cap bounds engine memory, and a per-stream cap
  (``HEAT3D_SERVE_MAX_PER_STREAM``) bounds what any one stream/tenant
  may hold open — a rejected submission raises a typed
  :class:`~heat3d_tpu_torch.serve.queue.Backpressure` carrying the per-stream
  occupancy and lands a ``serve_shed`` ledger event, so shed traffic is
  accounted, never silent. Packing interleaves streams round-robin
  within each bucket, so a flooding stream can neither wedge the queue
  against nor monopolize batch slots over a well-behaved one;
- a **dispatcher thread** packs whatever is pending into shape-bucketed
  chunks (the queue's own bucketing/padding helpers) and hands each to
  its bucket's worker the moment that worker is free — continuous
  batching: requests arriving while a batch flies ride the NEXT batch,
  not a global barrier;
- **per-bucket worker threads** own their bucket's ensembles (warmed
  through serve/aot.py at first touch, so the first request of a bucket
  does not pay its first-use stall), execute one batch at a time on their
  own streams, and wait for that batch alone (``gather``) without
  stalling submission or other buckets. Total concurrent batches are capped by
  ``HEAT3D_SERVE_WORKERS`` execution slots — and the slot count SCALES
  with load: the dispatcher grows it toward ``max_workers`` when the
  pending backlog (sized in batches, weighted by the last measured
  batch-execute time) outruns the current slots, and shrinks back to
  the configured base when the queue drains, each move a
  ``worker_scale`` ledger event;
- **predictive AOT pre-warm**: the engine keeps a per-bucket arrival
  history; :meth:`AsyncServeEngine.prewarm_forecast` (the load
  generator calls it between arrivals) forecasts each hot bucket's
  near-term batch size and warms that batch size on the bucket's own
  worker thread BEFORE traffic needs it (``aot_prewarm`` events —
  the soak's zero-``compile_stall``-after-warmup criterion);
- **delivery preserves submission order per request stream** (the
  ``stream`` tag at submit): within a stream, results yield strictly in
  submit order; across streams, a slow stream never blocks a fast one;
- a failed bucket (bad config, uncompilable route) fails ONLY its own
  requests — every other bucket's in-flight and future results still
  deliver, and the failures are surfaced explicitly
  (:attr:`AsyncServeEngine.failures`, and :meth:`drain` re-raises after
  streaming what landed — the queue's contract);
- **backend-loss failures are requeued, not failed** (serve-tier
  elastic degradation, docs/SERVING.md "Degraded-mode serving"):
  :func:`is_backend_loss` classifies a batch failure as device-runtime
  loss vs scenario error; a loss puts the chunk's requests back in the
  pending set IN ORDER, drops the worker's cached ensembles (the
  rebuild allocates afresh; its warm-up is an in-process store hit, no
  second stall), backs off through the shared
  :class:`~heat3d_tpu_torch.resilience.retry.RetryPolicy` schedule, and
  opens the ``degraded`` window on :class:`ServeStats` (``degraded_s``
  in ``serve_metrics_summary`` — the budget the SLO layer's
  ``serve_degraded`` objective judges). Retries exhausted (or losses
  during shutdown run-down) fail the chunk exactly as before;
- :meth:`shutdown` is graceful: stop accepting, run down every
  dispatched batch, join the workers, close with ONE
  ``serve_metrics_summary`` event (the SLO layer's source, same shape
  as the queue's).

Ledger: ``serve_submit`` / ``serve_batch_start`` / ``serve_batch`` span /
``serve_result`` / ``serve_metrics_summary`` exactly as the queue emits
them, plus the engine's own ``serve_dispatch`` (dispatcher handed a
packed chunk to a worker) and ``serve_batch_ready`` (a batch's device
futures resolved — the dispatch→ready gap is the overlap window the
timeline shows) and the serve/aot.py events.
"""

from __future__ import annotations

import dataclasses
import queue as stdqueue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import contextlib

import numpy as np
import torch

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.serve.ensemble import EnsembleSolver
from heat3d_tpu_torch.serve.queue import (
    DEFAULT_MAX_BATCH,
    DEFAULT_QUEUE_DEPTH,
    ENV_MAX_BATCH,
    ENV_QUEUE_DEPTH,
    Backpressure,
    ServeResult,
    ServeStats,
    _env_int,
    _padded_size,
    build_chunk_results,
    new_trace,
    pad_batch,
    run_packed_batch,
)
from heat3d_tpu_torch.serve.scenario import (
    Scenario,
    request_bucket_key,
    solver_bucket_key,
)
from heat3d_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_WORKERS = "HEAT3D_SERVE_WORKERS"
ENV_MAX_PER_STREAM = "HEAT3D_SERVE_MAX_PER_STREAM"
DEFAULT_WORKERS = 2
# worker-slot scaling: how far past the configured base the dispatcher
# may grow the execution slots, and the predicted-backlog-drain seconds
# above which the latency leg adds a slot beyond the pure depth need
DEFAULT_MAX_WORKERS_FACTOR = 4
SCALE_LATENCY_S = 2.0
# per-bucket arrival history (predictive prewarm): timestamps retained
ARRIVAL_HISTORY_CAP = 256

# Backend-loss requeue backoff (the ONE RetryPolicy implementation —
# resilience/retry.py): attempts-capped, no deadline — a service must
# bound retries per chunk, and the dispatcher owns global liveness.
DEFAULT_REQUEUE_POLICY_KW = dict(
    max_attempts=4, base_delay_s=0.5, multiplier=2.0, max_delay_s=10.0
)


def is_backend_loss(exc: BaseException) -> bool:
    """Device-runtime loss (requeue) vs scenario error (fail).

    Injected faults (:class:`~heat3d_tpu_torch.resilience.faults.InjectedFault`)
    and the CUDA runtime speaking (``torch.AcceleratorError``; and
    ``torch.OutOfMemoryError``, the counterpart of XLA's
    RESOURCE_EXHAUSTED) classify as loss; Python-level config/validation
    errors (ValueError, TypeError, a plain RuntimeError, ...) stay
    scenario errors and fail the chunk immediately — retrying a bad
    config forever would hide the bug behind backoff. A sticky CUDA error
    leaves the process's context dead: every retry fails the same way,
    the attempts run out and the chunk fails, which is the right
    outcome — the engine cannot heal a context it does not own."""
    from heat3d_tpu_torch.resilience.faults import InjectedFault

    if isinstance(exc, InjectedFault):
        return True
    losses = tuple(
        t for t in (getattr(torch, "AcceleratorError", None),
                    getattr(torch, "OutOfMemoryError", None))
        if isinstance(t, type)
    )
    return bool(losses) and isinstance(exc, losses)

# request lifecycle states
_PENDING = "pending"
_DISPATCHED = "dispatched"
_DONE = "done"
_FAILED = "failed"
_CANCELLED = "cancelled"


@dataclasses.dataclass
class _Tracked:
    request_id: int
    base: SolverConfig
    scenario: Scenario
    stream: str
    submitted_at: float
    state: str = _PENDING
    result: Optional[ServeResult] = None
    error: Optional[str] = None
    # backend-loss requeue count: the chunk fails for real once the
    # shared RetryPolicy's attempt cap is reached
    attempts: int = 0
    # per-request trace context (serve/queue.new_trace): the trace_id
    # survives requeues because the _Tracked object does
    trace: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class _Prewarm:
    """A predictive warm-up work item: build (and warm) the bucket's
    ensemble for ``padded`` members on the bucket's OWN worker thread,
    before traffic needs it. ``done`` lets a warmup phase wait for the
    build without polling."""

    base: SolverConfig
    padded: int
    forecast_members: int
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )


class _BucketWorker(threading.Thread):
    """One bucket's executor: owns the bucket's solver cache (and its
    warm-up) and runs one packed batch at a time off its own queue, on
    CUDA streams of its own (:meth:`streams`). ``None`` is the shutdown
    sentinel; a :class:`_Prewarm` item builds and warms a solver without
    serving anything."""

    def __init__(self, engine: "AsyncServeEngine", bucket: str):
        super().__init__(name=f"heat3d-serve-{bucket[:24]}", daemon=True)
        self.engine = engine
        self.bucket = bucket
        self.q: "stdqueue.Queue[Any]" = stdqueue.Queue()
        self.solvers: Dict[Tuple, EnsembleSolver] = {}
        # device -> this worker's stream on it (made at first use)
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self.start()

    def streams(self, base: SolverConfig) -> contextlib.ExitStack:
        """The context a batch of ``base``'s bucket runs in: this
        worker's own stream made current on each card the bucket's
        shards use (the ensemble places them as ``mesh_devices`` does).
        Everything inside — build, warm-up, init, run, gather, residual
        probe — launches there, so other buckets' batches neither wait
        for it nor hold it up; a one-shard mesh launches on the current
        stream, a mesh of several forks and joins its shard streams off
        it. Nothing on the CPU."""
        from heat3d_tpu_torch.parallel.topology import mesh_devices

        stack = contextlib.ExitStack()
        n = self.engine.batch_mesh * base.mesh.num_devices
        for d in dict.fromkeys(mesh_devices(n, self.engine.device)):
            if d.type != "cuda":
                continue
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            st = self._streams.get(d)
            if st is None:
                st = self._streams[d] = torch.cuda.Stream(device=d)
            stack.enter_context(torch.cuda.stream(st))
        return stack

    def run(self) -> None:
        while True:
            chunk = self.q.get()
            if chunk is None:
                return
            if isinstance(chunk, _Prewarm):
                self.engine._do_prewarm(self, chunk)
                continue
            # the global execution-slot cap (HEAT3D_SERVE_WORKERS): more
            # buckets than slots queue here rather than oversubscribing
            # the device
            with self.engine._slots:
                try:
                    self.engine._run_batch(self, chunk)
                except BaseException as e:  # noqa: BLE001 - a worker
                    # must never die silently: fail its chunk, keep
                    # serving later batches (a transient error must not
                    # wedge the bucket forever)
                    self.engine._fail_chunk(chunk, e)
            with self.engine._cond:
                self.engine._busy.discard(self.bucket)
                self.engine._cond.notify_all()

    def solver_for(self, batch, padded: int) -> EnsembleSolver:
        """The bucket's solver for ``padded`` members, bound to ``batch``:
        built and warmed (``serve/aot.py``) at first use, then reused with
        the batch's coefficients rebound. Call inside :meth:`streams`."""
        key = (batch.bucket_key(), padded, self.engine.batch_mesh)
        solver = self.solvers.get(key)
        if solver is None:
            t0 = time.monotonic()
            solver = EnsembleSolver(
                batch, batch_mesh=self.engine.batch_mesh, bind="traced",
                device=self.engine.device,
            )
            if self.engine._aot:
                from heat3d_tpu_torch.serve import aot

                report = aot.warm(solver, self.engine._aot_dir,
                                  build_s=time.monotonic() - t0)
                self.engine._note_aot(report)
            self.solvers[key] = solver
        else:
            # same structure, new member values: rebind coefficients;
            # the plans (and the warm-up they had) are reused
            solver.batch = batch
            solver._build_coefficients()
        return solver


class AsyncServeEngine:
    """Submit scenarios from any thread; batches execute continuously.

    Usage::

        with AsyncServeEngine(batch_mesh=1) as eng:
            rid = eng.submit(base, Scenario(alpha=0.5), stream="tenant-a")
            ...                       # keep submitting — batches fly now
            for r in eng.results():   # per-stream submission order
                handle(r)
        # __exit__ -> shutdown(): graceful run-down + serve_metrics_summary

    ``before_execute`` is an instrumentation hook called in the worker
    thread immediately before a batch's device work ``(bucket,
    request_ids)`` — tests pin the submit-while-in-flight overlap with
    it; production leaves it None. ``device`` places every bucket's
    shards as the ensemble's ``device=`` does (``cpu`` for the tests;
    default the card).
    """

    def __init__(
        self,
        max_batch: Optional[int] = None,
        max_depth: Optional[int] = None,
        batch_mesh: int = 1,
        workers: Optional[int] = None,
        max_per_stream: Optional[int] = None,
        max_workers: Optional[int] = None,
        snapshot_every: int = 0,
        with_residuals: bool = False,
        aot: Optional[bool] = None,
        aot_dir: Optional[str] = None,
        before_execute: Optional[Callable[[str, List[int]], None]] = None,
        autostart: bool = True,
        retry_policy=None,
        faults=None,
        device=None,
    ):
        self.device = device
        self.max_batch = max_batch or _env_int(ENV_MAX_BATCH, DEFAULT_MAX_BATCH)
        self.max_depth = max_depth or _env_int(
            ENV_QUEUE_DEPTH, DEFAULT_QUEUE_DEPTH
        )
        self.batch_mesh = batch_mesh
        self.snapshot_every = snapshot_every
        self.with_residuals = with_residuals
        self.workers = workers or _env_int(ENV_WORKERS, DEFAULT_WORKERS)
        # per-stream admission cap: defaults to the global depth cap, so
        # a single-stream caller sees EXACTLY the old behavior; soak /
        # multi-tenant deployments set it lower to stop one stream from
        # consuming the whole queue
        self.max_per_stream = (
            max_per_stream
            or _env_int(ENV_MAX_PER_STREAM, 0)
            or self.max_depth
        )
        # worker-slot scaling bounds: the semaphore starts at the
        # configured base and the dispatcher moves it in
        # [base, max_workers] as backlog demands
        self.base_workers = self.workers
        self.max_workers = max_workers or (
            self.workers * DEFAULT_MAX_WORKERS_FACTOR
        )
        self.scale_latency_s = SCALE_LATENCY_S
        self._aot_dir = aot_dir
        # aot=None: enabled (serve/aot.py decides remember-vs-measure-only
        # from HEAT3D_AOT_CACHE — an env-disabled store still warms with
        # the stall measured, just remembers nothing). aot=False: no
        # warm-up — the debugging escape where the first request pays the
        # first-use stall, unmeasured.
        self._aot = True if aot is None else bool(aot)
        self.before_execute = before_execute
        # backend-loss requeue: the shared RetryPolicy supplies the
        # attempt cap + backoff schedule (tests inject a millisecond
        # policy); the fault plan supplies the deterministic serve-tier
        # injection point (partial-device-loss:batch=N)
        from heat3d_tpu_torch.resilience.faults import FaultPlan
        from heat3d_tpu_torch.resilience.retry import RetryPolicy

        self._retry = retry_policy or RetryPolicy(
            **DEFAULT_REQUEUE_POLICY_KW
        )
        self._faults = faults if faults is not None else FaultPlan.from_env()
        self._batch_seq = 0

        self._cond = threading.Condition()
        self._req: Dict[int, _Tracked] = {}
        # open = everything the engine still holds memory for — pending,
        # in flight, AND completed-but-undelivered results (each of those
        # is a gathered full-grid field). Maintained incrementally (an
        # always-on service must not scan its request history per
        # submit), decremented only at delivery/failure/cancel, so the
        # HEAT3D_SERVE_QUEUE cap bounds engine memory even when the
        # results() consumer is slower than batch throughput.
        self._open = 0
        self._next_id = 0
        self._streams: Dict[str, List[int]] = {}
        # admission-control bookkeeping: per-stream open counts (the cap
        # the Backpressure error reports), shed totals, and the streams
        # whose serve_admission event already landed
        self._stream_open: Dict[str, int] = {}
        self._stream_shed: Dict[str, int] = {}
        self._shed = 0
        self._admission_noted: set = set()
        # predictive-prewarm state: per-bucket arrival timestamps (the
        # forecast input), a representative base config per bucket (to
        # build the dummy warm batch), and the (bucket, padded) sizes
        # already warm — whether by prewarm or by live traffic
        self._arrival_history: Dict[str, List[float]] = {}
        self._bucket_base: Dict[str, SolverConfig] = {}
        self._prewarmed: set = set()
        self._workers: Dict[str, _BucketWorker] = {}
        self._busy: set = set()
        self._slots = threading.Semaphore(self.workers)
        self._slot_count = self.workers
        self._scale_events = 0
        self._last_execute_s = 0.0
        self._stop = False
        self._joined = False
        self._stats = ServeStats()
        self.failures: List[Dict[str, Any]] = []
        self._unraised_failures: List[Dict[str, Any]] = []
        self._summary_dirty = False
        # overlap/in-flight accounting (stats() + the acceptance tests)
        self._in_flight = 0
        self._max_in_flight = 0
        self._accepted_in_flight = 0
        self._cancelled = 0
        self._aot_stats = {
            "hits": 0, "misses": 0, "stale": 0, "disabled": 0,
            "exports": 0, "stalls": 0,
            "compile_stall_s": 0.0, "load_s": 0.0,
        }
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="heat3d-serve-dispatch",
            daemon=True,
        )
        self._started = False
        # autostart=False defers dispatching until start() (or the first
        # results()/drain()/shutdown() call): a caller enqueueing an
        # initial burst gets one optimally-packed batch per bucket
        # instead of a timing-dependent split — which also makes the
        # batch composition (and therefore the AOT store's padded-size
        # keys) deterministic for a fixed request set.
        if autostart:
            self.start()

    def start(self) -> None:
        """Begin dispatching (idempotent; no-op after autostart)."""
        with self._cond:
            if self._started:
                return
            self._started = True
        self._dispatcher.start()

    # ---- context manager ---------------------------------------------------

    def __enter__(self) -> "AsyncServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.shutdown(wait=exc_type is None)
        return False

    # ---- submission --------------------------------------------------------

    def __len__(self) -> int:
        with self._cond:
            return self._open

    def submit(
        self,
        base: SolverConfig,
        scenario: Scenario,
        stream: str = "",
    ) -> int:
        """Enqueue one scenario; returns the request id. Thread-safe and
        non-blocking: batches already in flight keep flying. Raises a
        typed :class:`~heat3d_tpu_torch.serve.queue.Backpressure` (carrying
        per-stream occupancy, with a ``serve_shed`` ledger event) when
        the engine holds ``HEAT3D_SERVE_QUEUE`` requests (pending +
        in-flight + completed-but-undelivered — the cap bounds engine
        MEMORY, so a slow results() consumer backpressures submitters)
        or when this ``stream`` already holds
        ``HEAT3D_SERVE_MAX_PER_STREAM`` open requests — and a plain
        RuntimeError after :meth:`shutdown`."""
        if scenario.steps is None:
            # materialize the budget at SUBMIT time (the queue's rule):
            # budgets are traced inputs, not bucket structure, so a
            # default-budget scenario must not inherit another base's
            # step count at packing time
            scenario = dataclasses.replace(scenario, steps=base.run.num_steps)
        shed: Optional[Backpressure] = None
        shed_reason = ""
        first_on_stream = False
        with self._cond:
            if self._stop:
                raise RuntimeError(
                    "engine is shut down — no further submissions"
                )
            s_open = self._stream_open.get(stream, 0)
            if self._open >= self.max_depth:
                shed_reason = "depth"
                shed = Backpressure(
                    f"serve queue full ({self.max_depth} outstanding; "
                    f"{ENV_QUEUE_DEPTH} raises the cap) — wait for "
                    "deliveries before submitting more",
                    depth=self._open, max_depth=self.max_depth,
                    stream=stream, stream_depth=s_open,
                    stream_cap=self.max_per_stream,
                    per_stream=dict(self._stream_open),
                )
            elif s_open >= self.max_per_stream:
                shed_reason = "stream_cap"
                shed = Backpressure(
                    f"stream {stream or '(default)'} at its admission "
                    f"cap ({s_open} open; {ENV_MAX_PER_STREAM} raises "
                    "it) — other streams keep flowing",
                    depth=self._open, max_depth=self.max_depth,
                    stream=stream, stream_depth=s_open,
                    stream_cap=self.max_per_stream,
                    per_stream=dict(self._stream_open),
                )
            if shed is not None:
                # shed accounting: the rejection is explicit state, not
                # just an exception — admitted + shed == submitted is
                # the soak's conservation law
                self._shed += 1
                self._stream_shed[stream] = (
                    self._stream_shed.get(stream, 0) + 1
                )
            else:
                rid = self._next_id
                self._next_id += 1
                self._open += 1
                self._stream_open[stream] = s_open + 1
                first_on_stream = stream not in self._admission_noted
                self._admission_noted.add(stream)
                trace = new_trace()
                trace["stream"] = stream or None
                self._req[rid] = _Tracked(
                    request_id=rid,
                    base=base,
                    scenario=scenario,
                    stream=stream,
                    submitted_at=trace["t_submit"],
                    trace=trace,
                )
                self._streams.setdefault(stream, []).append(rid)
                bucket = str(request_bucket_key(base, scenario))
                self._bucket_base.setdefault(bucket, base)
                hist = self._arrival_history.setdefault(bucket, [])
                hist.append(time.monotonic())
                if len(hist) > ARRIVAL_HISTORY_CAP:
                    del hist[: len(hist) - ARRIVAL_HISTORY_CAP]
                if self._in_flight > 0:
                    # the overlap the engine exists for: this submission
                    # was accepted while a batch executed (test-pinned)
                    self._accepted_in_flight += 1
                depth = self._open
            self._cond.notify_all()
        if shed is not None:
            obs.get().event(
                "serve_shed",
                stream=stream or None,
                reason=shed_reason,
                depth=shed.depth,
                max_depth=shed.max_depth,
                stream_depth=shed.stream_depth,
                stream_cap=shed.stream_cap,
                per_stream={
                    (k or "(default)"): v for k, v in shed.per_stream.items()
                },
            )
            raise shed
        if first_on_stream:
            obs.get().event(
                "serve_admission",
                stream=stream or None,
                stream_cap=self.max_per_stream,
                max_depth=self.max_depth,
            )
        self._stats.observe_depth(depth)
        obs.get().event(
            "serve_submit",
            request_id=rid,
            trace_id=trace["id"],
            grid=list(base.grid.shape),
            stencil=base.stencil.kind,
            steps=scenario.steps,
            queue_depth=depth,
            stream=stream or None,
            in_flight=self._in_flight,
        )
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a not-yet-dispatched request. True when cancelled;
        False when unknown, already dispatched (in flight — results are
        coming), or already resolved. Cancelled requests never deliver
        and never count as failures."""
        with self._cond:
            r = self._req.get(rid)
            if r is None or r.state != _PENDING:
                return False
            r.state = _CANCELLED
            self._cancelled += 1
            self._open -= 1
            self._release_stream(r.stream)
            self._cond.notify_all()
            return True

    def _release_stream(self, stream: str) -> None:
        """Under the lock: one open request on ``stream`` left the
        engine (delivered, failed, or cancelled) — free its admission
        slot."""
        n = self._stream_open.get(stream, 0) - 1
        if n > 0:
            self._stream_open[stream] = n
        else:
            self._stream_open.pop(stream, None)

    # ---- the dispatcher loop ----------------------------------------------

    def _undispatched(self) -> List[_Tracked]:
        return [r for r in self._req.values() if r.state == _PENDING]

    def _pack(self) -> List[Tuple[_BucketWorker, List[_Tracked]]]:
        """Under the lock: one chunk per idle-bucket. Within a bucket,
        streams share batch slots ROUND-ROBIN (each stream's own
        requests stay in submission order — delivery order needs that),
        so a flooding stream cannot monopolize a batch over a
        well-behaved one. A single stream degenerates to exactly the
        old take-the-first-``max_batch`` packing, which keeps batch
        composition — and the AOT store's padded-size keys —
        deterministic for the single-stream acceptance runs."""
        by_bucket: Dict[str, List[_Tracked]] = {}
        for r in self._undispatched():
            # request-level key: integrator/coef-field requests must
            # never pack with the plain sweep of the same base
            by_bucket.setdefault(
                str(request_bucket_key(r.base, r.scenario)), []
            ).append(r)
        out: List[Tuple[_BucketWorker, List[_Tracked]]] = []
        for bucket, reqs in by_bucket.items():
            if bucket in self._busy:
                # continuous batching: this bucket's worker is flying a
                # batch; everything pending for it packs the NEXT one
                continue
            worker = self._workers.get(bucket)
            if worker is None:
                worker = _BucketWorker(self, bucket)
                self._workers[bucket] = worker
            lanes: Dict[str, List[_Tracked]] = {}
            for r in reqs:  # reqs are in submission order already
                lanes.setdefault(r.stream, []).append(r)
            chunk: List[_Tracked] = []
            while len(chunk) < self.max_batch and lanes:
                for stream in list(lanes):
                    chunk.append(lanes[stream].pop(0))
                    if not lanes[stream]:
                        del lanes[stream]
                    if len(chunk) >= self.max_batch:
                        break
            t_pack = time.monotonic()
            for r in chunk:
                r.state = _DISPATCHED
                if r.trace is not None:
                    r.trace["packs"].append(t_pack)
            self._busy.add(bucket)
            out.append((worker, chunk))
        return out

    def _maybe_scale(self) -> Optional[Dict[str, Any]]:
        """Under the lock: move the execution-slot count toward what the
        backlog needs — grow toward ``max_workers`` when more batches
        are waiting than slots can fly (the latency leg adds one more
        when the predicted drain time, backlog-batches x the last
        measured execute time, exceeds ``scale_latency_s``), shrink back
        to the configured base once the queue is empty and nothing
        flies. Returns the ``worker_scale`` event payload (emitted by
        the caller OUTSIDE the lock) or None when the count stands."""
        backlog = sum(1 for r in self._req.values() if r.state == _PENDING)
        need = -(-backlog // self.max_batch) if backlog else 0  # ceil
        if (
            backlog
            and self._last_execute_s > 0
            and need * self._last_execute_s > self.scale_latency_s
        ):
            need += 1
        desired = min(self.max_workers, max(self.base_workers, need))
        if backlog == 0 and self._in_flight == 0:
            desired = self.base_workers
        elif desired < self._slot_count:
            # never shrink while loaded: reclaiming a slot can only block
            # on an acquire the backlog is about to need
            return None
        if desired == self._slot_count:
            return None
        before = self._slot_count
        if desired > self._slot_count:
            for _ in range(desired - self._slot_count):
                self._slots.release()
            self._slot_count = desired
        else:
            # reclaim only idle slots (non-blocking): a slot held by an
            # in-flight batch is returned by its worker and reclaimed on
            # a later pass
            while self._slot_count > desired and self._slots.acquire(
                blocking=False
            ):
                self._slot_count -= 1
            if self._slot_count == before:
                return None
        self._scale_events += 1
        return {
            "direction": "up" if self._slot_count > before else "down",
            "slots_from": before,
            "slots_to": self._slot_count,
            "backlog": backlog,
            "last_execute_s": round(self._last_execute_s, 6),
        }

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    scale = self._maybe_scale()
                    assignments = self._pack()
                    if assignments or scale:
                        break
                    if self._stop and not self._undispatched():
                        return
                    self._cond.wait()
            if scale:
                obs.get().event("worker_scale", **scale)
            for worker, chunk in assignments:
                obs.get().event(
                    "serve_dispatch",
                    bucket=worker.bucket,
                    members=len(chunk),
                    request_ids=[r.request_id for r in chunk],
                    in_flight=self._in_flight,
                )
                worker.q.put(chunk)

    # ---- batch execution (worker threads) ---------------------------------

    def _run_batch(self, worker: _BucketWorker, chunk: List[_Tracked]) -> None:
        with self._cond:
            self._in_flight += 1
            self._max_in_flight = max(self._max_in_flight, self._in_flight)
            batch_seq = self._batch_seq
            self._batch_seq += 1
        try:
            with worker.streams(chunk[0].base):
                results = self._execute(worker, chunk, batch_seq)
        except BaseException as e:  # noqa: BLE001 - fail THIS chunk only
            if self._maybe_requeue(worker, chunk, e):
                return
            self._fail_chunk(chunk, e)
            return
        finally:
            with self._cond:
                self._in_flight -= 1
        # a REQUEUED chunk finally succeeding closes the degraded window
        # (cumulative seconds retained for the SLO budget). Other
        # buckets' healthy batches don't: while a lost chunk is still
        # backing off, the service IS degraded, and letting unaffected
        # traffic close the window would undercount the very budget the
        # serve_degraded objective meters.
        if any(r.attempts for r in chunk):
            self._stats.clear_degraded()
        with self._cond:
            for r, res in zip(chunk, results):
                r.result = res
                r.state = _DONE
            self._summary_dirty = True
            self._cond.notify_all()
        self._stats.observe_depth(len(self))

    def _execute(self, worker: _BucketWorker, chunk: List[_Tracked],
                 batch_seq: int) -> List[ServeResult]:
        """One chunk's batch on the worker's streams: build/reuse the
        solver, execute, assemble the results (the queue's
        ``run_packed_batch`` and ``build_chunk_results``)."""
        base = chunk[0].base
        members = [r.scenario for r in chunk]
        padded = _padded_size(len(members), self.max_batch, self.batch_mesh)
        batch = pad_batch(base, members, padded)
        solver = worker.solver_for(batch, padded)
        self._stats.observe_batch(len(chunk))
        bucket_s = str(batch.bucket_key())
        obs.get().event(
            "serve_batch_start",
            members=len(chunk),
            padded=padded,
            request_ids=[r.request_id for r in chunk],
            bucket=bucket_s,
            mesh=list(solver.cfg.mesh.shape),
            batch_mesh=solver.batch_mesh,
            time_blocking=solver.cfg.time_blocking,
        )
        budgets = np.asarray(
            [batch.member_steps(m) for m in range(len(batch))], np.int32
        )
        if self.before_execute is not None:
            self.before_execute(bucket_s, [r.request_id for r in chunk])
        # the serve-tier fault-injection point: a declared
        # partial-device-loss:batch=N fires here, lands in the caller's
        # except, classifies as backend loss, and requeues — exactly the
        # path a real mid-batch device loss takes
        self._faults.on_serve_batch(batch_seq)
        t_ex0 = time.monotonic()
        times: Dict[str, float] = {}
        with obs.get().span(
            "serve_batch", members=len(chunk), padded=padded
        ) as span:
            fields, residuals, snapshots = run_packed_batch(
                solver, budgets,
                snapshot_every=self.snapshot_every,
                with_residuals=self.with_residuals,
                times=times,
            )
            # the queue's per-batch readouts (the live members' cell
            # updates; init/run/gather seconds on this worker's streams)
            span.add(
                **{k: round(v, 6) for k, v in times.items()},
                steps_total=int(budgets.sum()),
                bucket=bucket_s,
                cell_updates=int(budgets.sum()) * solver.cfg.grid.num_cells,
            )
        # the batch this worker held just landed on the host — the
        # dispatch->ready window is where submission overlapped
        obs.get().event(
            "serve_batch_ready",
            bucket=bucket_s,
            members=len(chunk),
            execute_s=round(span.dur_s or 0.0, 6),
            in_flight=self._in_flight,
        )
        with self._cond:
            # the scaling signal: how long the LAST batch took to
            # execute weights the backlog into a drain-time estimate
            self._last_execute_s = span.dur_s or 0.0
            # live traffic built this solver: the padded size is warm
            # now — prewarm must not rebuild it
            self._prewarmed.add((bucket_s, padded))
        t_ex1 = time.monotonic()
        for r in chunk:
            if r.trace is not None:
                r.trace["exec"].append((t_ex0, t_ex1))
        return build_chunk_results(
            [(r.request_id, r.submitted_at, r.trace) for r in chunk],
            bucket_s, budgets, fields, residuals, snapshots, self._stats,
        )

    def _maybe_requeue(
        self, worker: _BucketWorker, chunk: List[_Tracked], exc: BaseException
    ) -> bool:
        """Backend-loss triage for a failed batch: requeue the chunk with
        backoff (True) or let it fail (False — scenario errors, retries
        exhausted, or shutdown run-down, where retry-forever would hang
        the join)."""
        if not is_backend_loss(exc):
            return False
        attempt = max(r.attempts for r in chunk) + 1
        cap = self._retry.max_attempts or 1
        if attempt >= cap:
            log.warning(
                "serve batch lost its backend %d time(s); retries "
                "exhausted — failing the chunk", attempt,
            )
            return False
        delay = self._retry.delay_for(attempt)
        t_rq = time.monotonic()
        with self._cond:
            if self._stop:
                return False
            for r in chunk:
                r.state = _PENDING
                r.attempts = attempt
                if r.trace is not None:
                    r.trace["requeues"].append(
                        {"t": t_rq, "attempt": attempt, "backoff_s": delay}
                    )
        # rebuild, don't reuse: the cached ensembles hold plans and
        # tensors allocated before the loss; dropping them makes the next
        # dispatch rebuild on whatever devices NOW answer (the warm-up
        # keys carry the device count; the same key is an in-process
        # store hit, so the rebuild pays no second stall)
        worker.solvers.clear()
        # attempt 1 = this chunk's first loss: it takes its own reference
        # on the degraded window (refcounted — another chunk recovering
        # must not stop the clock while this one still backs off)
        self._stats.mark_degraded(new=attempt == 1)
        obs.get().event(
            "serve_requeue",
            bucket=worker.bucket,
            request_ids=[r.request_id for r in chunk],
            attempt=attempt,
            backoff_s=round(delay, 6),
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        log.warning(
            "serve batch backend loss (%s request(s), attempt %d): "
            "requeued with %.2fs backoff",
            len(chunk), attempt, delay,
        )
        # backoff INSIDE the worker thread, while the bucket is still
        # marked busy: the dispatcher cannot re-dispatch this bucket
        # until the worker frees it, so the sleep IS the backoff —
        # submission and other buckets keep flowing meanwhile
        if delay > 0:
            time.sleep(delay)
        with self._cond:
            self._cond.notify_all()
        return True

    def _fail_chunk(self, chunk: List[_Tracked], exc: BaseException) -> None:
        err = f"{type(exc).__name__}: {str(exc)[:300]}"
        log.warning("serve batch failed (%s request(s)): %s", len(chunk), err)
        if any(r.attempts for r in chunk):
            # a requeued chunk finally failing RESOLVES its degraded
            # window (seconds retained for the SLO budget): the requests
            # are failed, not pending — leaving the clock running would
            # count every healthy hour after this failure as degraded
            self._stats.clear_degraded()
        with self._cond:
            for r in chunk:
                if r.state in (_DONE, _FAILED):
                    continue
                r.state = _FAILED
                r.error = err
                self._open -= 1
                self._release_stream(r.stream)
                rec = {
                    "request_id": r.request_id,
                    "stream": r.stream,
                    "error": err,
                }
                self.failures.append(rec)
                self._unraised_failures.append(rec)
            self._summary_dirty = True
            self._cond.notify_all()

    def _note_aot(self, report: Dict[str, Any]) -> None:
        with self._cond:
            st = self._aot_stats
            outcome = report.get("outcome")
            if outcome == "hit":
                st["hits"] += 1
            elif outcome == "miss":
                st["misses"] += 1
            elif outcome == "stale":
                st["stale"] += 1
            elif outcome == "disabled":
                st["disabled"] += 1
            if report.get("exported"):
                st["exports"] += 1
            if report.get("compile_stall_s"):
                st["stalls"] += 1
                st["compile_stall_s"] += float(report["compile_stall_s"])
            if report.get("load_s"):
                st["load_s"] += float(report["load_s"])

    # ---- predictive AOT pre-warm -------------------------------------------

    def _do_prewarm(self, worker: _BucketWorker, item: _Prewarm) -> None:
        """In the worker thread, on its streams: build (and warm) the
        solver for ``item.padded`` members with a dummy member batch. The
        solver cache key is member-INDEPENDENT (bucket, padded,
        batch_mesh), so the first real request of that shape rebinds
        coefficients on the prewarmed solver. Fail-soft: a prewarm
        failure only costs the prediction — live traffic still builds on
        demand."""
        t0 = time.monotonic()
        try:
            dummy = [
                Scenario(steps=item.base.run.num_steps)
            ] * min(item.forecast_members, item.padded)
            batch = pad_batch(item.base, dummy, item.padded)
            with worker.streams(item.base):
                worker.solver_for(batch, item.padded)
            obs.get().event(
                "aot_prewarm",
                bucket=worker.bucket,
                padded=item.padded,
                forecast_members=item.forecast_members,
                seconds=round(time.monotonic() - t0, 6),
            )
        except BaseException as e:  # noqa: BLE001 - prediction only
            log.warning(
                "prewarm failed for bucket %s padded=%d: %s",
                worker.bucket, item.padded, e,
            )
            with self._cond:
                self._prewarmed.discard((worker.bucket, item.padded))
        finally:
            item.done.set()

    def prewarm(
        self,
        base: SolverConfig,
        expected_members: int = 1,
        forecast: Optional[int] = None,
    ) -> Optional[threading.Event]:
        """Queue a warm-up of ``base``'s bucket for ``expected_members``
        (padded to the batch size traffic of that count would use)
        on the bucket's own worker. Returns an Event that sets when the
        build finishes, or None when that (bucket, padded) is already
        warm. Thread-safe; never blocks on the build itself."""
        bucket = str(solver_bucket_key(base))
        padded = _padded_size(
            max(1, expected_members), self.max_batch, self.batch_mesh
        )
        with self._cond:
            if self._stop:
                return None
            key = (bucket, padded)
            if key in self._prewarmed:
                return None
            self._prewarmed.add(key)
            worker = self._workers.get(bucket)
            if worker is None:
                worker = _BucketWorker(self, bucket)
                self._workers[bucket] = worker
        item = _Prewarm(
            base=base, padded=padded,
            forecast_members=forecast or expected_members,
        )
        worker.q.put(item)
        return item.done

    def prewarm_forecast(
        self,
        horizon_s: float = 5.0,
        window_s: float = 30.0,
        max_buckets: int = 4,
    ) -> List[threading.Event]:
        """Forecast each hot bucket's near-term batch size from its
        arrival history (arrivals in the trailing ``window_s``, scaled
        to ``horizon_s``) and queue prewarms for the batch sizes that
        forecast implies. The load generator calls this between
        arrivals; each build emits ``aot_prewarm``. Returns the pending
        build Events (already-warm forecasts return nothing)."""
        now = time.monotonic()
        plans: List[Tuple[SolverConfig, int]] = []
        with self._cond:
            rates = []
            for bucket, hist in self._arrival_history.items():
                recent = [t for t in hist if now - t <= window_s]
                if not recent:
                    continue
                rates.append((len(recent), bucket))
            rates.sort(reverse=True)
            for n, bucket in rates[:max_buckets]:
                base = self._bucket_base.get(bucket)
                if base is None:
                    continue
                expect = max(1, int(n * horizon_s / window_s))
                plans.append((base, min(expect, self.max_batch)))
        events = []
        for base, expect in plans:
            ev = self.prewarm(base, expected_members=expect, forecast=expect)
            if ev is not None:
                events.append(ev)
        return events

    # ---- delivery ----------------------------------------------------------

    def _pop_next(self) -> Optional[ServeResult]:
        """Under the lock: the single NEXT deliverable result across
        streams (submission order within each stream; FAILED/CANCELLED
        requests are skipped — they surface via :attr:`failures` /
        :meth:`drain` and never block the stream behind them), pruning
        the consumed prefix as it goes. One at a time BY DESIGN: a
        result leaves the engine's bookkeeping only at the moment it is
        handed to the consumer, so an abandoned ``results()`` iterator
        cannot strand already-popped results — and the prune keeps an
        always-on engine from retaining every request it ever served
        (each _Tracked holds the scenario, possibly a full-grid init
        array; each DONE result a gathered field)."""
        for stream, rids in list(self._streams.items()):
            i = 0
            res: Optional[ServeResult] = None
            while i < len(rids):
                r = self._req[rids[i]]
                if r.state in (_FAILED, _CANCELLED):
                    i += 1
                    continue
                if r.state == _DONE:
                    res = r.result
                    self._open -= 1
                    self._release_stream(stream)
                    i += 1
                break
            if i:
                for rid in rids[:i]:
                    self._req.pop(rid, None)
                del rids[:i]
            if not rids:
                # a drained stream tag must not live forever: per-tenant
                # stream names would otherwise leak one entry each and
                # put every delivery at O(streams ever seen)
                del self._streams[stream]
            if res is not None:
                return res
        return None

    def _outstanding(self) -> bool:
        return any(
            r.state in (_PENDING, _DISPATCHED, _DONE)
            for r in self._req.values()
        )

    def results(self, timeout: Optional[float] = None) -> Iterator[ServeResult]:
        """Yield results as they become deliverable — submission order
        within each stream, streams interleaved by completion. Returns
        when nothing submitted remains undelivered (new submissions
        while iterating extend the iteration). ``timeout`` bounds the
        TOTAL wait; expiry raises ``TimeoutError``."""
        self.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                res = self._pop_next()
                if res is None:
                    if not self._outstanding():
                        return
                    left = (
                        None if deadline is None
                        else deadline - time.monotonic()
                    )
                    if left is not None and left <= 0:
                        raise TimeoutError(
                            f"serve results: {len(self)} request(s) still "
                            f"outstanding after {timeout}s"
                        )
                    self._cond.wait(left)
                    continue
            yield res

    def drain(self, timeout: Optional[float] = None) -> Iterator[ServeResult]:
        """The queue-compatible collector: wait for everything submitted,
        yield it (per-stream submission order), close with ONE
        ``serve_metrics_summary`` event, then — like
        ``ScenarioQueue.drain`` — re-raise if any bucket failed (after
        streaming everything that landed; the failed requests are listed
        in :attr:`failures`). Unlike the queue, submission stays open
        while draining: batches keep executing underneath."""
        yield from self.results(timeout=timeout)
        self._emit_summary()
        with self._cond:
            unraised, self._unraised_failures = self._unraised_failures, []
        if unraised:
            raise RuntimeError(
                f"{len(unraised)} request(s) failed "
                f"(first: request {unraised[0]['request_id']}: "
                f"{unraised[0]['error']}); delivered results already "
                "streamed — failed requests were NOT delivered"
            )

    # ---- summary / stats / shutdown ---------------------------------------

    def metrics_summary(self) -> Dict[str, Any]:
        """The live SLO source (``serve --async --slo``): same shape as
        ``ScenarioQueue.metrics_summary`` — the SLO layer cannot tell
        which front-end produced it."""
        return self._stats.summary(pending=len(self))

    def _emit_summary(self) -> None:
        with self._cond:
            if not self._summary_dirty:
                return
            self._summary_dirty = False
        obs.get().event("serve_metrics_summary", **self.metrics_summary())

    def stats(self) -> Dict[str, Any]:
        """Engine-side counters (the CLI verdict's payload): submission /
        delivery / failure totals, the in-flight high-water mark, how
        many submissions were accepted while batches flew (the overlap
        proof), and the AOT warm-up aggregate."""
        with self._cond:
            return {
                # submitted = every submit() ATTEMPT; admitted + shed ==
                # submitted is the soak verdict's conservation law
                "submitted": self._next_id + self._shed,
                "admitted": self._next_id,
                "shed": self._shed,
                "shed_by_stream": {
                    (k or "(default)"): v
                    for k, v in self._stream_shed.items()
                },
                "delivered": self._stats.delivered,
                "failed": len(self.failures),
                "cancelled": self._cancelled,
                "batches": self._stats.batches,
                "buckets": len(self._workers),
                "workers": self.workers,
                "slots": self._slot_count,
                "scale_events": self._scale_events,
                "prewarmed": len(self._prewarmed),
                "streams": {
                    (k or "(default)"): v
                    for k, v in self._stream_open.items()
                },
                "max_in_flight": self._max_in_flight,
                "accepted_in_flight": self._accepted_in_flight,
                "requeues": self._stats.requeues,
                "degraded_s": round(self._stats.degraded_seconds(), 6),
                "aot": dict(self._aot_stats),
            }

    def shutdown(self, wait: bool = True, cancel_pending: bool = False) -> None:
        """Graceful stop: refuse new submissions, run down everything
        dispatched (and, unless ``cancel_pending``, everything pending),
        join the workers, and close with the drain-final
        ``serve_metrics_summary`` if anything executed since the last
        one. Idempotent. ``wait=False`` abandons pending work (requests
        stay undelivered; in-flight device work still completes in the
        daemon workers but is not waited for)."""
        self.start()  # an unstarted engine still runs down its pending
        with self._cond:
            if self._joined:
                return
            self._stop = True
            if cancel_pending or not wait:
                for r in self._undispatched():
                    r.state = _CANCELLED
                    self._cancelled += 1
                    self._open -= 1
                    self._release_stream(r.stream)
            self._cond.notify_all()
        if wait:
            self._dispatcher.join()
            workers = list(self._workers.values())
            for w in workers:
                w.q.put(None)
            for w in workers:
                w.join()
            with self._cond:
                self._joined = True
        self._emit_summary()
