"""The request queue: scenario submissions -> shape-bucketed batches ->
streamed per-member results.

Port of ``heat3d_tpu.serve.queue``. Many small independent requests share
ONE batched loop per shape bucket: ``submit()`` enqueues a scenario;
``drain()`` packs compatible pending requests (same
:func:`~heat3d_tpu_torch.serve.scenario.solver_bucket_key`) into batches,
pads each batch up to a power-of-two member count (so a bucket's solver,
with its exchange plans, is reused by ANY request count, not just repeats
of one), and executes them through cached :class:`~heat3d_tpu_torch.serve
.ensemble.EnsembleSolver` instances. Results stream back in SUBMISSION
order.

Observability: every submission lands a ``serve_submit`` ledger event,
every executed batch a ``serve_batch_start`` point + a ``serve_batch``
span, every delivered result a ``serve_result`` event with the
request's queue latency; the metrics registry carries queue depth,
batch-size and per-request latency histograms (bucket-labelled). Every
``drain()`` additionally closes with ONE ``serve_metrics_summary``
event — per-bucket latency p50/p95/max plus the depth high-water mark —
so post-hoc SLO evaluation (``heat3d obs slo``; obs/perf/slo.py) works
from the ledger alone, never the live registry. Knobs:
``HEAT3D_SERVE_QUEUE`` caps the pending depth (submit raises when
full), ``HEAT3D_SERVE_MAX_BATCH`` caps members per packed batch.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

import torch

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.obs.metrics import HISTOGRAM_SAMPLE_CAP
from heat3d_tpu_torch.serve.ensemble import EnsembleSolver
from heat3d_tpu_torch.serve.scenario import (
    Scenario,
    ScenarioBatch,
    request_bucket_key,
)
from heat3d_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_QUEUE_DEPTH = "HEAT3D_SERVE_QUEUE"
ENV_MAX_BATCH = "HEAT3D_SERVE_MAX_BATCH"
DEFAULT_QUEUE_DEPTH = 1024
DEFAULT_MAX_BATCH = 64


class Backpressure(RuntimeError):
    """Typed admission-control rejection (docs/SERVING.md "Load,
    overload & soak"): submit() refused a request, and the exception
    carries the occupancy state a caller needs to ACT — back off, shed
    to another replica, retry after deliveries — instead of parsing a
    message. Subclasses RuntimeError so pre-existing submit() error
    handling keeps working unchanged.

    ``depth``/``max_depth`` are the global occupancy and cap at the
    rejection; ``stream``/``stream_depth``/``stream_cap`` identify a
    PER-STREAM rejection (``stream_cap`` is None when the global depth
    cap rejected); ``per_stream`` maps every live stream tag to the
    requests it still holds open — the whole point: the caller can see
    WHO is occupying the queue, not just that it is full.
    """

    def __init__(
        self,
        message: str,
        *,
        depth: int,
        max_depth: int,
        stream: Optional[str] = None,
        stream_depth: Optional[int] = None,
        stream_cap: Optional[int] = None,
        per_stream: Optional[Dict[str, int]] = None,
    ):
        super().__init__(message)
        self.depth = depth
        self.max_depth = max_depth
        self.stream = stream
        self.stream_depth = stream_depth
        self.stream_cap = stream_cap
        self.per_stream = dict(per_stream or {})


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
        return v if v > 0 else default
    except ValueError:
        return default


def _pad_pow2(n: int, cap: int) -> int:
    """The bucketed batch size: the next power of two >= n, capped. One
    solver per (shape bucket, padded size) then serves every request count
    up to the cap."""
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


def _padded_size(n: int, cap: int, batch_mesh: int) -> int:
    """The executed batch size for ``n`` live members: pow2-bucketed,
    then rounded up to a multiple of ``batch_mesh`` — the ensemble
    shards members across the batch axis, so a padded size the mesh
    cannot divide would fail EVERY drain of that chunk (the cap may be
    exceeded by the rounding; padding members cost 0 steps)."""
    padded = _pad_pow2(n, cap)
    if padded % batch_mesh:
        padded = -(-padded // batch_mesh) * batch_mesh
    return padded


@dataclasses.dataclass
class ServeResult:
    """One request's streamed result."""

    request_id: int
    field: np.ndarray  # final (nx, ny, nz) member field
    steps: int
    residual_sumsq: Optional[float]
    batch_size: int  # members packed in the executing batch (pre-pad)
    queue_latency_s: float  # submit -> result delivery
    snapshots: Optional[List[np.ndarray]] = None  # per snapshot_every chunk


@dataclasses.dataclass
class _Pending:
    request_id: int
    base: SolverConfig
    scenario: Scenario
    submitted_at: float
    trace: Optional[Dict[str, Any]] = None


def new_trace() -> Dict[str, Any]:
    """Per-request trace context, minted at ``submit()`` (both
    front-ends) and carried on the request through pack, dispatch,
    execution, requeue, and delivery. Milestones are ``time.monotonic``
    (immune to wall steps; one process, so comparable):

    - ``t_submit`` — admission;
    - ``packs`` — each time the request left the queue into a chunk
      (one entry per attempt);
    - ``exec`` — each successful device-execution window ``(t0, t1)``;
    - ``requeues`` — each backend-loss requeue ``{t, attempt,
      backoff_s}``.

    At delivery :func:`build_chunk_results` folds the milestones into
    causally-linked ``serve_span`` ledger events (the queue / pack /
    compute / deliver decomposition ``heat3d obs trace`` prints and the
    timeline's waterfall track renders)."""
    return {
        "id": uuid.uuid4().hex[:12],
        "t_submit": time.monotonic(),
        "packs": [],
        "exec": [],
        "requeues": [],
    }


def _emit_trace_spans(
    trace: Dict[str, Any],
    rid: int,
    bucket: str,
    stream: Optional[str],
    now_mono: float,
) -> None:
    """One request's ``serve_span`` events, written at delivery. These
    are POINT events carrying explicit wall-clock ``t0_wall``/``t1_wall``
    bounds — per-request phases from concurrent bucket workers interleave
    freely, which the ledger's span-nesting lint (correctly) rejects for
    real ``kind=span`` records, so the waterfall gets its own field
    contract instead."""
    # one wall/monotonic offset for the whole request so phases butt
    # exactly (each t_wall = t_mono + offset with the same offset)
    off = time.time() - time.monotonic()

    def phase(name, m0, m1, parent="request", **extra):
        obs.get().event(
            "serve_span",
            trace_id=trace["id"],
            request_id=rid,
            span=name,
            parent=parent,
            bucket=bucket,
            stream=stream,
            t0_wall=round(m0 + off, 6),
            t1_wall=round(m1 + off, 6),
            span_dur_s=round(max(m1 - m0, 0.0), 6),
            **extra,
        )

    t_sub = trace["t_submit"]
    packs = trace["packs"]
    execs = trace["exec"]
    requeues = trace["requeues"]
    phase(
        "request", t_sub, now_mono, parent=None,
        attempts=len(requeues) + 1,
    )
    first_pack = packs[0] if packs else now_mono
    phase("queue", t_sub, first_pack)
    if execs:
        t_ex0, t_ex1 = execs[-1]
        last_pack = packs[-1] if packs else t_ex0
        phase("pack", last_pack, t_ex0)
        phase("compute", t_ex0, t_ex1)
        phase("deliver", t_ex1, now_mono)
    for rq in requeues:
        # the gap a backend loss cost this request: requeue -> the next
        # time it left the queue (or delivery, if it never re-packed)
        t_rq = rq["t"]
        t_next = next((t for t in packs if t > t_rq), now_mono)
        phase(
            "requeue_gap", t_rq, t_next,
            attempt=rq.get("attempt"),
            backoff_s=rq.get("backoff_s"),
        )


def pad_batch(
    base: SolverConfig, members: List[Scenario], padded: int
) -> ScenarioBatch:
    """The executed :class:`ScenarioBatch`: ``members`` plus 0-step dummy
    copies of the first member up to ``padded`` (masked out after the
    first bound computation, never delivered). Shared by the synchronous
    queue and the async engine so both execute the identical program."""
    fill = padded - len(members)
    if fill > 0:
        members = members + [
            dataclasses.replace(members[0], steps=0) for _ in range(fill)
        ]
    return ScenarioBatch(base, members)


def run_packed_batch(
    solver: EnsembleSolver,
    budgets: np.ndarray,
    snapshot_every: int = 0,
    with_residuals: bool = False,
    times: Optional[Dict[str, float]] = None,
):
    """One packed batch's device work — init, (chunked) run, gather,
    optional residual probe — returning ``(fields, residuals,
    snapshots)``. This is THE execution body both the synchronous
    queue and the async engine (serve/engine) drive: byte-identical
    results between the two are a consequence of sharing it, not a
    test-maintained coincidence. ``times``, when given, gains the host
    seconds of the init (``init_s``), of the run to its last update on
    the device (``run_s``; snapshots' gathers included) and of the final
    gather and residual probe (``gather_s``). Each wait is on the streams
    this solver's work ran on (``utils.timing.stream_sync``), never the
    whole card: the async engine's bucket workers run batches side by side
    on streams of their own."""
    from heat3d_tpu_torch.utils.timing import stream_sync

    t0 = time.monotonic()
    u = solver.init_state()
    stream_sync(solver)
    t1 = time.monotonic()
    snapshots: Optional[List[np.ndarray]] = None
    if snapshot_every > 0:
        snapshots = []
        done = np.zeros_like(budgets)
        while (done < budgets).any():
            stride = np.minimum(budgets - done, snapshot_every).astype(
                np.int32
            )
            u = solver.run(u, stride)
            done = done + stride
            snapshots.append(solver.gather(u))
    else:
        u = solver.run(u, budgets)
    stream_sync(solver)
    t2 = time.monotonic()
    # the last snapshot already gathered the final state — don't pay a
    # second full-batch device-to-host transfer for it
    fields = snapshots[-1] if snapshots else solver.gather(u)
    residuals = None
    if with_residuals:
        # the residual costs one probe update per member — a health
        # signal measured FROM the delivered state. Fields are gathered
        # first (the probe donates u), so delivered results stay at
        # exactly the budgeted step either way.
        u, r2 = solver.step_with_member_residuals(u)
        residuals = r2.cpu().numpy()
    if times is not None:
        times.update(init_s=t1 - t0, run_s=t2 - t1, gather_s=time.monotonic() - t2)
    return fields, residuals, snapshots


def build_chunk_results(
    requests: List[Tuple],
    bucket: str,
    budgets: np.ndarray,
    fields,
    residuals,
    snapshots,
    stats: "ServeStats",
    stream: Optional[str] = None,
) -> List[ServeResult]:
    """``(request_id, submitted_at[, trace])`` tuples → delivered
    :class:`ServeResult`s: the per-request latency observation,
    ``serve_result`` ledger event, the request's ``serve_span`` trace
    decomposition (when a trace context rode along), and result assembly
    (snapshot slicing, residual conversion). Shared by the synchronous
    queue and the async engine for the same reason as
    :func:`run_packed_batch` — the delivered payload cannot diverge
    between front-ends if there is only one assembler."""
    out: List[ServeResult] = []
    now = time.monotonic()
    for i, req in enumerate(requests):
        rid, submitted_at = req[0], req[1]
        trace = req[2] if len(req) > 2 else None
        latency = now - submitted_at
        stats.observe_result(bucket, latency)
        obs.get().event(
            "serve_result",
            request_id=rid,
            steps=int(budgets[i]),
            batch_members=len(requests),
            queue_latency_s=round(latency, 6),
            bucket=bucket,
            trace_id=trace["id"] if trace else None,
        )
        if trace is not None:
            _emit_trace_spans(
                trace, rid, bucket, trace.get("stream") or stream, now
            )
        out.append(
            ServeResult(
                request_id=rid,
                field=fields[i],
                steps=int(budgets[i]),
                residual_sumsq=(
                    float(residuals[i]) if residuals is not None else None
                ),
                batch_size=len(requests),
                queue_latency_s=latency,
                snapshots=(
                    [s[i] for s in snapshots]
                    if snapshots is not None
                    else None
                ),
            )
        )
    return out


class ServeStats:
    """Cumulative serve-health tracking shared by the synchronous queue
    and the async engine: per-bucket queue-latency reservoirs (bounded by
    the metrics layer's ``HISTOGRAM_SAMPLE_CAP`` — count/max stay exact
    past it, percentiles note ``clipped``), the pending-depth high-water
    mark, batch/delivery counters, and the live metrics-registry mirrors
    (queue-depth gauge, latency/batch-size histograms). Thread-safe: the
    engine's bucket workers observe concurrently."""

    def __init__(self) -> None:
        import threading

        self._lock = threading.Lock()
        self._bucket_stats: Dict[str, Dict] = {}
        self.depth_max = 0
        self.batches = 0
        self.delivered = 0
        # degraded-mode accounting (the async engine's backend-loss
        # requeue): a requeue opens a degraded window, the requeued chunk
        # resolving closes it; cumulative seconds + the live flag ride the
        # serve_metrics_summary the SLO layer judges (`serve_degraded`
        # objective: degraded-seconds budget)
        self.requeues = 0
        # refcounted: each DISTINCT degraded chunk holds one reference;
        # the window closes only when the last one resolves — chunk A's
        # quick recovery must not stop the clock while chunk B is still
        # backing off
        self._degraded_open = 0
        self._degraded_since: Optional[float] = None
        self._degraded_s_total = 0.0
        self._depth_gauge = obs.REGISTRY.gauge(
            "serve_queue_depth", "pending scenario requests"
        )
        self._latency_hist = obs.REGISTRY.histogram(
            "serve_request_latency_seconds",
            "submit -> result delivery per request",
        )
        self._batch_hist = obs.REGISTRY.histogram(
            "serve_batch_members", "members packed per executed batch"
        )

    def observe_depth(self, depth: int) -> None:
        self._depth_gauge.set(depth)
        with self._lock:
            self.depth_max = max(self.depth_max, depth)

    def observe_batch(self, members: int) -> None:
        self._batch_hist.observe(members)
        with self._lock:
            self.batches += 1

    def observe_result(self, bucket: str, latency_s: float) -> None:
        # bucket-labelled: the SLO layer judges latency PER BUCKET (a
        # big-grid bucket legitimately runs slower than a small one)
        self._latency_hist.observe(latency_s, bucket=bucket)
        with self._lock:
            st = self._bucket_stats.setdefault(
                bucket,
                {"count": 0, "max": 0.0, "samples": [], "clipped": False},
            )
            st["count"] += 1
            st["max"] = max(st["max"], latency_s)
            if len(st["samples"]) < HISTOGRAM_SAMPLE_CAP:
                st["samples"].append(latency_s)
            else:
                st["clipped"] = True
            self.delivered += 1

    def mark_degraded(self, new: bool = True) -> None:
        """A backend-loss requeue happened: count it, and — when this is
        the chunk's FIRST requeue (``new``) — take one reference on the
        degraded window (a chunk re-requeued on a later attempt already
        holds its reference)."""
        with self._lock:
            self.requeues += 1
            if new:
                self._degraded_open += 1
            if self._degraded_since is None:
                self._degraded_since = time.monotonic()
        obs.REGISTRY.counter(
            "serve_requeues_total", "backend-loss batch requeues"
        ).inc()

    def clear_degraded(self) -> None:
        """Drop one degraded-chunk reference — the engine calls this when
        a REQUEUED chunk resolves (success or final failure). The window
        closes (cumulative seconds retained for the SLO budget) only when
        the LAST open chunk resolves."""
        with self._lock:
            if self._degraded_open > 0:
                self._degraded_open -= 1
            if self._degraded_open == 0 and self._degraded_since is not None:
                self._degraded_s_total += (
                    time.monotonic() - self._degraded_since
                )
                self._degraded_since = None

    def degraded_seconds(self) -> float:
        with self._lock:
            live = (
                0.0
                if self._degraded_since is None
                else time.monotonic() - self._degraded_since
            )
            return self._degraded_s_total + live

    def summary(self, pending: int) -> Dict[str, object]:
        """The ``serve_metrics_summary`` payload: per-bucket latency
        count/p50/p95/max, depth high-water mark, batch/delivery
        counters — the dict the SLO layer evaluates (obs/perf/slo.py),
        identical in shape whichever front-end produced it."""
        from heat3d_tpu_torch.obs.metrics import percentile

        with self._lock:
            live_degraded = self._degraded_since is not None
            degraded_s = self._degraded_s_total + (
                0.0
                if self._degraded_since is None
                else time.monotonic() - self._degraded_since
            )
            buckets = {}
            for bucket, st in sorted(self._bucket_stats.items()):
                rec = {
                    "count": st["count"],
                    "p50_s": round(percentile(st["samples"], 50), 6),
                    "p95_s": round(percentile(st["samples"], 95), 6),
                    "max_s": round(st["max"], 6),
                }
                if st["clipped"]:
                    # percentiles cover the stored reservoir only, never
                    # to be mistaken for exact (count/max stay exact)
                    rec["clipped"] = True
                buckets[bucket] = rec
            return {
                "buckets": buckets,
                "depth_max": self.depth_max,
                "batches": self.batches,
                "delivered": self.delivered,
                "pending": pending,
                # degraded-mode serving provenance: ALWAYS present (0.0
                # on a healthy drain) so the SLO serve_degraded
                # objective reads a value, never no_data, from any
                # summary this code produced
                "degraded": live_degraded,
                "degraded_s": round(degraded_s, 6),
                "requeues": self.requeues,
            }


class ScenarioQueue:
    """Submit scenarios, drain shape-bucketed batches, stream results.

    Single-controller, synchronous: ``drain()`` executes everything
    pending and yields results. The reuse lives in ``self._solvers`` — an
    :class:`EnsembleSolver` (traced binding: coefficients are tensors) per
    (bucket key, padded batch size, batch mesh), its exchange plans kept,
    its coefficient tensors rebound for each batch. ``device`` places the
    solvers' shards (the solver's ``device=``: ``cpu`` for the tests).
    """

    def __init__(
        self,
        max_batch: Optional[int] = None,
        max_depth: Optional[int] = None,
        batch_mesh: int = 1,
        snapshot_every: int = 0,
        with_residuals: bool = False,
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
        self._pending: "OrderedDict[int, _Pending]" = OrderedDict()
        self._next_id = 0
        self._solvers: Dict[Tuple, EnsembleSolver] = {}
        # cumulative per-bucket latency stats + queue-depth high-water
        # mark: the drain-final serve_metrics_summary event reports these
        # so post-hoc SLO evaluation (obs/perf/slo.py) never needs the
        # live registry (ServeStats — shared with the async engine so the
        # SLO layer judges both front-ends from one summary shape).
        self._stats = ServeStats()

    # ---- submission -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def _bucket_stats(self) -> Dict[str, Dict]:
        # introspection view of the shared stats (tests assert the
        # reservoir bound here)
        return self._stats._bucket_stats

    def submit(self, base: SolverConfig, scenario: Scenario) -> int:
        """Enqueue one scenario over structural config ``base``; returns
        the request id results are keyed by. Raises :class:`Backpressure`
        (a RuntimeError carrying the occupancy) when the queue is at
        ``HEAT3D_SERVE_QUEUE`` depth — backpressure must be explicit AND
        actionable; a silently unbounded queue is how a service dies,
        and a bare depth error gives the caller nothing to act on. The
        rejection also lands a ``serve_shed`` ledger event so shed
        traffic is accounted, never invisible."""
        if len(self._pending) >= self.max_depth:
            obs.get().event(
                "serve_shed",
                stream=None,
                reason="depth",
                depth=len(self._pending),
                max_depth=self.max_depth,
            )
            raise Backpressure(
                f"serve queue full ({self.max_depth} pending; "
                f"{ENV_QUEUE_DEPTH} raises the cap) — drain before "
                "submitting more",
                depth=len(self._pending),
                max_depth=self.max_depth,
                per_stream={"": len(self._pending)},
            )
        if scenario.steps is None:
            # materialize the budget NOW: num_steps is not part of the
            # structural bucket key (budgets are traced inputs), so a
            # default-budget scenario packed with requests from another
            # base must not silently inherit that base's step count
            scenario = dataclasses.replace(
                scenario, steps=base.run.num_steps
            )
        rid = self._next_id
        self._next_id += 1
        trace = new_trace()
        self._pending[rid] = _Pending(
            request_id=rid,
            base=base,
            scenario=scenario,
            submitted_at=trace["t_submit"],
            trace=trace,
        )
        self._stats.observe_depth(len(self._pending))
        obs.get().event(
            "serve_submit",
            request_id=rid,
            trace_id=trace["id"],
            grid=list(base.grid.shape),
            stencil=base.stencil.kind,
            steps=scenario.steps,  # materialized above — never None here
            queue_depth=len(self._pending),
        )
        return rid

    # ---- batching ---------------------------------------------------------

    def _buckets(self) -> "OrderedDict[Tuple, List[_Pending]]":
        out: "OrderedDict[Tuple, List[_Pending]]" = OrderedDict()
        for p in self._pending.values():
            # the request-level key: a scenario stating its own
            # integrator (or carrying a coefficient field) must never
            # share a batch with the base's plain explicit sweep
            out.setdefault(request_bucket_key(p.base, p.scenario), []).append(p)
        return out

    def _solver_for(
        self, batch: ScenarioBatch, padded: int
    ) -> EnsembleSolver:
        key = (batch.bucket_key(), padded, self.batch_mesh)
        solver = self._solvers.get(key)
        if solver is None:
            solver = EnsembleSolver(
                batch, batch_mesh=self.batch_mesh, bind="traced",
                device=self.device,
            )
            self._solvers[key] = solver
        else:
            # same structure, new member values: rebind the coefficient
            # tensors; the exchange plans (keyed on shapes only — the
            # traced binding's whole point) are reused as-is
            solver.batch = batch
            solver._build_coefficients()
        return solver

    # ---- execution --------------------------------------------------------

    def drain(self) -> Iterator[ServeResult]:
        """Execute everything pending, yielding results in SUBMISSION
        order (requests are only delivered once every batch of this drain
        has executed — ordering beats latency at this layer; callers that
        want per-batch streaming use :meth:`serve_batches`)."""
        results: Dict[int, ServeResult] = {}
        order = list(self._pending.keys())
        err: Optional[BaseException] = None
        try:
            for batch_results in self.serve_batches():
                for r in batch_results:
                    results[r.request_id] = r
        except Exception as e:  # noqa: BLE001 - deliver, then surface
            # one bucket failing (e.g. its config can't build) must not
            # destroy the batches that already executed: stream what
            # landed, then re-raise. The failed bucket's requests are
            # still pending (they pop only on successful execution), so
            # a caller can fix the config and drain again.
            err = e
        for rid in order:
            if rid in results:
                yield results[rid]
        # drain-final summary (even on a partial drain — the batches that
        # executed are real): per-bucket p50/p95/max queue latency and the
        # depth high-water mark, as one ledger event, so SLO evaluation
        # works from the ledger alone (docs/SERVING.md "SLOs")
        obs.get().event("serve_metrics_summary", **self.metrics_summary())
        if err is not None:
            raise err

    def metrics_summary(self) -> Dict[str, object]:
        """Cumulative serve health over this queue's lifetime: per-bucket
        queue-latency count/p50/p95/max, the pending-depth high-water
        mark, and batch/delivery counters — the dict the drain-final
        ``serve_metrics_summary`` ledger event carries and ``heat3d serve
        --slo`` evaluates live (obs/perf/slo.py)."""
        return self._stats.summary(pending=len(self._pending))

    def serve_batches(self) -> Iterator[List[ServeResult]]:
        """Pack and execute pending requests bucket by bucket, yielding
        each executed batch's results as they land."""
        for bucket_key_, group in self._buckets().items():
            while group:
                chunk = group[: self.max_batch]
                group = group[len(chunk):]
                yield self._execute(chunk)

    def _execute(self, chunk: List[_Pending]) -> List[ServeResult]:
        base = chunk[0].base
        t_pack = time.monotonic()
        for p in chunk:
            if p.trace is not None:
                p.trace["packs"].append(t_pack)
        members = [p.scenario for p in chunk]
        padded = _padded_size(len(members), self.max_batch, self.batch_mesh)
        batch = pad_batch(base, members, padded)
        solver = self._solver_for(batch, padded)
        self._stats.observe_batch(len(chunk))
        bucket_s = str(batch.bucket_key())
        obs.get().event(
            "serve_batch_start",
            members=len(chunk),
            padded=padded,
            request_ids=[p.request_id for p in chunk],
            bucket=bucket_s,
            mesh=list(solver.cfg.mesh.shape),
            batch_mesh=solver.batch_mesh,
            time_blocking=solver.cfg.time_blocking,
        )
        budgets = np.asarray(
            [batch.member_steps(m) for m in range(len(batch))], np.int32
        )
        on_card = solver.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(solver.device)
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
            # the live members' cell updates (padding members run 0 steps)
            # and, on the card, the batch's peak device memory: the
            # per-bucket throughput and memory readouts
            span.add(
                **{k: round(v, 6) for k, v in times.items()},
                steps_total=int(budgets.sum()),
                bucket=bucket_s,
                cell_updates=int(budgets.sum()) * solver.cfg.grid.num_cells,
                **({"device_peak_bytes": torch.cuda.max_memory_allocated(solver.device)}
                   if on_card else {}),
            )
        t_ex1 = time.monotonic()

        for p in chunk:
            self._pending.pop(p.request_id, None)
            if p.trace is not None:
                p.trace["exec"].append((t_ex0, t_ex1))
        out = build_chunk_results(
            [(p.request_id, p.submitted_at, p.trace) for p in chunk],
            bucket_s, budgets, fields, residuals, snapshots, self._stats,
        )
        self._stats.observe_depth(len(self._pending))
        return out
