"""The budgeted search: measure candidates, decide, cache the
winner.

Port of ``heat3d_tpu.tune.measure``. Every trial runs through the port's
``bench.harness.bench_throughput`` (on the search's ``device``: every
shard on it, or shard i on ``cuda:i``), so each measurement is a bench row
with its provenance (routes, ``rtt_dominated``, the cost fields, the
``bench_row`` ledger mirror), and each trial also lands a ``tune_trial``
ledger event with its knob assignment and outcome. Discipline, as in the
JAX package:

- **Kernels built first**: on the card every CUDA library is built
  (``ops._build.build_all``) before the first trial, so no trial's time and
  no probe's domination test includes a compile.
- **Static default first**: the base config is always measured before any
  candidate, whatever the budget — the speedup-vs-default reference must
  exist for the cache entry and the report.
- **Early stopping**: each candidate first runs a short PROBE
  (``probe_steps``, one repeat); a probe clearly dominated by the best
  measurement so far (< ``dominated_frac`` of it) skips the full
  measurement (``tune_trial`` with ``pruned_dominated: true``).
- **Wall-clock budget**: checked between trials; candidates left
  unmeasured when it runs out are recorded (``tune_budget_exhausted``),
  never silently dropped.
- **RTT honesty**: ``rtt_dominated`` trials can never win.
- **Isolation**: ``HEAT3D_TUNE_DISABLE`` is set for the duration of the
  search so an EXISTING cache entry cannot steer the trials that would
  replace it.

A trial that crashes is recorded as ``status: error`` and the search
continues — one broken route must cost one candidate, not the session.

``batch_members`` > 1 searches the ensemble workload instead: every trial
measures a B-member batch through the serving bench
(``serve.bench.bench_ensemble_throughput``), the single-tenant routes are
pruned with their reasons (:func:`_ensemble_incompatible`), and the winner
lands at the ``b2^round(log2 B)`` batch-bucketed key the ensemble's bucket
solvers resolve through.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.tune import cache as tcache
from heat3d_tpu_torch.tune import decide as tdecide
from heat3d_tpu_torch.tune import space as tspace

METRIC = "gcell_per_sec_per_chip"
DEFAULT_DOMINATED_FRAC = 0.6


@dataclasses.dataclass
class Trial:
    knobs: Dict[str, str]
    status: str  # measured | pruned | dominated | budget | error
    reason: Optional[str] = None
    row: Optional[Dict[str, Any]] = None
    # the RAW knob overrides of the candidate (tspace.Candidate.overrides)
    # — the winner's config is rebuilt from these, never re-parsed from
    # the stringified display label
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def metric(self) -> Optional[float]:
        if self.row and isinstance(self.row.get(METRIC), (int, float)):
            return float(self.row[METRIC])
        return None


@dataclasses.dataclass
class SearchResult:
    key: str
    trials: List[Trial]
    winner: Optional[Trial]
    default: Optional[Trial]
    decisions: List[Dict[str, Any]]
    elapsed_s: float
    budget_s: Optional[float]
    cache_written: Optional[str] = None  # store path when the entry landed
    enumerate_s: Optional[float] = None  # seconds to enumerate and prune

    @property
    def speedup_vs_default(self) -> Optional[float]:
        """Winner metric over the default's — None when either side is
        missing or the default measurement was RTT-dominated (a link
        artifact must not serve as the denominator)."""
        if (
            self.winner
            and self.default
            and self.winner.metric
            and self.default.metric
            and not (self.default.row or {}).get("rtt_dominated")
        ):
            return self.winner.metric / self.default.metric
        return None


def _concrete_backend(cfg: SolverConfig) -> str:
    """``backend='auto'`` resolved to the route that actually executes —
    the solver's own rule (``models.heat3d.resolved_backend_name``), so a
    cached route cannot drift from what auto runs execute. Entries store
    CONCRETE knobs so resolution never loops the question back."""
    from heat3d_tpu_torch.models.heat3d import resolved_backend_name

    return resolved_backend_name(cfg)


def _on_card(device) -> bool:
    import torch

    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available()


def _ensemble_incompatible(overrides: Dict[str, Any]) -> Optional[str]:
    """Why a candidate cannot serve as a batch-bucket (ensemble) config, or
    None. The ensemble runs the plain chain on the axis-ordered ppermute
    exchange (``serve.ensemble`` pins exactly this): the kernel routes, the
    DMA transport, pairwise ordering and the split-step overlap are
    single-tenant knobs that would fail ``EnsembleSolver`` construction, so
    they are pruned with a reason instead of spending budget on certain
    ``status: error`` trials."""
    if overrides.get("backend") in ("pallas", "conv"):
        return f"ensemble: backend={overrides['backend']} is single-tenant"
    if overrides.get("halo") == "dma":
        return "ensemble: halo='dma' is single-tenant"
    if overrides.get("halo_order") == "pairwise":
        return "ensemble: halo_order='pairwise' is single-tenant"
    if overrides.get("overlap"):
        return "ensemble: overlap=True is single-tenant"
    return None


def _ensemble_bench(batch_members: int, device=None):
    """A ``bench_throughput``-shaped callable measuring the candidate as a
    B-member ensemble batch on ``device`` (``serve.bench``): the
    measurement behind ``tune run --batch-members``."""
    from heat3d_tpu_torch.serve.bench import bench_ensemble_throughput
    from heat3d_tpu_torch.serve.scenario import Scenario, ScenarioBatch

    def bench(cfg, steps, warmup, repeats):
        members = [
            Scenario(alpha=0.3 + 0.4 * (m + 1) / batch_members, seed=m, steps=steps)
            for m in range(batch_members)
        ]
        return bench_ensemble_throughput(
            ScenarioBatch(cfg, members), steps=steps, warmup=warmup,
            repeats=repeats, device=device,
        )

    return bench


def run_search(
    base: SolverConfig,
    space: Optional[Dict[str, Sequence[Any]]] = None,
    budget_s: Optional[float] = None,
    steps: int = 30,
    repeats: int = 2,
    probe_steps: int = 8,
    dominated_frac: float = DEFAULT_DOMINATED_FRAC,
    min_win_pct: float = tdecide.DEFAULT_MIN_WIN_PCT,
    write_cache: bool = True,
    cache_path: Optional[str] = None,
    batch_members: int = 1,
    device=None,
) -> SearchResult:
    """Search the knob lattice around ``base`` with every trial placed on
    ``device`` (the solver's ``device=``) and, by default, cache the winner
    under :func:`~heat3d_tpu_torch.tune.cache.cache_key` for that
    placement. ``batch_members`` > 1 searches the ensemble workload (see
    the module docstring)."""
    from heat3d_tpu_torch.bench import harness

    def bench_throughput(cfg, steps, warmup, repeats):
        return harness.bench_throughput(
            cfg, steps=steps, warmup=warmup, repeats=repeats, device=device
        )

    if batch_members > 1:
        bench_throughput = _ensemble_bench(batch_members, device)

    # a base carrying auto sentinels (halo='auto', time_blocking=0) would
    # otherwise be measured under the static fallback but CACHED verbatim
    # — an entry lint rejects. Pin it to the static defaults those
    # sentinels mean (backend='auto' is fine: _winner_config concretizes
    # it at store time), so "speedup vs default" is vs the real defaults.
    base = tcache._static_fallback(base)
    t0 = time.monotonic()
    budget_left = lambda: (  # noqa: E731
        None if budget_s is None else budget_s - (time.monotonic() - t0)
    )
    key = tcache.cache_key(base, batch_size=batch_members, device=device)
    prev_disable = os.environ.get(tcache.ENV_DISABLE)
    os.environ[tcache.ENV_DISABLE] = "1"
    try:
        if _on_card(device):
            from heat3d_tpu_torch.ops import _build

            _build.build_all()
        from heat3d_tpu_torch.models.heat3d import HeatSolver3D

        t_enum = time.perf_counter()
        candidates = tspace.enumerate_candidates(
            base, space, make_solver=lambda c: HeatSolver3D(c, device=device)
        )
        if batch_members > 1:
            candidates = [
                dataclasses.replace(c, prune=_ensemble_incompatible(c.overrides))
                if c.prune is None else c
                for c in candidates
            ]
        enumerate_s = time.perf_counter() - t_enum
        obs.get().event(
            "tune_search_start",
            key=key,
            candidates=len(candidates),
            pruned=sum(1 for c in candidates if c.prune),
            budget_s=budget_s,
            steps=steps,
            batch_members=batch_members,
            enumerate_s=enumerate_s,
        )
        trials: List[Trial] = []
        best: Optional[float] = None
        default_trial: Optional[Trial] = None
        out_of_budget = False
        for i, cand in enumerate(candidates):
            is_default = i == 0
            if cand.prune is not None:
                trials.append(
                    Trial(
                        cand.knobs, "pruned", reason=cand.prune,
                        overrides=cand.overrides,
                    )
                )
                obs.get().event(
                    "tune_trial", knobs=cand.knobs, status="pruned",
                    reason=cand.prune,
                )
                continue
            left = budget_left()
            # the default reference is measured regardless of budget
            if out_of_budget or (
                left is not None and left <= 0 and not is_default
            ):
                out_of_budget = True
                trials.append(
                    Trial(
                        cand.knobs, "budget", reason="budget exhausted",
                        overrides=cand.overrides,
                    )
                )
                continue
            trial = _measure_one(
                bench_throughput, cand, best,
                steps=steps, repeats=repeats, probe_steps=probe_steps,
                dominated_frac=dominated_frac, probe=not is_default,
            )
            trials.append(trial)
            if is_default:
                default_trial = trial
            m = trial.metric
            if (
                trial.status == "measured"
                and m is not None
                and not (trial.row or {}).get("rtt_dominated")
                and (best is None or m > best)
            ):
                best = m
        if out_of_budget:
            obs.get().event(
                "tune_budget_exhausted",
                key=key,
                unmeasured=sum(1 for t in trials if t.status == "budget"),
                budget_s=budget_s,
            )

        # winner: best measured, RTT-honest
        measured = [
            t
            for t in trials
            if t.status == "measured"
            and t.metric is not None
            and not (t.row or {}).get("rtt_dominated")
        ]
        winner = max(measured, key=lambda t: t.metric, default=None)

        # per-knob pairwise decisions over the measured trials
        decisions = tdecide.decide(
            [(t.knobs, t.row) for t in measured], min_win_pct=min_win_pct
        )

        result = SearchResult(
            key=key,
            trials=trials,
            winner=winner,
            default=default_trial,
            decisions=decisions,
            elapsed_s=time.monotonic() - t0,
            budget_s=budget_s,
            enumerate_s=enumerate_s,
        )
        if winner is not None:
            obs.get().event(
                "tune_winner",
                key=key,
                knobs=winner.knobs,
                **{METRIC: winner.metric},
                speedup_vs_default=result.speedup_vs_default,
                elapsed_s=result.elapsed_s,
            )
            if write_cache:
                # an RTT-dominated default measurement must not become the
                # entry's speedup denominator
                default_clean = (
                    default_trial is not None
                    and default_trial.metric is not None
                    and not (default_trial.row or {}).get("rtt_dominated")
                )
                result.cache_written = tcache.store_entry(
                    key,
                    _winner_config(base, winner, ensemble=batch_members > 1),
                    winner.metric,
                    default_metric=(
                        default_trial.metric if default_clean else None
                    ),
                    path=cache_path,
                    device=device,
                )
        return result
    finally:
        if prev_disable is None:
            os.environ.pop(tcache.ENV_DISABLE, None)
        else:
            os.environ[tcache.ENV_DISABLE] = prev_disable


def _winner_config(base: SolverConfig, winner: Trial, ensemble: bool = False) -> SolverConfig:
    """The winner's SolverConfig with the backend concretized (entries
    store the route that executes, not 'auto'). An ensemble (batch-bucket)
    winner ran the plain chain whatever the solo rule would pick: its
    concrete route is 'jnp' (``serve.ensemble`` pins it)."""
    cfg = tspace.apply_knobs(base, winner.overrides)
    if ensemble:
        return dataclasses.replace(cfg, backend="jnp")
    return dataclasses.replace(cfg, backend=_concrete_backend(cfg))


def _measure_one(
    bench_throughput,
    cand: "tspace.Candidate",
    best: Optional[float],
    steps: int,
    repeats: int,
    probe_steps: int,
    dominated_frac: float,
    probe: bool,
) -> Trial:
    """One candidate: optional domination probe, then the full
    measurement. Crashes become ``status: error`` trials."""
    try:
        if probe and best is not None and probe_steps > 0:
            with obs.get().span("tune_probe", knobs=cand.knobs):
                prow = bench_throughput(
                    cand.cfg, steps=probe_steps, warmup=1, repeats=1
                )
            pm = prow.get(METRIC)
            if (
                isinstance(pm, (int, float))
                and not prow.get("rtt_dominated")
                and pm < dominated_frac * best
            ):
                obs.get().event(
                    "tune_trial", knobs=cand.knobs, status="dominated",
                    probe_metric=pm, best=best, pruned_dominated=True,
                )
                return Trial(
                    cand.knobs, "dominated",
                    reason=f"probe {pm:.3g} < {dominated_frac:.0%} of "
                    f"best {best:.3g}",
                    row=prow,
                    overrides=cand.overrides,
                )
        with obs.get().span("tune_trial_measure", knobs=cand.knobs):
            row = bench_throughput(
                cand.cfg, steps=steps, warmup=1, repeats=repeats
            )
        obs.get().event(
            "tune_trial", knobs=cand.knobs, status="measured",
            **{METRIC: row.get(METRIC)},
            rtt_dominated=bool(row.get("rtt_dominated")),
        )
        return Trial(
            cand.knobs, "measured", row=row, overrides=cand.overrides
        )
    except Exception as e:  # noqa: BLE001 - one broken route != the session
        err = f"{type(e).__name__}: {str(e)[:200]}"
        obs.get().event(
            "tune_trial", knobs=cand.knobs, status="error", error=err
        )
        return Trial(
            cand.knobs, "error", reason=err, overrides=cand.overrides
        )
