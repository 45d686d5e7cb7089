"""The supervised run loop: checkpoint-gated, watchdogged, self-resuming.

Port of ``heat3d_tpu.resilience.supervisor``, with its ledger spans,
events and metrics (``supervised_start``/``supervised_end``, a ``chunk``
span per checkpoint window, ``heal_wait``, ``recovery``,
``generation_save``, the degraded-mode events, ``step_latency_seconds``).
It drives ``utils.checkpoint`` automatically:

- **Checkpoint every K steps** into *generations* —
  ``<root>/gen-<step>/`` directories (``gen-%08d``), each a complete
  checksummed checkpoint in the JAX package's format. The newest
  ``keep_generations`` are retained; the rest pruned after each
  successful save.
- **Detect backend death** (exceptions out of a chunk, injected faults)
  and **suspect hangs** (a chunk overrunning the watchdog budget; a chunk
  is timed after every stream of every device the solver's shards use is
  synchronised) — then confirm with the bounded out-of-process probes
  (``utils.backendprobe``, a killable torch child), which must find the
  device type the run started on (``want_platform``): a child that finds
  no GPU never counts as a healed card.
- **Wait for the backend to heal** through the one
  :class:`~heat3d_tpu_torch.resilience.retry.RetryPolicy`, then **rebuild
  the solver and resume from the last good generation**. A corrupt
  generation (checksum mismatch, torn manifest) is quarantined and the
  previous generation is loaded instead. Because ``checkpoint.load``
  stitches across meshes, a rebuilt solver may be on another mesh
  (``heal_mode='elastic'``, ``resilience.elastic``).

Limits of in-process recovery:

- A chunk truly stuck inside a non-returning call never comes back to
  Python. That tier stays with the process-level guards (coreutils
  ``timeout`` + the SIGTERM -> SystemExit of every entry point), and a
  SIGTERM'd supervised run resumes from its last generation on relaunch.
- A *sticky* CUDA error (an illegal address, a launch failure) poisons
  this process's CUDA context for good, while a fresh probe child still
  finds the card alive: every rebuilt solver in this process fails again.
  The loop re-raises once ``max_recoveries`` is spent instead of spinning;
  relaunching the same command resumes from the generations on disk in a
  new process, with a new context.

Scope: single-controller supervision (one process holds every shard).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedBackendLoss,
    InjectedFault,
    InjectedHang,
)
from heat3d_tpu_torch.resilience.retry import RetryPolicy
from heat3d_tpu_torch.utils import checkpoint as ckpt
from heat3d_tpu_torch.utils.timing import force_sync

log = logging.getLogger("heat3d.supervisor")

GEN_PREFIX = "gen-"

# Heal-wait default: the supervisor resolves its policy through
# elastic.default_heal_policy() — probe every 60 s, 1.5x backoff capped at
# 5 min, with the total deadline owned by the HEAT3D_HEAL_DEADLINE_S knob
# (default 30 min; in `auto` heal mode its expiry is what triggers the
# elastic fallback).


class BackendSuspect(RuntimeError):
    """A chunk overran the watchdog and the follow-up probe found the
    backend unreachable."""


@dataclasses.dataclass
class Recovery:
    """One survived failure, as a structured record for the run summary."""

    step: int
    kind: str  # 'backend-loss' | 'hang' | 'error'
    error: str
    heal_wait_s: float
    heal_attempts: int
    resumed_from: Optional[int]
    quarantined: List[str] = dataclasses.field(default_factory=list)
    # elastic recoveries re-factorized the mesh over survivors instead of
    # waiting the backend whole again (resilience/elastic.py); the mesh
    # the run continued on is part of the record so degraded progress can
    # never masquerade as full-capacity progress downstream
    elastic: bool = False
    mesh_shape: Optional[List[int]] = None
    restitch_s: Optional[float] = None
    # seconds from the failure's catch to the resumed field in hand: heal
    # wait, solver rebuild and generation load
    recovery_s: Optional[float] = None

    def to_record(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SupervisedResult:
    u: object
    steps_done: int
    start_step: int
    resumed_from: Optional[int]
    residual: Optional[float]
    checkpoints_written: int
    recoveries: List[Recovery]
    # the solver that produced u — NOT necessarily the one passed in: a
    # recovery rebuilds it (possibly on different hardware/mesh), and any
    # post-run operation on u (gather, slice dump, golden check) must use
    # this one, not the caller's stale instance
    solver: object = None
    # elastic-degradation provenance (resilience/elastic.py): whether the
    # run FINISHED degraded, the mesh it finished on, and how many
    # re-factorizations (degrade + expand) happened — run summaries carry
    # these so degraded throughput is labeled at the source
    degraded: bool = False
    mesh_shape: Optional[tuple] = None
    refactors: int = 0

    def to_record(self) -> dict:
        return {
            "steps_done": self.steps_done,
            "start_step": self.start_step,
            "resumed_from": self.resumed_from,
            "checkpoints_written": self.checkpoints_written,
            "recoveries": [r.to_record() for r in self.recoveries],
            "degraded": self.degraded,
            "mesh_shape": (
                None if self.mesh_shape is None else list(self.mesh_shape)
            ),
            "refactors": self.refactors,
        }


# ---- generation bookkeeping ---------------------------------------------


def generation_dirs(root: str) -> List[Tuple[int, str]]:
    """(step, path) for every generation under ``root``, oldest first.
    Quarantined directories are invisible by construction (their names no
    longer parse)."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        if not name.startswith(GEN_PREFIX):
            continue
        try:
            step = int(name[len(GEN_PREFIX):])
        except ValueError:
            continue
        out.append((step, os.path.join(root, name)))
    out.sort()
    return out


def save_generation(solver, u, step: int, root: str, keep: int = 2) -> str:
    """Write ``<root>/gen-<step>`` and prune to the newest ``keep``.

    The prune happens only AFTER the new generation's manifest landed, so
    a crash mid-save can orphan at most one partial directory — which the
    load path then quarantines (no manifest) and skips."""
    gen = os.path.join(root, f"{GEN_PREFIX}{step:08d}")
    solver.save_checkpoint(gen, u, step)
    # the generation TRANSITION is the supervisor-level fact (the save
    # itself is the nested ckpt_save span): tag every later event with the
    # new generation so a heal/resume session reads end to end
    obs.get().event("generation_save", step=step, path=gen)
    obs.get().set_context(generation=step)
    obs.REGISTRY.counter(
        "generation_transitions_total", "supervisor generation saves"
    ).inc()
    gens = generation_dirs(root)
    for _, old in gens[:-keep] if keep > 0 else []:
        if os.path.realpath(old) == os.path.realpath(gen):
            continue
        shutil.rmtree(old, ignore_errors=True)
    return gen


def load_latest_generation(solver, root: str):
    """Restore from the newest loadable generation.

    Walks generations newest-first; a generation that fails to load —
    checksum mismatch (:class:`~heat3d_tpu_torch.utils.checkpoint.ShardCorruptError`),
    torn manifest, missing shards — is QUARANTINED (renamed out of the
    scan) and the previous one is tried. Returns
    ``((u, step) | None, quarantined_paths)`` — the quarantine list is
    returned even when NOTHING loads, so an every-generation-corrupt
    recovery still gets a truthful post-mortem record.
    """
    quarantined: List[str] = []
    for step, gen in reversed(generation_dirs(root)):
        # Quarantine only on PROVEN damage: a checksum mismatch, or a
        # missing/torn manifest (a save that died mid-write). Any other
        # load failure — shard files not visible from this process, a
        # stale different-grid file, a config mismatch — may be the
        # ENVIRONMENT's or the CONFIG's fault, and renaming the
        # generation would destroy a resume some other context could
        # still perform; those are skipped in place.
        try:
            ckpt.load_manifest(gen)
        except FileNotFoundError as e:  # save died before its manifest
            log.warning("generation %s has no manifest (%s); quarantining",
                        gen, e)
            quarantined.append(ckpt.quarantine(gen, reason=str(e)))
            continue
        except ValueError as e:  # torn/truncated JSON: proven damage
            log.warning("generation %s manifest is torn (%s); quarantining",
                        gen, e)
            quarantined.append(ckpt.quarantine(gen, reason=str(e)))
            continue
        except OSError as e:
            # EIO/ESTALE/EACCES on a flaky FS is the ENVIRONMENT's fault,
            # not proven damage — skip in place, never rename away a
            # generation that may read fine next attempt
            log.warning(
                "generation %s manifest unreadable here (%s); skipping "
                "WITHOUT quarantine", gen, e,
            )
            continue
        try:
            u, got_step = solver.load_checkpoint(gen)
            return (u, got_step), quarantined
        except ckpt.ShardCorruptError as e:
            log.warning("generation %s corrupt (%s); quarantining", gen, e)
            quarantined.append(ckpt.quarantine(gen, reason=str(e)))
        except (OSError, ValueError, KeyError) as e:
            log.warning(
                "generation %s unloadable here (%s: %s); skipping WITHOUT "
                "quarantine — not proven corrupt (check shard visibility "
                "and that --grid/--mesh match the checkpoint)",
                gen, type(e).__name__, e,
            )
    return None, quarantined


# ---- the supervised loop -------------------------------------------------


def _default_probe(want: Optional[str]) -> Optional[str]:
    """The platform a probe child finds, or None when it finds none or
    not ``want`` (the device type the run started on)."""
    from heat3d_tpu_torch.utils.backendprobe import probe_platform

    p = probe_platform()
    if p is None or (want is not None and p != want):
        return None
    return p


def _wait_for_heal(
    policy: RetryPolicy,
    plan: FaultPlan,
    want: Optional[str],
    probe: Optional[Callable[[], Optional[str]]],
):
    """Probe (fault-overridable) under the retry policy until the backend
    answers. Returns the RetryOutcome; ``outcome.ok`` False = never healed."""

    def attempt():
        override = plan.probe_override()
        if override == "down":
            return None
        if probe is not None:
            return probe()
        return _default_probe(want)

    return policy.run(attempt)


def run_supervised(
    solver,
    total_steps: int,
    ckpt_root: str,
    checkpoint_every: int = 0,
    *,
    make_solver: Optional[Callable[[], object]] = None,
    heal_policy: Optional[RetryPolicy] = None,
    watchdog_s: Optional[float] = None,
    max_recoveries: int = 3,
    keep_generations: int = 2,
    want_platform: Optional[str] = None,
    probe: Optional[Callable[[], Optional[str]]] = None,
    faults: Optional[FaultPlan] = None,
    init: str = "hot-cube",
    finish_with_residual: bool = True,
    heal_mode: Optional[str] = None,
    make_solver_for: Optional[Callable[[object], object]] = None,
    base_cfg=None,
    device_probe: Optional[Callable[[], Optional[int]]] = None,
    reexpand: bool = False,
) -> SupervisedResult:
    """Run ``solver`` to global step ``total_steps`` under supervision.

    ``total_steps`` is the TARGET GLOBAL STEP, not a relative count: a
    fresh run advances 0 -> total, a resumed run advances from its newest
    generation's step — so re-launching the same command after a kill
    finishes the run instead of running past it (bit-for-bit equal to an
    uninterrupted supervised run on the same mesh: both split the steps
    into the same chunks).

    ``make_solver`` rebuilds the solver after a backend loss (default:
    reuse ``solver``); the old solver is dropped first, with its plans.
    ``want_platform`` is the device type the run started on (``"cuda"``,
    ``"cpu"``): the default heal probe accepts no other. ``probe``
    overrides the heal probe (tests); ``faults`` overrides the env-parsed
    :class:`~heat3d_tpu_torch.resilience.faults.FaultPlan`.

    **Elastic degradation** (``heal_mode='elastic'|'auto'``;
    ``resilience.elastic``): on a confirmed loss the supervisor re-probes
    the device set (fault-plan override > ``device_probe`` > bounded
    out-of-process probe) and, when devices are missing, re-factorizes the
    mesh over the survivors — ``make_solver_for(new_cfg)`` builds the
    solver for the certified degraded config derived from ``base_cfg``
    (default: ``solver.cfg``), the ``gen-<step>`` shards re-stitch onto the
    new mesh through the cross-mesh load, and the run continues degraded.
    In ``auto`` mode the heal DEADLINE is the trigger: wait first, degrade
    only when the deadline expires or the healed backend comes back
    smaller. ``reexpand=True`` opts into re-factorizing back to the
    original mesh when a later probe reports full capacity.
    """
    from heat3d_tpu_torch.resilience import elastic

    plan = faults if faults is not None else FaultPlan.from_env()
    policy = heal_policy or elastic.default_heal_policy()
    mode = elastic.resolve_heal_mode(heal_mode)
    if base_cfg is None:
        base_cfg = getattr(solver, "cfg", None)
    if make_solver_for is None and mode != "wait":
        # elastic needs a config-parameterized factory; without one the
        # mode silently behaving like `wait` would be a lie — refuse
        raise ValueError(
            f"heal_mode={mode!r} needs make_solver_for (a cfg -> solver "
            "factory; HeatSolver3D.run_supervised provides one)"
        )
    if base_cfg is None and mode != "wait":
        raise ValueError(
            f"heal_mode={mode!r} needs base_cfg (or a solver with a .cfg)"
        )
    cur_cfg = base_cfg
    degraded = False
    degraded_t0 = 0.0
    refactors = 0
    recoveries: List[Recovery] = []
    checkpoints = 0
    resumed_from = None
    ledger = obs.get()
    step_hist = obs.REGISTRY.histogram(
        "step_latency_seconds", "per-step wall latency (chunk dur / steps)"
    )

    def alive() -> bool:
        return (probe() if probe is not None
                else _default_probe(want_platform)) is not None

    os.makedirs(ckpt_root, exist_ok=True)
    loaded, quarantined = load_latest_generation(solver, ckpt_root)
    if quarantined:
        log.warning(
            "resume quarantined %d generation(s): %s",
            len(quarantined), quarantined,
        )
    if loaded is not None:
        u, done = loaded
        resumed_from = done
        log.info("supervised run resuming at step %d from %s", done, ckpt_root)
    else:
        if generation_dirs(ckpt_root):
            # generations survive on disk but none loaded HERE (skipped
            # without quarantine: FS blip, config mismatch): restarting
            # at step 0 would silently orphan real progress — refuse, the
            # same rule the CLI applies to flat checkpoints
            raise ValueError(
                f"{ckpt_root} holds generations but none is loadable from "
                "this process/config (see warnings above) — fix the "
                "mismatch or point the run at a fresh directory; refusing "
                "to restart at step 0 over existing progress"
            )
        u, done = solver.init_state(init), 0
    start_step = done
    if done > total_steps:
        raise ValueError(
            f"checkpoint at step {done} is past the target {total_steps} — "
            "refusing to run backwards (raise --steps or point --checkpoint "
            "at a fresh directory)"
        )
    ledger.set_context(generation=resumed_from)
    ledger.event(
        "supervised_start",
        total_steps=total_steps,
        start_step=start_step,
        resumed_from=resumed_from,
        checkpoint_every=checkpoint_every,
        ckpt_root=ckpt_root,
        quarantined=quarantined,
    )

    residual = None
    while done < total_steps:
        # next boundary: a checkpoint point or the end
        if checkpoint_every > 0:
            nxt = min(
                (done // checkpoint_every + 1) * checkpoint_every, total_steps
            )
        else:
            nxt = total_steps
        n = nxt - done
        try:
            # the chunk span covers fault hooks + the steps + the sync, so
            # an injected loss lands INSIDE it (status=error) and a healed
            # session's timeline shows exactly which step window died;
            # per-step latency (dur/n) feeds the same histogram the obs
            # CLI reconstructs post-hoc from these spans
            with ledger.span(
                "chunk", step_start=done, step_end=nxt, steps=n
            ) as chunk_span:
                plan.on_step(done, watchdog_s=watchdog_s)
                t0 = time.monotonic()
                if nxt == total_steps and finish_with_residual:
                    if n > 1:
                        u = solver.run(u, n - 1)
                    u, r2 = solver.step_with_residual(u)
                    residual = float(np.sqrt(np.float64(float(r2))))
                else:
                    u = solver.run(u, n)
                force_sync(solver)
                chunk_s = time.monotonic() - t0
                chunk_span.add(steps_s=chunk_s)
            step_hist.observe(chunk_s / n)
            if watchdog_s is not None and chunk_s > watchdog_s:
                # the chunk RETURNED but blew its budget: a wedging backend
                # slow-walks before it stops answering. Probe before
                # trusting the result.
                log.warning(
                    "chunk %d->%d took %.1fs (watchdog %.1fs); probing",
                    done, nxt, chunk_s, watchdog_s,
                )
                if not alive():
                    raise BackendSuspect(
                        f"chunk overran watchdog ({chunk_s:.1f}s > "
                        f"{watchdog_s:.1f}s) and the backend probe failed"
                    )
            # the save sits INSIDE the recovery envelope: checkpoint.save
            # reads shard data off the device, and a backend dying exactly
            # at a chunk boundary must trigger heal-and-resume like any
            # other loss, not escape the supervisor uncaught
            gen = save_generation(
                solver, u, nxt, ckpt_root, keep=keep_generations
            )
            checkpoints += 1
            plan.on_checkpoint_saved(gen)
        except (InjectedBackendLoss, InjectedHang, BackendSuspect,
                RuntimeError) as e:
            t_fail = time.monotonic()
            if isinstance(e, InjectedFault):
                kind = "hang" if isinstance(e, InjectedHang) else "backend-loss"
            elif isinstance(e, BackendSuspect):
                kind = "hang"
            else:
                # a real RuntimeError (a CUDA error among them): only treat
                # as an outage if the bounded probe agrees the backend is
                # gone — a genuine bug must not be silently retried
                kind = "error"
                if alive():
                    raise
            if len(recoveries) >= max_recoveries:
                log.error(
                    "supervised run: %d recoveries exhausted; re-raising",
                    max_recoveries,
                )
                raise
            failed_step = done  # before the reload rewinds it
            log.warning(
                "supervised run lost the backend at step %d (%s: %s); "
                "waiting for heal", failed_step, kind, e,
            )
            # the field is reloaded from a generation: drop it now
            u = None
            # Elastic triage (resilience/elastic.py) — the three modes
            # genuinely differ here:
            #   wait    — wait for the ORIGINAL platform to heal; the
            #             deadline re-raises.
            #   elastic — a loss is a RE-PLAN event: the wait's success
            #             criterion is ANY SURVIVORS ANSWERING (the
            #             device-set probe).
            #   auto    — wait-first: the full platform heal wait runs,
            #             and the DEADLINE (or a backend that healed
            #             smaller) is what triggers the elastic fallback.
            with ledger.span(
                "heal_wait", step=failed_step, failure=kind, mode=mode
            ) as heal_span:
                if mode == "elastic":
                    outcome = policy.run(
                        lambda: elastic.probe_survivors(plan, device_probe)
                    )
                else:
                    outcome = _wait_for_heal(policy, plan, want_platform, probe)
                heal_span.add(
                    ok=outcome.ok,
                    attempts=len(outcome.attempts),
                    stop_reason=outcome.stop_reason,
                )
            survivors = None
            if mode == "elastic":
                if not outcome.ok:
                    log.error(
                        "no survivors answered (%s after %.1fs); "
                        "re-raising", outcome.stop_reason,
                        outcome.elapsed_s,
                    )
                    raise
                survivors = outcome.value
            elif not outcome.ok:
                if mode == "auto":
                    survivors = elastic.probe_survivors(plan, device_probe)
                if not survivors:
                    log.error(
                        "backend never healed (%s after %.1fs); re-raising",
                        outcome.stop_reason, outcome.elapsed_s,
                    )
                    raise
            elif mode == "auto":
                survivors = elastic.probe_survivors(plan, device_probe)

            new_cfg = None
            if (
                survivors is not None
                and survivors < cur_cfg.mesh.num_devices
            ):
                new_cfg = elastic.survivor_config(
                    base_cfg, survivors, make_solver_for
                )
                if new_cfg is None:
                    if not outcome.ok:
                        log.error(
                            "no certified survivor mesh for %d device(s) "
                            "and the heal deadline expired; re-raising",
                            survivors,
                        )
                        raise
                    # the backend healed but no degraded config
                    # certifies: resume on the current mesh — honest
                    # fallback, loudly logged
                    log.warning(
                        "no certified survivor mesh for %d device(s); "
                        "resuming on the current mesh", survivors,
                    )
            restitch_s = None
            if new_cfg is not None:
                old_mesh = cur_cfg.mesh.shape
                # the old solver's plans and buffers are bound to the old
                # mesh: drop them before the survivor solver builds its own
                solver = None
                solver, loaded, quarantined, restitch_s = (
                    elastic.refactor_and_restitch(
                        new_cfg, make_solver_for, ckpt_root,
                        old_mesh=old_mesh, step=failed_step, survivors=survivors,
                    )
                )
                cur_cfg = new_cfg
                refactors += 1
                if (
                    not degraded
                    and new_cfg.mesh.num_devices < base_cfg.mesh.num_devices
                ):
                    degraded = True
                    degraded_t0 = time.monotonic()
                    ledger.event(
                        "degraded_mode_enter",
                        step=failed_step,
                        mesh=list(new_cfg.mesh.shape),
                        survivors=int(survivors),
                    )
            else:
                if (
                    make_solver_for is not None
                    and cur_cfg is not None
                    and cur_cfg is not base_cfg
                ):
                    # already degraded: a rebuild must land on the mesh
                    # the run is CURRENTLY on, not the original one
                    solver = None
                    solver = make_solver_for(cur_cfg)
                elif make_solver is not None:
                    solver = None
                    solver = make_solver()
                loaded, quarantined = load_latest_generation(
                    solver, ckpt_root
                )
            if loaded is not None:
                u, done = loaded
            elif generation_dirs(ckpt_root):
                # generations remain but none loads here (skipped, not
                # quarantined): restarting at 0 would orphan them —
                # surface the original failure instead
                log.error(
                    "recovery found unloadable (but intact) generations "
                    "in %s; re-raising rather than restarting at step 0",
                    ckpt_root,
                )
                raise
            else:
                # every generation was quarantined (proven corrupt):
                # restarting from scratch is the only honest option, and
                # the Recovery record says so (resumed_from=None)
                u, done = solver.init_state(init), 0
            recoveries.append(
                Recovery(
                    step=failed_step,  # where the failure hit, not the rewind
                    kind=kind,
                    error=f"{type(e).__name__}: {str(e)[:200]}",
                    heal_wait_s=round(outcome.elapsed_s, 3),
                    heal_attempts=len(outcome.attempts),
                    resumed_from=done if loaded is not None else None,
                    quarantined=quarantined,
                    elastic=new_cfg is not None,
                    mesh_shape=(
                        list(cur_cfg.mesh.shape)
                        if cur_cfg is not None
                        else None
                    ),
                    restitch_s=(
                        None if restitch_s is None else round(restitch_s, 3)
                    ),
                    recovery_s=round(time.monotonic() - t_fail, 3),
                )
            )
            ledger.set_context(
                generation=done if loaded is not None else None
            )
            rec_record = recoveries[-1].to_record()
            rec_record["kind_"] = rec_record.pop("kind")  # envelope owns kind
            ledger.event("recovery", **rec_record)
            if make_solver is not None or new_cfg is not None:
                # the rebuilt solver may be on a different mesh
                # (cross-mesh stitch-resume), where its step program — and
                # therefore its cost — differs from the one recorded at run
                # start. Re-emit step_cost so post-heal throughput is judged
                # against the program that is NOW running. Fails soft and
                # no-ops without a ledger.
                try:
                    from heat3d_tpu_torch.obs.perf.roofline import record_step_cost

                    record_step_cost(solver, post_heal=True, step=done)
                except Exception as rexc:  # noqa: BLE001 - telemetry only
                    log.warning(
                        "post-heal step_cost re-record unavailable: %s", rexc
                    )
            obs.REGISTRY.counter(
                "recoveries_total", "survived supervised failures"
            ).inc(kind=kind)
            log.info(
                "backend healed (%s); resumed at step %d",
                outcome.value, done,
            )
            continue
        done = nxt

        # Opt-in re-expand (the elastic loop's other half): while
        # degraded, after each generation lands, ask whether capacity
        # returned — and if the FULL original device count answers,
        # re-factorize back onto the original mesh, re-stitching from
        # the generation just saved. Probing only at checkpoint
        # boundaries bounds the probe cost; skipping the final boundary
        # avoids a pointless rebuild the run would never step on.
        if degraded and reexpand and done < total_steps:
            survivors = elastic.probe_survivors(plan, device_probe)
            if (
                survivors is not None
                and survivors >= base_cfg.mesh.num_devices
            ):
                try:
                    # commit NOTHING until the re-stitch proves loadable:
                    # rebinding `solver` before the load check would leave
                    # a full-mesh solver driving the degraded-mesh `u` on
                    # the next chunk
                    exp_solver, loaded, quarantined, _rs = (
                        elastic.refactor_and_restitch(
                            base_cfg, make_solver_for, ckpt_root,
                            old_mesh=cur_cfg.mesh.shape, step=done,
                            survivors=survivors, direction="expand",
                        )
                    )
                    if loaded is None:
                        raise RuntimeError(
                            "no loadable generation for re-expand"
                        )
                    solver = exp_solver
                    u, done = loaded
                    cur_cfg = base_cfg
                    refactors += 1
                    degraded = False
                    ledger.event(
                        "degraded_mode_exit",
                        step=done,
                        mesh=list(base_cfg.mesh.shape),
                        degraded_s=round(
                            time.monotonic() - degraded_t0, 3
                        ),
                    )
                except Exception as rexc:  # noqa: BLE001 - stay degraded
                    # a failed expand must not kill a run that is
                    # healthily running degraded — log and keep going;
                    # the next boundary retries
                    log.warning(
                        "re-expand to %s failed (%s); staying degraded",
                        base_cfg.mesh.shape, rexc,
                    )

    ledger.event(
        "supervised_end",
        steps_done=done,
        start_step=start_step,
        resumed_from=resumed_from,
        checkpoints_written=checkpoints,
        recoveries=len(recoveries),
        degraded=degraded,
        refactors=refactors,
        mesh=(
            None if cur_cfg is None else list(cur_cfg.mesh.shape)
        ),
    )
    ledger.set_context(generation=None)
    return SupervisedResult(
        u=u,
        steps_done=done,
        start_step=start_step,
        resumed_from=resumed_from,
        residual=residual,
        checkpoints_written=checkpoints,
        recoveries=recoveries,
        solver=solver,
        degraded=degraded,
        mesh_shape=(None if cur_cfg is None else cur_cfg.mesh.shape),
        refactors=refactors,
    )
