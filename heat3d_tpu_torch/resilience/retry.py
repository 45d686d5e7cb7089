"""The one retry/backoff implementation.

A copy of ``heat3d_tpu.resilience.retry`` (pure Python), with its ledger
events (``retry_attempt``, ``retry_outcome``) and counters.

Every wait of the port's resilience layer routes through
:class:`RetryPolicy`: the heal probes of ``backendprobe.wait_for_backend``
and of the supervisor, and shell scripts' pacing through the CLI below.

Design rules:

- **The first attempt always runs.** A zero/expired deadline still gets
  one try — ``wait_for_backend(0)`` has always meant "probe once".
- **Sleeps are clamped to the remaining deadline**, so the last attempt
  fires right at the deadline edge instead of oversleeping past it.
- **Jitter is bounded and injectable.** It de-synchronizes fleets of
  waiting clients; tests inject a seeded ``random.Random``.
- **Outcomes are structured records**, not log lines: every attempt's
  duration, error, and sleep is kept so a post-mortem can reconstruct
  what the retry loop actually did inside an outage window.

Clock and sleep are injectable throughout: the entire policy is testable
in milliseconds on CPU, which is the point of this subsystem.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, List, Optional


@dataclasses.dataclass
class Attempt:
    """One attempt's structured record (offsets are from the run start)."""

    index: int
    started_s: float
    duration_s: float
    ok: bool
    error: Optional[str] = None
    slept_s: float = 0.0


@dataclasses.dataclass
class RetryOutcome:
    """What a :meth:`RetryPolicy.run` actually did.

    ``stop_reason`` is one of ``success`` | ``deadline`` | ``attempts`` |
    ``gave_up`` (the caller's ``proceed`` hook said stop).
    """

    ok: bool
    value: Any
    stop_reason: str
    elapsed_s: float
    attempts: List[Attempt] = dataclasses.field(default_factory=list)

    def to_record(self) -> dict:
        """JSON-able summary for logs/bench rows."""
        return {
            "ok": self.ok,
            "stop_reason": self.stop_reason,
            "elapsed_s": round(self.elapsed_s, 3),
            "attempts": len(self.attempts),
            "errors": [a.error for a in self.attempts if a.error],
        }


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff under an optional deadline budget.

    ``max_attempts=None`` means attempt-unbounded (the deadline is then the
    only stop). ``deadline_s`` measures from the start of the first
    attempt; callers with a DYNAMIC budget express it through the
    ``proceed`` hook and a per-attempt timeout instead. ``jitter_frac`` spreads each sleep uniformly
    over ``[delay*(1-j), delay*(1+j)]`` (clamped to the cap and deadline).
    """

    max_attempts: Optional[int] = None
    base_delay_s: float = 60.0
    multiplier: float = 1.5
    max_delay_s: float = 300.0
    jitter_frac: float = 0.0
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts is not None and self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1 (or None)")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1.0 (backoff never shrinks)")
        if not 0.0 <= self.jitter_frac <= 1.0:
            raise ValueError("jitter_frac must be in [0, 1]")
        if self.max_attempts is None and self.deadline_s is None:
            raise ValueError(
                "unbounded policy: set max_attempts and/or deadline_s"
            )

    def delays(self) -> Iterator[float]:
        """The un-jittered backoff schedule: base, base*m, ... capped
        (a view over :meth:`delay_for`, which owns the arithmetic)."""
        i = 1
        while True:
            yield self.delay_for(i)
            i += 1

    def delay_for(self, attempt: int, rng=None) -> float:
        """The (jittered) sleep after the ``attempt``-th failure (1-based).

        The ONE place the backoff+jitter arithmetic lives — ``run()`` and
        the shell-pacing CLI both call it, so in-process and script
        pacing cannot drift apart. ``rng`` needs ``.uniform``; None (or
        ``jitter_frac`` 0) means the bare schedule value."""
        if attempt < 1:
            return 0.0
        delay = min(
            self.base_delay_s * self.multiplier ** (attempt - 1),
            self.max_delay_s,
        )
        if self.jitter_frac and rng is not None:
            lo = delay * (1.0 - self.jitter_frac)
            hi = min(delay * (1.0 + self.jitter_frac), self.max_delay_s)
            delay = rng.uniform(lo, hi)
        return delay

    def run(
        self,
        fn: Callable[..., Any],
        *,
        success: Callable[[Any], bool] = lambda v: v is not None,
        proceed: Optional[Callable[[], bool]] = None,
        on_attempt: Optional[Callable[[Attempt], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng=None,
    ) -> RetryOutcome:
        """Run ``fn`` until ``success(value)``, the deadline, the attempt
        cap, or ``proceed()`` returning False (checked before every attempt
        AFTER the first — the first attempt always runs).

        ``fn`` is called with no arguments; wrap context in a closure. An
        exception from ``fn`` counts as a failed attempt (recorded, then
        retried) — raise through ``proceed`` if an error must abort.
        """
        import random as _random

        from heat3d_tpu_torch import obs

        jrng = rng if rng is not None else _random
        start = clock()
        attempts: List[Attempt] = []
        ledger = obs.get()

        def record(rec: Attempt) -> None:
            # one observation pipeline for every exit path: the caller's
            # on_attempt hook, the ledger's per-attempt event, the counter
            if on_attempt is not None:
                on_attempt(rec)
            ledger.event(
                "retry_attempt",
                index=rec.index,
                ok=rec.ok,
                error=rec.error,
                duration_s=round(rec.duration_s, 6),
                slept_s=round(rec.slept_s, 6),
            )
            obs.REGISTRY.counter(
                "retry_attempts_total", "RetryPolicy attempts"
            ).inc(ok=str(rec.ok).lower())

        def outcome(ok, value, reason):
            out = RetryOutcome(
                ok=ok,
                value=value,
                stop_reason=reason,
                elapsed_s=clock() - start,
                attempts=attempts,
            )
            ledger.event("retry_outcome", **out.to_record())
            obs.REGISTRY.counter(
                "retry_outcomes_total", "RetryPolicy.run results"
            ).inc(reason=reason)
            return out

        i = 0
        while True:
            if i > 0 and proceed is not None and not proceed():
                return outcome(False, None, "gave_up")
            t0 = clock()
            err = None
            try:
                value = fn()
                ok = bool(success(value))
            except Exception as e:  # noqa: BLE001 - a failed attempt, not a crash
                value, ok = None, False
                err = f"{type(e).__name__}: {str(e)[:200]}"
            rec = Attempt(
                index=i,
                started_s=t0 - start,
                duration_s=clock() - t0,
                ok=ok,
                error=err,
            )
            attempts.append(rec)
            if ok:
                record(rec)
                return outcome(True, value, "success")
            i += 1
            if self.max_attempts is not None and i >= self.max_attempts:
                record(rec)
                return outcome(False, None, "attempts")
            delay = self.delay_for(i, jrng)
            if self.deadline_s is not None:
                remaining = self.deadline_s - (clock() - start)
                if remaining <= 0:
                    record(rec)
                    return outcome(False, None, "deadline")
                # clamp so the next (= last) attempt fires at the edge
                delay = min(delay, remaining)
            # recorded unconditionally: the outcome's post-mortem value is
            # reconstructing the sleep schedule that actually ran
            rec.slept_s = delay
            record(rec)
            if delay > 0:
                sleep(delay)


def _main(argv=None) -> int:
    """``python -m heat3d_tpu_torch.resilience.retry --attempt N [...]``

    Prints the policy's backoff delay for attempt N (1-based: the sleep
    AFTER the Nth failure) and, with ``--sleep``, sleeps it. This is how
    shell scripts pace their retry loops through the one policy
    implementation instead of a bare ``sleep 60``.
    Jitter is seeded by the attempt index, so a restarted script sleeps
    the same schedule (deterministic, still fleet-desynchronized via
    --seed-extra, e.g. a hostname hash).
    """
    import argparse
    import random
    import sys

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--attempt", type=int, required=True)
    ap.add_argument("--base", type=float, default=60.0)
    ap.add_argument("--multiplier", type=float, default=1.5)
    ap.add_argument("--cap", type=float, default=300.0)
    ap.add_argument("--jitter", type=float, default=0.1)
    ap.add_argument("--seed-extra", default="")
    ap.add_argument("--sleep", action="store_true")
    args = ap.parse_args(argv)
    if args.attempt < 1:
        print("0.0")
        return 0
    policy = RetryPolicy(
        max_attempts=args.attempt + 1,
        base_delay_s=args.base,
        multiplier=args.multiplier,
        max_delay_s=args.cap,
        jitter_frac=args.jitter,
    )
    delay = policy.delay_for(
        args.attempt, random.Random(f"{args.seed_extra}:{args.attempt}")
    )
    print(f"{delay:.1f}")
    if args.sleep:
        time.sleep(delay)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
