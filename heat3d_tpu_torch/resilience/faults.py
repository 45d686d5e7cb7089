"""Deterministic fault injection — make every failure path run on CPU.

A copy of ``heat3d_tpu.resilience.faults`` (pure Python), with its
``fault_injected`` ledger event and counter: the same spec grammar, fault
kinds, hooks and one-shot state directory, so ``HEAT3D_FAULTS`` means the
same in both packages.

The resilience machinery (supervised runs, checkpoint quarantine, sweep
resume) exists because of backend outages that cannot be reproduced on
demand. This module makes the failure paths *testable*: a fault plan,
declared in the ``HEAT3D_FAULTS`` env var (or built directly in tests),
fires precisely-placed faults at the supervisor/sweep instrumentation
points so pytest can drive loss/hang/kill/corruption scenarios on CPU.

Spec grammar (comma-separated faults; colon-separated ``key=value`` params)::

    HEAT3D_FAULTS="backend-loss:step=8:down=2,sigterm:row=3"

Fault kinds:

- ``backend-loss:step=N[:down=K]`` — the first time the supervised run
  reaches global step >= N, raise :class:`InjectedBackendLoss`; the next
  K heal-probes (default 1) report the backend down, then healthy.
- ``partial-device-loss:step=N:keep=K`` (or ``batch=N`` / ``after=S``
  for the serving tier) — raise :class:`InjectedBackendLoss` at global
  step >= N (or before the Nth packed serve batch, 0-based, or before
  the first serve batch starting >= S seconds after the plan was built
  — the soak's mid-run chaos trigger), and make every
  device-count probe afterwards report only K surviving devices
  (:meth:`FaultPlan.device_override`) — the elastic-degradation
  injection primitive (``resilience.elastic``).
  ``down=D`` makes the first D heal-probes report fully down first
  (default 0: the survivors answer immediately — a partial loss is not
  an outage); ``restore=R`` restores full capacity after R shrunken
  device probes (default 0 = the loss persists), the re-expand tests'
  knob.
- ``hang:step=N`` — at global step >= N, sleep just past the supervisor's
  watchdog budget, then raise :class:`InjectedHang` — the
  hang-until-deadline scenario (a wedged backend that never errors).
- ``sigterm:step=N`` / ``sigterm:row=K`` — send SIGTERM to this process
  when the supervised run reaches step N / before sweep row K is
  measured. With the entry points' SIGTERM->SystemExit conversion this
  reproduces a measurement script's ``timeout`` killing a run mid-flight.
- ``corrupt-shard:save=N`` — after the Nth checkpoint-generation save
  (1-based), flip bytes in one shard file of that generation (leaving its
  checksum sidecar stale) — the corrupted-checkpoint scenario.

One-shot semantics survive process death: when ``HEAT3D_FAULT_STATE``
names a directory, a fired fault leaves a marker file there and never
fires again — so a SIGTERM'd run, restarted with the same env, resumes
instead of being killed at the same row forever. Without the state dir,
fired-ness is tracked in-process only.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

ENV_SPEC = "HEAT3D_FAULTS"
ENV_STATE = "HEAT3D_FAULT_STATE"


class InjectedFault(Exception):
    """Base for injected faults (never raised by real failures)."""


class InjectedBackendLoss(InjectedFault):
    """Simulated backend death (a mid-run loss of the device)."""


class InjectedHang(InjectedFault):
    """Simulated hang: raised only after sleeping past the watchdog."""


class _Fault:
    def __init__(self, kind: str, params: Dict[str, int], key: str):
        self.kind = kind
        self.params = params
        self.key = key  # stable id for the fired-marker file


def _parse_spec(spec: str) -> List[_Fault]:
    faults = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        pieces = part.split(":")
        kind, params = pieces[0], {}
        for kv in pieces[1:]:
            k, _, v = kv.partition("=")
            try:
                params[k] = int(v)
            except ValueError:
                raise ValueError(
                    f"{ENV_SPEC}: bad param {kv!r} in fault {part!r} "
                    "(values must be ints)"
                ) from None
        known = {
            "backend-loss": {"step", "down"},
            "partial-device-loss": {"step", "batch", "after", "keep",
                                    "down", "restore"},
            "hang": {"step"},
            "sigterm": {"step", "row"},
            "corrupt-shard": {"save"},
        }
        if kind not in known:
            raise ValueError(
                f"{ENV_SPEC}: unknown fault kind {kind!r} "
                f"(want one of {sorted(known)})"
            )
        bad = set(params) - known[kind]
        if bad:
            raise ValueError(
                f"{ENV_SPEC}: fault {kind!r} got unknown params {sorted(bad)}"
            )
        if kind == "partial-device-loss":
            # explicit validation at PARSE time: a partial loss without a
            # survivor count (or with both/neither trigger points) would
            # only fail deep inside a recovery, where the diagnosis is
            # worst
            if params.get("keep", 0) < 1:
                raise ValueError(
                    f"{ENV_SPEC}: partial-device-loss needs keep=K >= 1 "
                    "(the surviving device count)"
                )
            triggers = sum(k in params for k in ("step", "batch", "after"))
            if triggers != 1:
                raise ValueError(
                    f"{ENV_SPEC}: partial-device-loss needs exactly one "
                    "of step=N (supervised runs), batch=N, or "
                    "after=SECONDS (serve tier)"
                )
        faults.append(_Fault(kind, params, key=part.replace(":", "_")))
    return faults


class FaultPlan:
    """A parsed fault plan plus its firing state.

    All hooks are no-ops on an empty plan, so production paths pay one
    attribute check when no faults are declared.
    """

    def __init__(self, faults: Optional[List[_Fault]] = None,
                 state_dir: Optional[str] = None):
        self.faults = faults or []
        self.state_dir = state_dir
        # plan birth time: the after=SECONDS serve trigger's clock (the
        # engine builds its plan at construction, so "after" means
        # seconds into serving)
        self._t0 = time.monotonic()
        self._fired: set = set()
        self._down_probes_left = 0
        self._saves_seen = 0
        # partial-device-loss state: the survivor count device probes
        # report while the loss persists, and how many shrunken probes
        # remain before full capacity "returns" (0 = persists forever)
        self._device_keep: Optional[int] = None
        self._device_restore = 0

    @classmethod
    def from_env(cls, environ=None) -> "FaultPlan":
        env = os.environ if environ is None else environ
        spec = env.get(ENV_SPEC, "")
        state = env.get(ENV_STATE) or None
        if state:
            os.makedirs(state, exist_ok=True)
        return cls(_parse_spec(spec) if spec else [], state_dir=state)

    def __bool__(self) -> bool:
        return bool(self.faults)

    # ---- fired-marker bookkeeping ---------------------------------------

    def _has_fired(self, fault: _Fault) -> bool:
        if fault.key in self._fired:
            return True
        if self.state_dir:
            return os.path.exists(
                os.path.join(self.state_dir, fault.key + ".fired")
            )
        return False

    def _mark_fired(self, fault: _Fault, **context) -> None:
        self._fired.add(fault.key)
        if self.state_dir:
            marker = os.path.join(self.state_dir, fault.key + ".fired")
            with open(marker, "w") as f:
                f.write(str(time.time()))
        # The injection itself must be observable: fault-injection tests
        # assert the ledger records every fired fault (and the sigterm
        # fault kills the process right after — the flush-per-event ledger
        # still lands this line first). `kind_`, not `kind`: the envelope
        # owns the `kind` key (point|span).
        from heat3d_tpu_torch import obs

        obs.get().event(
            "fault_injected",
            kind_=fault.kind,
            key=fault.key,
            params=fault.params,
            **context,
        )
        obs.REGISTRY.counter(
            "faults_injected_total", "injected faults fired"
        ).inc(kind=fault.kind)

    # ---- instrumentation points -----------------------------------------

    def on_step(self, global_step: int, watchdog_s: Optional[float] = None):
        """Called by the supervised loop before launching each chunk."""
        for f in self.faults:
            if self._has_fired(f):
                continue
            if f.kind == "backend-loss" and global_step >= f.params["step"]:
                self._mark_fired(f, step=global_step)
                self._down_probes_left = f.params.get("down", 1)
                raise InjectedBackendLoss(
                    f"injected backend loss at step {global_step}"
                )
            if (
                f.kind == "partial-device-loss"
                and "step" in f.params
                and global_step >= f.params["step"]
            ):
                self._mark_fired(f, step=global_step)
                self._arm_partial(f)
                raise InjectedBackendLoss(
                    f"injected partial device loss at step {global_step} "
                    f"({f.params['keep']} device(s) survive)"
                )
            if f.kind == "hang" and global_step >= f.params["step"]:
                self._mark_fired(f, step=global_step)
                # sleep PAST the watchdog budget: the supervisor must
                # classify the overrun itself, like a real wedged chunk
                time.sleep((watchdog_s or 0.0) + 0.05)
                self._down_probes_left = 1
                raise InjectedHang(
                    f"injected hang at step {global_step} "
                    f"(watchdog {watchdog_s}s exceeded)"
                )
            if (
                f.kind == "sigterm"
                and "step" in f.params
                and global_step >= f.params["step"]
            ):
                self._mark_fired(f, step=global_step)
                self._sigterm_self()

    def on_sweep_row(self, row_index: int):
        """Called by sweep runners before measuring row ``row_index``."""
        for f in self.faults:
            if (
                f.kind == "sigterm"
                and "row" in f.params
                and row_index >= f.params["row"]
                and not self._has_fired(f)
            ):
                self._mark_fired(f, row=row_index)
                self._sigterm_self()

    def _arm_partial(self, f: _Fault) -> None:
        # down=0 by default: a PARTIAL loss is not an outage — the
        # surviving devices answer the very first heal probe, and only
        # the device-count probe reports the shrunken set
        self._down_probes_left = f.params.get("down", 0)
        self._device_keep = f.params["keep"]
        self._device_restore = f.params.get("restore", 0)

    def on_serve_batch(self, batch_index: int):
        """Called by a serve engine before executing packed batch
        ``batch_index`` (0-based count of batches started) — the serving
        tier's partial-device-loss instrumentation point. Fires on the
        batch-count trigger (``batch=N``) or the elapsed-time trigger
        (``after=S`` seconds since the plan was built — the soak's
        mid-run chaos injection)."""
        for f in self.faults:
            if f.kind != "partial-device-loss" or self._has_fired(f):
                continue
            hit_batch = (
                "batch" in f.params and batch_index >= f.params["batch"]
            )
            elapsed = time.monotonic() - self._t0
            hit_after = (
                "after" in f.params and elapsed >= f.params["after"]
            )
            if hit_batch or hit_after:
                self._mark_fired(
                    f, batch=batch_index, elapsed_s=round(elapsed, 3)
                )
                self._arm_partial(f)
                raise InjectedBackendLoss(
                    f"injected partial device loss at serve batch "
                    f"{batch_index} ({f.params['keep']} device(s) survive)"
                )

    def on_checkpoint_saved(self, gen_dir: str):
        """Called after each checkpoint generation lands on disk."""
        self._saves_seen += 1
        for f in self.faults:
            if (
                f.kind == "corrupt-shard"
                and self._saves_seen >= f.params.get("save", 1)
                and not self._has_fired(f)
            ):
                self._mark_fired(f, save=self._saves_seen, gen=gen_dir)
                corrupt_one_shard(gen_dir)

    def probe_override(self) -> Optional[str]:
        """Heal-probe hook: ``"down"`` while an injected outage persists
        (each call consumes one down-probe), None = no override (use the
        real probe)."""
        if self._down_probes_left > 0:
            self._down_probes_left -= 1
            return "down"
        return None

    def device_override(self) -> Optional[int]:
        """Survivor-count probe hook: the shrunken device count while an
        injected partial loss persists, None = no override (use the real
        ``backendprobe.probe_device_count``). With ``restore=R`` the
        override decays after R probes — full capacity "returns", the
        re-expand path's trigger."""
        if self._device_keep is None:
            return None
        keep = self._device_keep
        if self._device_restore > 0:
            self._device_restore -= 1
            if self._device_restore == 0:
                self._device_keep = None
        return keep

    @staticmethod
    def _sigterm_self():
        import signal

        os.kill(os.getpid(), signal.SIGTERM)
        # the handler fires between bytecodes; make sure it gets one
        time.sleep(5)
        raise RuntimeError("injected SIGTERM did not terminate the process")


def corrupt_one_shard(ckpt_dir: str) -> str:
    """Flip bytes in the middle of the first shard file of ``ckpt_dir``
    WITHOUT touching its checksum sidecar — the on-disk bit-rot the
    checksum verification exists to catch. Returns the corrupted path."""
    shards = sorted(
        f for f in os.listdir(ckpt_dir)
        if f.startswith("shard_") and f.endswith(".npy")
    )
    if not shards:
        raise FileNotFoundError(f"no shard files to corrupt in {ckpt_dir}")
    target = os.path.join(ckpt_dir, shards[0])
    size = os.path.getsize(target)
    # flip data bytes past the ~128-byte .npy header so np.load still
    # parses the file and only the checksum can catch the damage; the
    # clamp must stay INSIDE the file — writing at/past EOF would append
    # bytes np.load never reads and leave the fault invisible (a
    # vacuously passing corruption test)
    offset = max(min(max(size // 2, 128), size - 8), 0)
    with open(target, "r+b") as f:
        f.seek(offset)
        chunk = f.read(8)
        if not chunk:
            raise ValueError(f"shard {target} too small to corrupt ({size}B)")
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return target
