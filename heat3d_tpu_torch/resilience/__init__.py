"""Resilience: survive the environment, test the failure paths.

Port of ``heat3d_tpu.resilience`` (the same modules, names and knobs):

- ``retry``      — the ONE retry/backoff implementation (jittered
                   exponential backoff, deadline budgets, structured
                   outcome records); ``utils.backendprobe.wait_for_backend``
                   and the supervisor's heal waits route through it.
- ``faults``     — deterministic fault injection (``HEAT3D_FAULTS``:
                   backend-loss-at-step-N, partial device loss,
                   hang-until-deadline, SIGTERM mid-run or mid-sweep,
                   corrupted checkpoint shard) so every retry/resume path
                   runs under pytest on CPU.
- ``supervisor`` — the supervised run loop: checkpoint every K steps into
                   checksummed generations, watchdog the backend,
                   quarantine corrupt generations, resume from the last
                   good one when the backend heals.
- ``elastic``    — the survivor-mesh re-plan of a supervised run
                   (``HEAT3D_HEAL_MODE``, ``HEAT3D_HEAL_DEADLINE_S``).
- ``sweepstate`` — per-row sweep state so an interrupted bench sweep
                   resumes at the first missing row (``--sweep-state``).
"""

from heat3d_tpu_torch.resilience.retry import RetryOutcome, RetryPolicy
from heat3d_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedBackendLoss,
    InjectedFault,
)
from heat3d_tpu_torch.resilience.sweepstate import SweepState
from heat3d_tpu_torch.resilience.supervisor import SupervisedResult, run_supervised

__all__ = [
    "FaultPlan",
    "InjectedBackendLoss",
    "InjectedFault",
    "RetryOutcome",
    "RetryPolicy",
    "SupervisedResult",
    "SweepState",
    "run_supervised",
]
