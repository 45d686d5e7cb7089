"""Bounded out-of-process backend probes.

Port of ``heat3d_tpu.utils.backendprobe``: every "is the backend alive /
how many devices" decision of a recovery runs in a killable child process,
never in the calling process, whose CUDA context may be the thing that
failed. The child is torch: :func:`probe_platform` reports the device type
it finds (``"cuda"`` when ``torch.cuda.is_available()``, else ``"cpu"``),
:func:`probe_device_count` ``torch.cuda.device_count()``. A caller that
started on the GPU waits for ``"cuda"`` (``wait_for_backend(want=)``, the
supervisor's ``want_platform``): a child that finds no GPU never counts as
a healed card.

One timeout knob serves all callers: ``HEAT3D_PROBE_TIMEOUT`` (seconds,
default 60).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional


def probe_timeout(default: float = 60.0) -> float:
    return float(os.environ.get("HEAT3D_PROBE_TIMEOUT", default))


# The child converts SIGTERM into a normal SystemExit so Python cleanup
# (atexit, the CUDA context's teardown) runs before the process dies when a
# probe overruns its timeout.
_SIGTERM_TO_EXIT = (
    "import signal, sys; "
    "signal.signal(signal.SIGTERM, lambda *a: sys.exit(3)); "
)


def _probe(code: str, timeout: Optional[float]) -> Optional[str]:
    """Run ``code`` in a killable child; graceful termination on timeout.

    SIGTERM first (so the child's cleanup runs), SIGKILL only if it ignores
    the grace period. Returns the last line the child printed, or None when
    it failed, timed out or printed nothing. One ``backend_probe`` ledger
    span and a ``backend_probes_total`` count per probe."""
    from heat3d_tpu_torch import obs

    budget = probe_timeout() if timeout is None else timeout
    with obs.get().span("backend_probe", timeout_s=budget) as sp:
        result = _probe_inner(code, budget)
        sp.add(ok=result is not None, result=result)
    obs.REGISTRY.counter("backend_probes_total", "out-of-process probes").inc(
        result="ok" if result is not None else "down"
    )
    return result


def _probe_inner(code: str, budget: float) -> Optional[str]:
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", _SIGTERM_TO_EXIT + code],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
    except OSError:
        return None
    try:
        out, _ = proc.communicate(timeout=budget)
    except subprocess.TimeoutExpired:
        stop_gracefully(proc)
        return None
    if proc.returncode != 0:
        return None
    lines = out.strip().splitlines()
    return lines[-1] if lines else None


def stop_gracefully(proc, grace: float = 15.0):
    """TERM, wait ``grace`` for cleanup, KILL as backstop.

    Returns ``(stdout, stderr, killed)``; ``killed`` True means the child
    ignored SIGTERM (stuck in a non-returning C call)."""
    proc.terminate()
    try:
        out, err = proc.communicate(timeout=grace)
        return out, err, False
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return out, err, True


def probe_platform(timeout: Optional[float] = None) -> Optional[str]:
    """The device type a fresh process finds ('cuda' or 'cpu'), or None if
    the child does not answer within the timeout."""
    return _probe(
        "import torch; print('cuda' if torch.cuda.is_available() else 'cpu')",
        timeout,
    )


def probe_device_count(timeout: Optional[float] = None) -> Optional[int]:
    """The CUDA devices a fresh process sees, or None if unreachable."""
    out = _probe("import torch; print(torch.cuda.device_count())", timeout)
    if out is None:
        return None
    try:
        return int(out)
    except ValueError:
        return None


def wait_for_backend(
    deadline_s: float,
    interval_s: float = 60.0,
    want: Optional[str] = "cuda",
) -> Optional[str]:
    """Probe repeatedly until the backend answers (and matches ``want`` if
    given) or ``deadline_s`` elapses. Returns the device type or None.

    The wait routes through the one RetryPolicy implementation
    (resilience.retry): 1.5x backoff capped at 5 min, sleeps clamped to
    the remaining deadline so one last probe fires right at the deadline
    edge."""
    from heat3d_tpu_torch.resilience.retry import RetryPolicy

    policy = RetryPolicy(
        base_delay_s=interval_s,
        multiplier=1.5,
        max_delay_s=300.0,
        deadline_s=deadline_s,
    )
    outcome = policy.run(
        probe_platform,
        success=lambda p: p is not None and (want is None or p == want),
    )
    return outcome.value if outcome.ok else None


def install_sigterm_exit(code: int = 3) -> None:
    """Convert SIGTERM into ``SystemExit`` in the calling process.

    Python's default SIGTERM disposition kills the process without running
    atexit or destructors; a run stopped by coreutils ``timeout`` (which
    TERMs) then exits with ``code`` after its cleanup, and a supervised run
    relaunched with the same command resumes from its generations.
    Main-thread only (signal module requirement); no-op elsewhere."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        return
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(code))


def _main() -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Bounded backend probe. Default: one probe, rc 0 and "
        "the device type printed only if the WANTED one (--platform, "
        "default cuda; 'any' accepts whatever answers) responded. --wait N "
        "keeps probing up to N seconds."
    )
    ap.add_argument("--wait", type=float, default=0.0, metavar="SECONDS")
    ap.add_argument("--interval", type=float, default=60.0)
    ap.add_argument(
        "--platform",
        default="cuda",
        help="required device type for --wait ('any' accepts whatever answers)",
    )
    args = ap.parse_args()
    want = None if args.platform == "any" else args.platform
    if args.wait > 0:
        p = wait_for_backend(args.wait, args.interval, want)
    else:
        p = probe_platform()
        if want is not None and p != want:
            p = None
    if p is None:
        return 1
    print(p)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
