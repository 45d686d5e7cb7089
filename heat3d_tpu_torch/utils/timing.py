"""Device timing with CUDA events.

Port of ``heat3d_tpu.utils.timing``. The JAX package times a compiled
device loop on the host clock and subtracts the host round trip; here a
pair of CUDA events brackets the launches on the device's own clock, so no
round trip enters the number. A measurement that finds no CUDA device
raises: a CPU time is never reported as a device time.
"""

from __future__ import annotations

import time
from typing import Callable, List

import torch

from heat3d_tpu_torch.obs.metrics import percentile  # noqa: F401 - re-export


def cuda_time(fn: Callable[[], object], device=None) -> float:
    """Device seconds of ``fn()`` (which launches work on the current
    stream), from CUDA events recorded around it."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def force_sync(solver) -> None:
    """Wait for every stream of every CUDA device the solver's shards use
    (a shard's work may still run on its own stream); a no-op on the CPU."""
    for d in {s.device for s in solver.mesh.shards}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def sync_rtt(device=None, samples: int = 5) -> float:
    """Host seconds of one round trip to the device: a one-element launch
    and ``torch.cuda.synchronize()``, the least of ``samples`` (the JAX
    package's ``sync_overhead``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("sync_rtt needs a CUDA device")
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        x.add_(1)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    rtt = min(times)
    from heat3d_tpu_torch import obs

    obs.REGISTRY.gauge(
        "sync_rtt_seconds", "measured force_sync host round trip"
    ).set(rtt, backend="cuda")
    return rtt


def time_fn(
    fn: Callable[[], object], warmup: int = 1, iters: int = 5
) -> List[float]:
    """Per-call device seconds of ``fn()`` after ``warmup`` excluded calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return [cuda_time(fn) for _ in range(iters)]


def calibrate_trip_count(
    timed: Callable[[int], float], floor_s: float, start: int, cap: int = 20000
) -> tuple:
    """Grow a loop's trip count until one timed run lasts at least
    ``floor_s`` seconds, so per-trip times average over many launches.

    ``timed(n)`` runs n trips and returns its seconds. Returns
    ``(n, last_seconds)``; the caller may reuse the last run as a sample."""
    n = max(1, start)
    while True:
        t = timed(n)
        if t >= floor_s or n >= cap:
            return n, t
        per = max(t / n, 1e-9)
        n = min(cap, max(2 * n, int(1.1 * floor_s / per) + 1))



def maybe_profile(profile_dir, cuda=None):
    """The single profiler bracket every entry point (solver CLI, bench
    CLI, supervised runs) wraps its timed region in. Delegates to
    ``obs.perf.profiling.profile_capture``: ``torch.profiler`` capture
    plus a ``profile_capture`` ledger event recording the artifact path
    and the capture overhead — and capture failures degrade to an
    unprofiled run instead of killing it. A falsy dir is a no-op context.
    An import failure in the perf package degrades to an unprofiled run
    (one stderr note) — capture is telemetry and must never kill the entry
    point wrapping it."""
    import contextlib

    if not profile_dir:
        return contextlib.nullcontext()
    try:
        from heat3d_tpu_torch.obs.perf.profiling import profile_capture
    except Exception as e:  # noqa: BLE001 - telemetry fails soft
        import sys

        print(
            f"heat3d: profile capture unavailable ({e}); "
            "run continues unprofiled",
            file=sys.stderr,
        )
        return contextlib.nullcontext()
    return profile_capture(profile_dir, cuda=cuda)
