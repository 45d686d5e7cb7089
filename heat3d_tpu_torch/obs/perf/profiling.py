"""Device-trace capture with ledger provenance.

``--profile DIR`` (solver CLI, bench CLI — ``--profile-dir`` stays as the
legacy spelling) brackets the timed region with ``torch.profiler``
capture: CPU activity always, CUDA activity when the run is on the card.
Capture is not free: starting the profiler takes tens of ms, stopping it
collects the device records and the export serializes the trace to disk —
both perturb the run being measured. So the bracket records its own cost:
one ``profile_capture`` ledger event at close carrying the artifact path
(the Chrome-trace JSON it wrote, ``*.pt.trace.json`` under the directory),
the start/stop overhead in seconds, and whether capture actually engaged.
A profiled bench row is then tellable from an unprofiled one in the
post-mortem, and the overhead is auditable instead of silently folded
into the measurement. ``obs/perf/timeline.py`` ``profile_phase_totals``
reads the artifact back into device ms per ``heat3d.*`` phase.

Failure posture: a profiler that cannot start (unwritable dir, a build
without profiler support, double-capture) must not kill the observed run —
the bracket degrades to a no-op and the ledger event says so
(``ok: false`` + the error). Exceptions from the BODY always propagate;
the trace is flushed (and recorded) either way, so a crashed run still
leaves its trace behind.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Optional

ARTIFACT_SUFFIX = ".pt.trace.json"


def _newest_artifact(profile_dir: str) -> Optional[str]:
    """The newest Chrome-trace JSON under ``profile_dir``, or None if
    capture left nothing."""
    try:
        files = glob.glob(
            os.path.join(profile_dir, "**", "*" + ARTIFACT_SUFFIX),
            recursive=True,
        )
        return max(files, key=os.path.getmtime) if files else None
    except OSError:
        return None


def _activities(cuda: Optional[bool]):
    """CPU always; CUDA when asked, or (``cuda=None``) when the build has
    a visible card. Nothing CUDA-only is touched on a CPU build."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda is None:
        cuda = torch.version.cuda is not None and torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class _ProfileCapture:
    def __init__(self, profile_dir: str, cuda: Optional[bool] = None):
        self.profile_dir = profile_dir
        self.cuda = cuda
        self._trace_cm = None
        self._enter_s: Optional[float] = None

    def __enter__(self) -> "_ProfileCapture":
        t0 = time.perf_counter()
        try:
            # pre-flight the target BEFORE starting the profiler: a bad
            # path (existing file, unwritable parent) otherwise surfaces
            # only at the export, after the whole run was traced
            os.makedirs(self.profile_dir, exist_ok=True)
            import torch

            cm = torch.profiler.profile(activities=_activities(self.cuda))
            cm.__enter__()
            self._trace_cm = cm
        except Exception as e:  # noqa: BLE001 - capture must fail soft
            self._error = f"{type(e).__name__}: {str(e)[:200]}"
            self._trace_cm = None
        else:
            self._error = None
        self._enter_s = time.perf_counter() - t0
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t0 = time.perf_counter()
        if self._trace_cm is not None:
            try:
                # flush with clean (None) args even when the body raised:
                # the profiler context must not mask the body's exception,
                # and a failed run's trace is exactly the one worth keeping
                self._trace_cm.__exit__(None, None, None)
                self._trace_cm.export_chrome_trace(os.path.join(
                    self.profile_dir,
                    f"heat3d-{os.getpid()}-{time.time_ns()}{ARTIFACT_SUFFIX}",
                ))
            except Exception as e:  # noqa: BLE001 - flush fails soft too
                self._error = f"{type(e).__name__}: {str(e)[:200]}"
                self._trace_cm = None
        exit_s = time.perf_counter() - t0
        from heat3d_tpu_torch import obs

        fields = {
            "dir": self.profile_dir,
            "ok": self._trace_cm is not None,
            "enter_overhead_s": self._enter_s,
            "exit_overhead_s": exit_s,
        }
        artifact = _newest_artifact(self.profile_dir)
        if artifact is not None:
            fields["artifact"] = artifact
        if self._error is not None:
            fields["error"] = self._error
            import sys

            print(
                f"heat3d: profile capture to {self.profile_dir} degraded "
                f"({self._error}); run continues unprofiled",
                file=sys.stderr,
            )
        obs.get().event("profile_capture", **fields)
        obs.REGISTRY.gauge(
            "profile_capture_overhead_seconds",
            "profiler start+stop cost around the traced region",
        ).set(self._enter_s + exit_s, ok=str(fields["ok"]).lower())
        return False  # never swallow the body's exception


def profile_capture(profile_dir: Optional[str], cuda: Optional[bool] = None):
    """The one profiler bracket every entry point wraps its timed region
    in (``utils.timing.maybe_profile`` delegates here): ``torch.profiler``
    capture into ``profile_dir`` (``cuda``: record the card's activity;
    None = when the build sees a card) + a ``profile_capture`` ledger
    event recording artifact path and capture overhead. A falsy dir is a
    plain no-op context."""
    if not profile_dir:
        return contextlib.nullcontext()
    return _ProfileCapture(profile_dir, cuda=cuda)
