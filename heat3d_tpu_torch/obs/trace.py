"""Named phases: attribute device time to *our* phases.

A ``torch.profiler`` trace of the solver shows raw kernel and op names
(``direct_kernel<...>``, ``aten::copy_``) — useless for answering "how much
of the step is halo exchange vs stencil compute vs fused-DMA wait". These
helpers bracket the phase boundaries the roofline analysis cares about:

- :func:`named_phase` — a ``torch.profiler.record_function`` range under
  the ``heat3d.`` prefix, plus an NVTX range (``torch.cuda.nvtx``) when the
  torch build has CUDA. Every kernel launched inside it is tied to the
  range through its launch record's correlation id, so
  ``obs/perf/timeline.py``'s ``device_phase_totals`` can group device time
  by phase instead of by kernel.
- :func:`annotate` — the same range, for HOST-side runtime regions
  (warmup, checkpoint IO, heal waits).

Unlike a trace-time scope these run on every call, on the host: the
``record_function`` range is entered only while a profiler is collecting
(a flag read otherwise), the NVTX push/pop always costs about a
microsecond. So bracket phases (one range per phase per step call), never
single launches.

Phase names used by the step builders (the contract the
``obs/perf/timeline.py`` phase tables and the profile→roofline join
group by — canonical list: ``parallel.step.PHASES``):

- ``heat3d.step`` (the whole step/superstep call — launch glue
  attributes here instead of ``(unattributed)``)
- ``heat3d.halo_exchange`` (and ``heat3d.halo.<axis>`` per axis)
- ``heat3d.stencil``
- ``heat3d.fused_dma``
- ``heat3d.residual``

``torch`` is imported at the first range, not with this module, and
nothing CUDA-only is touched on a build without CUDA, so the obs package
stays importable (and its CLI cheap) anywhere.
"""

from __future__ import annotations

import contextlib

PHASE_PREFIX = "heat3d."

# (record_function, profiler_enabled, nvtx module or None), resolved once
_HOOKS = None


def _hooks():
    global _HOOKS
    if _HOOKS is None:
        try:
            import torch
            from torch._C._autograd import _profiler_enabled

            nvtx = None
            # the build's CUDA, not a device: a CPU-only torch has no NVTX
            if torch.version.cuda is not None and torch.cuda.is_available():
                try:
                    torch.cuda.nvtx.range_push(PHASE_PREFIX + "probe")
                    torch.cuda.nvtx.range_pop()
                    nvtx = torch.cuda.nvtx
                except (RuntimeError, AttributeError):
                    nvtx = None  # a build without NVTX: record_function only
            _HOOKS = (torch.profiler.record_function, _profiler_enabled, nvtx)
        except (ImportError, AttributeError):
            _HOOKS = (None, None, None)
    return _HOOKS


class _Phase:
    """One ``heat3d.*`` range: ``record_function`` while a profiler
    collects, NVTX on a CUDA build."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        record_function, enabled, nvtx = _hooks()
        if record_function is not None and enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        if nvtx is not None:
            nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        nvtx = _HOOKS[2]
        if nvtx is not None:
            nvtx.range_pop()
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        return False


def named_phase(name: str):
    """A ``heat3d.<name>`` range around the launches of one phase."""
    if not name.startswith(PHASE_PREFIX):
        name = PHASE_PREFIX + name
    if _hooks()[0] is None:
        return contextlib.nullcontext()
    return _Phase(name)


def annotate(name: str):
    """A ``heat3d.<name>`` range for host-side runtime regions — visible on
    the host timeline when a profiler trace is being captured; a cheap
    context either way."""
    return named_phase(name)


def scoped(name: str, fn):
    """``fn`` wrapped in :func:`named_phase` — for decorating a built step
    callable without restructuring it."""

    def wrapper(*args, **kwargs):
        with named_phase(name):
            return fn(*args, **kwargs)

    return wrapper
