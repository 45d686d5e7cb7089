"""The one driver of every traffic mix: it builds the cell's solver through
the configuration's system module, makes the initial field from the seed,
warms up, and drives the system's public entry through the window, in
chunks, through the mix's entry module.

A mix (``mixes/<name>.json``, data only) gives:

- ``entry``: the module of ``entries/`` that drives one chunk;
- ``run``: the program's run settings (its ``RunConfig``), such as
  ``residual_every``;
- ``chunk_updates``: the updates of one call in the window;
- ``start_updates``: the updates of the first call, from the seed's field,
  in set-up; its answer is checked (the start);
- ``check_chunk_max``: the checked window chunk is drawn from the seed out
  of the first this many;
- ``profile_at`` and ``profile_s``: in a traced run the profiler opens at
  the first chunk boundary past this share of the window (and past the
  checked chunk) and closes after ``profile_s`` seconds, or half the
  window, whichever is shorter;
- the entry's own keys (its ``PARAMS``).

Any other key is refused. The window starts after a synchronize and ends
in one; the host queues at most one chunk ahead of the card, so the host
clock follows the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from portbench import cells, data, timeline

MIX_KEYS = {"entry", "run", "chunk_updates", "start_updates", "check_chunk_max",
            "profile_at", "profile_s"}


def check_mix(mix: dict):
    """The mix's entry module, once every key of the mix is accounted for."""
    entry = cells.entry(mix)
    extra = sorted(set(mix) - MIX_KEYS - entry.PARAMS)
    if extra:
        raise ValueError(f"mix keys {extra} are read by neither portbench/drive.py nor "
                         f"portbench/entries/{mix['entry']}.py")
    return entry


def launch_count() -> int:
    from heat3d_tpu_torch import ops

    return sum(ops.launch_counts().values())


@dataclasses.dataclass
class Run:
    setup_s: float
    solver_init_s: float
    window_s: float
    updates: int
    chunks: int
    launches: int
    memory_peak_bytes: int  # the program's peak up to the window's close
    window_peak_bytes: int  # the program's peak in the window
    start: torch.Tensor  # the field after the start call
    start_residual: Optional[float]
    sample_chunk: int
    sample_in: torch.Tensor
    sample_out: torch.Tensor
    sample_residual: Optional[float]
    profiled_updates: int = 0
    activity: Optional[Dict[str, Any]] = None
    # set-up's parts, host seconds: before the solver (imports, the CUDA
    # context), the solver, the field, the benchmark's copies, the start
    # call, the warm-up call
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)


class _Clock:
    """Synchronize and mark the stream of ``device``; on the CPU both are
    no-ops (the tests drive the plain versions there)."""

    def __init__(self, device: str):
        self.cuda = device == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev


def drive(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device: str,
          t_start: float, make_solver=None, grid=None) -> Run:
    """One run of the cell: set-up, then the window. ``t_start`` is the
    process's start on the host clock; ``make_solver`` (with the signature
    of a system's ``solver``) stands another solver in the program's place:
    the control, the tests' faults."""
    system, entry = cells.system(config), check_mix(mix)
    clock = _Clock(device)
    shape = tuple(grid or config["grid"])
    n = int(mix["chunk_updates"])
    j = data.check_chunk(seed, int(mix["check_chunk_max"]))
    dtype = getattr(torch, config["storage"])
    t_init = time.perf_counter()
    solver = (make_solver or system.solver)(config, mix.get("run", {}), device, grid)
    t_solver = time.perf_counter()
    u = system.state(solver, data.initial_field(seed, shape, device, dtype))
    clock.sync()
    t_field = time.perf_counter()
    # the benchmark's own copies of what it checks, shaped as the system's
    # field, made before the first call
    snaps = [torch.empty_like(system.field(solver, u)) for _ in range(3)]
    start, sample_in, sample_out = snaps
    clock.sync()
    t_copies = time.perf_counter()

    def chunk(u, n):
        return entry.chunk(solver, u, n, mix)

    u, _, start_residual = chunk(u, int(mix["start_updates"]))
    start.copy_(system.field(solver, u))
    clock.sync()
    t_first = time.perf_counter()
    solver_init_s = (t_field - t_init) + (t_first - t_copies)
    u, _, _ = chunk(u, n)  # this cell's shapes, as the window runs them
    clock.sync()
    parts = {"before": t_init - t_start, "solver": t_solver - t_init,
             "field": t_field - t_solver, "copies": t_copies - t_field,
             "start_call": t_first - t_copies,
             "warm_up": time.perf_counter() - t_first}

    cuda = device == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    launches0 = launch_count()
    chunks = updates = 0
    sample_residual = None
    prof = rng = None
    prof_open, prof_updates = 0.0, 0
    profile_s = min(float(mix["profile_s"]), 0.5 * seconds)
    profiled_updates, prof_done = 0, not trace
    pending = None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        elapsed = time.perf_counter() - t0
        if (prof is None and not prof_done and chunks >= j
                and elapsed >= float(mix["profile_at"]) * seconds):
            clock.sync()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            prof.start()
            rng = torch.profiler.record_function(timeline.WINDOW)
            rng.__enter__()
            prof_open, prof_updates = time.perf_counter(), updates
        if chunks + 1 == j:
            sample_in.copy_(system.field(solver, u))
        u, done, residual = chunk(u, n)
        chunks += 1
        updates += done
        if chunks == j:
            sample_out.copy_(system.field(solver, u))
            sample_residual = residual
        mark = clock.mark()
        if pending is not None:
            pending.synchronize()
        pending = mark
        now = time.perf_counter()
        if prof is not None and not prof_done and now - prof_open >= profile_s:
            clock.sync()
            rng.__exit__(None, None, None)
            prof.stop()
            profiled_updates, prof_done = updates - prof_updates, True
        if now - t0 >= seconds and chunks >= j and prof_done:
            break
    clock.sync()
    window_s = time.perf_counter() - t0
    launches = launch_count() - launches0
    # the snapshots live from before the first call to after the window, so
    # the program's own peak is the process's less their bytes
    snap_bytes = sum(s.numel() * s.element_size() for s in snaps)
    window_peak = torch.cuda.max_memory_allocated() - snap_bytes if cuda else 0
    memory_peak = max(setup_peak - snap_bytes, window_peak) if cuda else 0

    activity = None
    if prof is not None:
        activity = _read_trace(prof)
    # the program's state goes before the reference runs
    del solver, chunk, u
    if cuda:
        torch.cuda.empty_cache()
    return Run(setup_s=setup_s, solver_init_s=solver_init_s, window_s=window_s,
               updates=updates, chunks=chunks, launches=launches,
               memory_peak_bytes=memory_peak, window_peak_bytes=window_peak,
               start=start, start_residual=start_residual, sample_chunk=j,
               sample_in=sample_in, sample_out=sample_out, sample_residual=sample_residual,
               profiled_updates=profiled_updates, activity=activity, setup_parts=parts)


def _read_trace(prof) -> Optional[Dict[str, Any]]:
    """The profiled window's device activity, through a Chrome trace
    written under ``TMPDIR`` and removed."""
    import json
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(doc, list):
        doc = {"traceEvents": doc}
    return timeline.activity(doc)
