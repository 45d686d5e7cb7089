"""The kernel tier's judged matrix: one small case per kernel instance.

Every CUDA kernel of the port, in every instance the solver can launch,
has a case here (``PERF.md`` §6 rows 1–12): the direct kernels at halo 1
and 2 (rows 1–2; the Mehrstellen instances 1m/2m under
``HEAT3D_MEHRSTELLEN=1``), the stream kernel and streamk at k = 1..4 (rows
3–6), the DMA halo exchange over a (2,2,2) mesh at widths 1 and 4 (rows
7–8), the fused DMA kernels over (8,1,1) (rows 9–10) and the fused RDMA
kernels over (4,1,1) with the partitioned plan's send ranges (rows 11–12):
7pt and 27pt, each compile-time instance also in bf16 compute, bf16
storage, and the generic instance forced as ``chip_smoke.py`` forces it
(``HEAT3D_FACTOR_7PT=1``). Extents are odd (37×41×43 a shard), so every
kernel runs its tails. ``judged_cases("full")`` is the same kernels at the
main path's shapes: 1024³ on one shard, (2,2,2) of 512³, (8,1,1) of
128×1024².

A :class:`Run` builds a case's inputs on a device (a seeded random field,
or each shard stamped with its rank + 1) and launches its kernel once
through the wrapper the solver calls (``launch``), into buffers the caller
may give (the coverage family's NaN sentinels), or computes the global
reference the remote family compares against (``reference``).

    python -m heat3d_tpu_torch.analysis.kernel.cases KEY [KEY ...]

launches each named case once on ``cuda:0`` between marker lines — the
child the sanitizer families run under ``compute-sanitizer`` — and exits 0
(a case that raised prints its error in its end marker, and the child
stops there: its context may be lost).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

BEGIN = "heat3d-kernel-case-begin"
END = "heat3d-kernel-case-end"

# the seeded racy kernel (seeded.cu): a case of the racecheck child only
SEEDED = "seeded-race"

# local shape of a shard at the judged scale: odd, so every tile and chunk
# loop runs its tail
SMALL = (37, 41, 43)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Case:
    """One kernel instance on one input. ``family``: direct (``depth`` =
    halo), stream (``depth`` = k), dma (``depth`` = width) or fused
    (``depth`` = updates); ``rdma`` takes the partitioned plan's send
    ranges; ``env`` the knobs that pick the instance."""

    key: str
    row: str
    wrapper: str
    family: str
    depth: int
    stencil: str = "7pt"
    storage: str = "float32"
    compute: str = "float32"
    mesh: Tuple[int, int, int] = (1, 1, 1)
    local: Tuple[int, int, int] = SMALL
    env: Tuple[Tuple[str, str], ...] = ()
    periodic: bool = False
    bc: float = 0.3
    rdma: bool = False

    @property
    def multi(self) -> bool:
        return self.mesh != (1, 1, 1)

    def instance(self) -> str:
        """The instance tag: mehrstellen, generic, or the chain."""
        env = dict(self.env)
        if env.get("HEAT3D_MEHRSTELLEN") == "1":
            return "mehrstellen"
        if env.get("HEAT3D_FACTOR_7PT") == "1":
            return "generic"
        return self.stencil


_DIRECT = {1: ("apply_taps_direct", "1"), 2: ("apply_taps_direct2", "2")}
_STREAM_ROWS = {1: "3-4", 2: "5-6", 3: "5", 4: "5"}
_FUSED = {(False, 1): ("apply_step_fused_dma", "9"),
          (False, 2): ("apply_superstep_fused_dma", "10"),
          (True, 1): ("apply_step_fused_rdma", "11"),
          (True, 2): ("apply_superstep_fused_rdma", "12")}
_GENERIC = (("HEAT3D_FACTOR_7PT", "1"),)
_MEHR = (("HEAT3D_MEHRSTELLEN", "1"),)


def _variants(mehrstellen: bool = False):
    """(tag, stencil, storage, compute, env, periodic) of one kernel's
    instances: each chain in fp32 and bf16 compute, bf16 storage, the
    generic instance forced; the Mehrstellen pair where it applies."""
    out = [("7pt", "7pt", "float32", "float32", (), False),
           ("27pt", "27pt", "float32", "float32", (), True),
           ("7pt-bf16c", "7pt", "float32", "bfloat16", (), False),
           ("27pt-bf16c", "27pt", "float32", "bfloat16", (), True),
           ("7pt-bf16", "7pt", "bfloat16", "float32", (), False),
           ("generic", "7pt", "float32", "float32", _GENERIC, False)]
    if mehrstellen:
        out += [("mehr", "27pt", "float32", "float32", _MEHR, False),
                ("mehr-bf16c", "27pt", "float32", "bfloat16", _MEHR, True)]
    return out


def judged_cases(scale: str = "small") -> List[Case]:
    """The judged matrix (``scale='small'``), or the main path's
    full-width shapes (``'full'``: fp32 7pt, the Mehrstellen instances
    27pt)."""
    if scale == "full":
        return _full_cases()
    if scale != "small":
        raise ValueError(f"unknown scale {scale!r} (small, full)")
    cases: List[Case] = []
    for h, (wrapper, row) in _DIRECT.items():
        for tag, st, sto, comp, env, per in _variants(mehrstellen=True):
            row_h = row + ("m" if env == _MEHR else "")
            cases.append(Case(f"direct{h}-{tag}", row_h, wrapper, "direct", h, st, sto, comp,
                              env=env, periodic=per))
    for k in (1, 2, 3, 4):
        wrapper = "apply_taps_stream" if k == 1 else "apply_taps_streamk"
        for tag, st, sto, comp, env, per in _variants():
            cases.append(Case(f"stream{k}-{tag}", _STREAM_ROWS[k], wrapper, "stream", k, st,
                              sto, comp, env=env, periodic=per))
    for w, row in ((1, "7"), (4, "8")):
        for storage, per in (("float32", False), ("bfloat16", True)):
            tag = "" if storage == "float32" else "-bf16"
            cases.append(Case(f"dma-w{w}-222{tag}", row, "halo_dma", "dma", w,
                              storage=storage, mesh=(2, 2, 2), periodic=per))
    for rdma, mesh in ((False, (8, 1, 1)), (True, (4, 1, 1))):
        for h in (1, 2):
            wrapper, row = _FUSED[(rdma, h)]
            name = "fused-rdma" if rdma else "fused-dma"
            for tag, st, sto, comp, env, per in _variants():
                cases.append(Case(f"{name}{h}-{''.join(map(str, mesh))}-{tag}", row, wrapper,
                                  "fused", h, st, sto, comp, mesh, env=env, periodic=per,
                                  rdma=rdma))
    return cases


def _full_cases() -> List[Case]:
    one = (1024, 1024, 1024)
    cases = [Case(f"direct{h}-7pt-full", row, w, "direct", h, local=one)
             for h, (w, row) in _DIRECT.items()]
    cases += [Case(f"direct{h}-mehr-full", row + "m", w, "direct", h, "27pt", local=one,
                   env=_MEHR) for h, (w, row) in _DIRECT.items()]
    cases += [Case(f"stream{k}-7pt-full", _STREAM_ROWS[k],
                   "apply_taps_stream" if k == 1 else "apply_taps_streamk", "stream", k,
                   local=one) for k in (1, 2, 3, 4)]
    cases += [Case(f"dma-w{w}-222-full", row, "halo_dma", "dma", w, mesh=(2, 2, 2),
                   local=(512, 512, 512), periodic=True) for w, row in ((1, "7"), (4, "8"))]
    cases += [Case(f"{'fused-rdma' if r else 'fused-dma'}{h}-811-full", _FUSED[(r, h)][1],
                   _FUSED[(r, h)][0], "fused", h, mesh=(8, 1, 1), local=(128, 1024, 1024),
                   periodic=True, rdma=r) for r in (False, True) for h in (1, 2)]
    return cases


def case_by_key(key: str) -> Case:
    for scale in ("small", "full"):
        for c in judged_cases(scale):
            if c.key == key:
                return c
    raise KeyError(f"no kernel case {key!r}")


@contextlib.contextmanager
def _env(pairs):
    old = {k: os.environ.get(k) for k, _ in pairs}
    os.environ.update(dict(pairs))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _float_zeros_from(alloc):
    """``torch.zeros`` of a floating dtype made by ``alloc`` for the block
    (the fused state allocates its landing buffers so, and builds its send
    tables from their addresses at once); every other call as it was."""
    if alloc is None:
        yield
        return
    real = torch.zeros

    def zeros(shape, *, dtype=None, device=None, **kw):
        if dtype is not None and dtype.is_floating_point and not kw:
            return alloc(tuple(shape) if not isinstance(shape, int) else (shape,), dtype,
                         device)
        return real(shape, dtype=dtype, device=device, **kw)

    torch.zeros = zeros
    try:
        yield
    finally:
        torch.zeros = real


def taps_of(stencil: str) -> np.ndarray:
    """The solver's taps of ``stencil`` on an 8³ grid (the kernels take
    any grid's; these are the ones ``chip_smoke.py`` holds them with)."""
    from heat3d_tpu_torch.core.config import GridConfig
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps

    g = GridConfig.cube(8)
    return stencil_taps(STENCILS[stencil], g.alpha, g.effective_dt(), g.spacing)


def _bc(periodic: bool):
    from heat3d_tpu_torch.core.config import BoundaryCondition

    return BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET


class Run:
    """A case's mesh, inputs and kernel on ``device`` (every shard on it,
    each on a stream of its own on a card). ``stamp``: each shard's field
    is its rank + 1 everywhere (the remote family), else a random field in
    [0, 1) drawn on the device from ``seed``."""

    def __init__(self, case: Case, device, stamp: bool = False, seed: int = 0):
        from heat3d_tpu_torch.parallel.topology import ShardMesh

        self.case = case
        self.device = torch.device(device)
        self.dtype = _DTYPES[case.storage]
        self.compute = _DTYPES[case.compute]
        self.taps = taps_of(case.stencil)
        n = case.mesh[0] * case.mesh[1] * case.mesh[2]
        self.mesh = ShardMesh(case.mesh, case.local, [self.device] * n, processes=(1, 0))
        self.stamp = stamp
        # made on the device: a 1024^3 field drawn on the host would take
        # seconds of the run
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.us = []
        for s in self.mesh.local_shards:
            if stamp:
                u = torch.full(case.local, float(s.rank + 1), device=self.device)
            else:
                u = torch.rand(case.local, generator=gen, device=self.device)
            self.us.append(u.to(self.dtype))
        self.state = None  # a fused case's state, once launched

    # ---- the buffers a launch writes --------------------------------------

    def out_shapes(self) -> List[Tuple[int, ...]]:
        """The shapes of the buffers one launch writes (per shard)."""
        if self.case.family == "dma":
            from heat3d_tpu_torch.parallel.halo import padded_shape

            return [padded_shape(self.case.local, self.case.depth)] * len(self.us)
        return [self.case.local] * len(self.us)

    def _padded(self, k: int) -> torch.Tensor:
        from heat3d_tpu_torch.parallel.plan import ExchangePlan

        plan = ExchangePlan(self.mesh, _bc(self.case.periodic), k, "ppermute", self.dtype)
        return plan.apply(self.us, self.case.bc)[0]

    def launch(self, outs: Optional[Sequence[torch.Tensor]] = None,
               alloc: Optional[Callable] = None) -> List[torch.Tensor]:
        """One launch of the case's kernel through its wrapper (the plain
        version on the CPU), into ``outs`` when given. ``alloc(shape,
        dtype, device)``, when given, makes the buffers the kernels land
        data in: a DMA case's padded blocks (the exchange's output), a
        fused case's landing buffers (its state's ``glo``/``ghi``, on a
        card; the state is kept as ``self.state``). Returns what it wrote,
        per shard."""
        c = self.case
        with _env(c.env):
            if c.family == "direct":
                from heat3d_tpu_torch.ops import stencil_direct as sd

                fn = getattr(sd, c.wrapper)
                out = None if outs is None else outs[0]
                return [fn(self.us[0], self.taps, c.periodic, c.bc, out=out,
                           compute_dtype=self.compute)]
            if c.family == "stream":
                from heat3d_tpu_torch.ops import stencil_stream as ss

                up = self._padded(c.depth)
                out = None if outs is None else outs[0]
                if c.depth == 1:
                    return [ss.apply_taps_stream(up, self.taps, out=out,
                                                 compute_dtype=self.compute)]
                return [ss.apply_taps_streamk(up, self.taps, c.depth, c.periodic, c.bc,
                                              out=out, compute_dtype=self.compute)]
            if c.family == "dma":
                return self._launch_dma(alloc)
            return self._launch_fused(outs, alloc)

    def _launch_dma(self, alloc) -> List[torch.Tensor]:
        from heat3d_tpu_torch.parallel import plan as plan_mod

        real = plan_mod.wires.allocator
        if alloc is not None:
            # the plan's float buffers (its padded blocks) from ``alloc``;
            # its flag words as the plan makes them
            plan_mod.wires.allocator = lambda kind: (
                lambda shape, dtype, device: alloc(shape, dtype, device)
                if dtype.is_floating_point else real(kind)(shape, dtype, device))
        try:
            plan = plan_mod.ExchangePlan(self.mesh, _bc(self.case.periodic), self.case.depth,
                                         "dma", self.dtype)
        finally:
            plan_mod.wires.allocator = real
        self.mesh.fork()
        pads = plan.apply(self.us, self.case.bc)
        self.mesh.join()
        return list(pads)

    def _launch_fused(self, outs, alloc=None) -> List[torch.Tensor]:
        from heat3d_tpu_torch.ops import stencil_dma_fused as fd
        from heat3d_tpu_torch.ops import stencil_fused_rdma as fr

        c = self.case
        bounds = None
        if c.rdma:
            from heat3d_tpu_torch.parallel.plan import Schedule

            # the partitioned plan's sub-blocks at floor 0: every face ships
            # in ranges, as HEAT3D_PLAN_PART_MIN_BYTES=0 makes them
            sched = Schedule(c.mesh, c.depth, "partitioned", min_part_bytes=0)
            bounds = fr.plan_send_bounds(sched, c.local,
                                         torch.empty((), dtype=self.dtype).element_size())
        with _float_zeros_from(alloc):
            state = self.state = fd.FusedState(self.mesh, c.depth, self.dtype, c.periodic,
                                               bounds)
        fn = getattr(fd, c.wrapper, None) or getattr(fr, c.wrapper)
        self.mesh.fork()
        res = fn(self.us, self.taps, self.mesh, state, c.periodic, c.bc, outs=outs,
                 compute_dtype=self.compute)
        self.mesh.join()
        return list(res)

    # ---- the remote family's reference -------------------------------------

    def reference(self) -> List[torch.Tensor]:
        """What each shard's buffers must hold after one launch, from the
        global field (the shards stitched by their origins) and the plain
        chain over it — independent of the exchange's neighbour logic: a
        DMA case's padded blocks cut from the global padded field; a
        stencil case's outputs, ``depth`` plain updates (bc pinned between
        them) of the global field."""
        from heat3d_tpu_torch.parallel.halo import exchange_halo
        from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded

        c = self.case
        g = torch.empty(tuple(m * n for m, n in zip(c.mesh, c.local)), dtype=self.dtype,
                        device=self.device)
        for s, u in zip(self.mesh.local_shards, self.us):
            g[tuple(slice(o, o + n) for o, n in zip(s.origin, c.local))] = u
        if c.family == "dma":
            w = c.depth
            gp = exchange_halo(g, _bc(c.periodic), c.bc, w)
            return [gp[tuple(slice(o, o + n + 2 * w) for o, n in zip(s.origin, c.local))]
                    for s in self.mesh.local_shards]
        with _env(c.env):
            for _ in range(c.depth if c.family == "fused" else 1):
                gp = exchange_halo(g, _bc(c.periodic), c.bc, 1)
                g = apply_taps_padded(gp, self.taps, mehrstellen=False,
                                      compute_dtype=self.compute)
        return [g[tuple(slice(o, o + n) for o, n in zip(s.origin, c.local))]
                for s in self.mesh.local_shards]


# ---- the sanitizer child ---------------------------------------------------


def seeded_race(device="cuda:0") -> torch.Tensor:
    """Launch the seeded racy kernel (``seeded.cu``) once; CUDA only."""
    import ctypes

    from heat3d_tpu_torch.ops import _build

    lib = _build.load("seeded_race")
    lib.heat3d_seeded_race_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.heat3d_seeded_race_launch.restype = ctypes.c_int
    out = torch.empty(lib.heat3d_seeded_race_threads(), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.heat3d_seeded_race_launch(out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"seeded racy kernel launch failed: error {err}")
    return out


def _raise_if_timed_out() -> None:
    from heat3d_tpu_torch.ops import halo_dma
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    halo_dma.raise_if_timed_out()
    fd.raise_if_timed_out()


def run_child(keys: Sequence[str], device: str = "cuda:0", out=None) -> int:
    """Launch each case once between marker lines (flushed, so the
    sanitizer's report of a case falls between its markers); stop after a
    case that raised. Under a tool the kernels' bounded waits take
    ``HEAT3D_KERNEL_LINT_TIMEOUT_S`` (the tool serialises launches)."""
    from heat3d_tpu_torch.ops import halo_dma
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    out = out or sys.stdout
    bound_s = float(os.environ.get("HEAT3D_KERNEL_LINT_TIMEOUT_S", "600"))
    halo_dma.TIMEOUT_NS = fd.TIMEOUT_NS = int(bound_s / 2 * 1e9)
    for key in keys:
        print(f"{BEGIN} {key}", file=out, flush=True)
        try:
            if key == SEEDED:
                seeded_race(device)
            else:
                Run(case_by_key(key), device).launch()
            torch.cuda.synchronize(device)
            _raise_if_timed_out()
        except Exception as e:  # noqa: BLE001 - reported to the parent
            msg = " ".join(f"{type(e).__name__}: {e}".split())[:300]
            print(f"{END} {key} raised {msg}", file=out, flush=True)
            return 0
        print(f"{END} {key} ok", file=out, flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    return run_child(argv)


if __name__ == "__main__":
    sys.exit(main())
