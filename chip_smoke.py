#!/usr/bin/env python3
"""On-card smoke test of heat3d_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Phases, each printing its own lines:

1. identify the card (nvidia-smi name and power limit, torch and CUDA);
2. build the CUDA kernels from ``heat3d_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print the compiler's resource report
   and the streamk kernels' dynamic shared memory;
3. hold each kernel against its plain PyTorch version on the card, bitwise,
   for 7pt/27pt x Dirichlet (bc 0 and 0.3)/periodic x fp32/bf16 storage at
   ragged shapes, 128^3 (the golden phase's grid) and 256^3: the direct
   kernels (tb 1 and 2), the stream kernel and streamk at k = 2, 3, 4 over
   the halo exchange; also the streamk plain version against k direct
   kernel launches, and the exchange-path solve of k steps against the
   direct-path solve, both bitwise;
4. the main path against the fp64 golden oracle: the solver command line
   at 128^3, 20 steps, 7pt and 27pt, ``--golden-check``, at tb 1, 2, 3 and
   4, and with ``HEAT3D_NO_DIRECT=1`` (the exchange path) at tb 1 and 2;
5. the main path at full width: ``bench_throughput`` at 1024^3 (fp32 7pt
   tb=2, the headline config; fp32 7pt tb=1; fp32 27pt tb=2; bf16 7pt
   tb=2; then the exchange path: fp32 7pt tb=4, tb=3 and tb=1 under
   ``HEAT3D_NO_DIRECT``, fp32 27pt tb=4, bf16 7pt tb=4) with
   Gcell-updates/s, ms per superstep, the redundant-flops fraction and the
   end-to-end bound, and periodic 1024^3 runs (tb=2 and tb=4, 11 steps)
   held to conservation of sum(u);
6. kernel and plain-version times at 256^3 and 1024^3 fp32 7pt, each
   kernel held bitwise to its plain version there (also with bc 0.3,
   periodic, 27pt and bf16 storage: the full-width phase's settings), the
   halo exchange's time at each width, and the library call's time
   (F.conv3d, no TF32) over the same input as the tb=1 and the stream
   kernel, held to them within a stated rounding bound.

The kernel launch counts are zeroed just before phase 4 and read just after
phase 5; the script fails if any kernel was not launched there. The last
three lines are the kernels' JSON object (``{"kernels": [...]}``), the
nvidia-smi line, and the status object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

# Peak rates of the card (published, SXM H100 at 700 W unless the name says
# otherwise): device-memory bytes/s by name fragment, fp32 non-tensor FLOP/s.
_BANDWIDTH = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
_FP32_FLOPS = 67e12

_SOURCES = {
    "apply_taps_direct": "heat3d_tpu_torch/csrc/stencil_direct.cu",
    "apply_taps_direct2": "heat3d_tpu_torch/csrc/stencil_direct.cu",
    "apply_taps_stream": "heat3d_tpu_torch/csrc/stencil_stream.cu",
    "apply_taps_streamk": "heat3d_tpu_torch/csrc/stencil_stream.cu",
}
_REPLACES = {
    "apply_taps_direct": "heat3d_tpu/ops/stencil_pallas_direct.py:422",
    "apply_taps_direct2": "heat3d_tpu/ops/stencil_pallas_direct.py:656",
    "apply_taps_stream": "heat3d_tpu/ops/stencil_pallas.py:257, "
                         "heat3d_tpu/ops/stencil_pallas.py:797",
    "apply_taps_streamk": "heat3d_tpu/ops/stencil_pallas.py:694, "
                          "heat3d_tpu/ops/stencil_pallas.py:451",
}
KERNELS = tuple(_SOURCES)
# the depth whose time stands in the kernels' line for streamk: the
# full-width phase's headline exchange-path config (tb=4)
_STREAMK_HEADLINE = 4
_BCS = ((False, 0.0), (False, 0.3), (True, 0.0))


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def _say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


@contextlib.contextmanager
def _no_direct(on: bool):
    """``HEAT3D_NO_DIRECT=1`` (the exchange path) for the block when ``on``."""
    if not on:
        yield
        return
    os.environ["HEAT3D_NO_DIRECT"] = "1"
    try:
        yield
    finally:
        del os.environ["HEAT3D_NO_DIRECT"]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bandwidth(name: str) -> float:
    for frag, bw in _BANDWIDTH:
        if frag in name:
            return bw
    raise RuntimeError(f"no bandwidth on record for {name!r}")


def _taps(kind: str, n: int = 8):
    """The solver's taps for stencil ``kind`` on an n^3 grid."""
    from heat3d_tpu_torch.core.config import GridConfig
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps

    g = GridConfig.cube(n)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


def _bc(periodic: bool):
    from heat3d_tpu_torch.core.config import BoundaryCondition

    return BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET


def flops_per_update(taps) -> int:
    """fp32 operations per cell and update of the tap chain, with the plane
    and row sums counted once (as the plain version caches them)."""
    from heat3d_tpu_torch.ops.stencil_direct import emission_program

    prog = emission_program(taps)
    sums = {("x",)} if any(s == 3 for s, _, _, _ in prog) else set()
    sums |= {("y", s) for s, r, _, _ in prog if r == 3}
    return 2 * len(prog) - 1 + len(sums)


def trapezoid_cells(n: int, k: int) -> int:
    """Cells one k-update superstep of an n^3 block computes: update j of k
    covers the extent still carrying r = k-1-j ghost rings (the raw
    trapezoid of ``streamk_cost_estimate``)."""
    return sum((n + 2 * r) ** 3 for r in range(k))


def bound_ms(bytes_moved: float, ops: float, bw: float):
    """Least time on the card: the bytes at its memory rate or the
    operations at its fp32 rate, whichever is larger."""
    t_bytes = bytes_moved / bw * 1e3
    t_ops = ops / _FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound(name: str, n: int, k: int, itemsize: int, flops: int, bw: float):
    """Bound of one launch at n^3: the kernel's input read once and its
    output written once; the updates it computes (the raw trapezoid for
    streamk)."""
    if name in ("apply_taps_direct", "apply_taps_direct2"):
        return bound_ms(2 * n**3 * itemsize, n**3 * k * flops, bw)
    return bound_ms(((n + 2 * k) ** 3 + n**3) * itemsize,
                    trapezoid_cells(n, k) * flops, bw)


def superstep_bound(route: str, n: int, k: int, itemsize: int, flops: int, bw: float):
    """Bound of one superstep (or step) of the solve at n^3: the direct
    kernels read and write the field once; the exchange path also writes
    the width-k padded copy and reads the field for it (four field
    passes)."""
    if route in ("direct", "direct2"):
        return bound_ms(2 * n**3 * itemsize, n**3 * k * flops, bw)
    padded = (n + 2 * k) ** 3
    return bound_ms(2 * (n**3 + padded) * itemsize, trapezoid_cells(n, k) * flops, bw)


def phase_identify() -> str:
    import torch

    smi = nvidia_smi()
    _say("identify", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from heat3d_tpu_torch.ops import _build
    from heat3d_tpu_torch.ops import stencil_stream as ss

    seconds = _build.build_all()
    _say("build", seconds=seconds)
    for name in seconds:
        print(_build.build_log(name).strip(), flush=True)
    _say("build", streamk_dynamic_smem_bytes={
        k: ss.streamk_smem_bytes(k) for k in ss.STREAMK_DEPTHS})


def _kernel_input(name, u, periodic, bcv, k):
    """What ``name``'s kernel reads: the field itself for the direct
    kernels, its width-k halo exchange for the exchange-path kernels."""
    from heat3d_tpu_torch.parallel.halo import exchange_halo

    if name in ("apply_taps_direct", "apply_taps_direct2"):
        return u
    return exchange_halo(u, _bc(periodic), bcv, k)


def _kernel_pair(name, k):
    """``name``'s kernel and its plain version, both called as
    ``f(x, taps, periodic, bc_value)`` on ``_kernel_input``'s ``x`` (the
    kernel also takes ``out=``)."""
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss
    from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded

    if name == "apply_taps_direct":
        return sd.apply_taps_direct, sd.apply_taps_direct_ref
    if name == "apply_taps_direct2":
        return sd.apply_taps_direct2, sd.apply_taps_direct2_ref
    if name == "apply_taps_stream":
        return (lambda x, t, p, b, out=None: ss.apply_taps_stream(x, t, out=out),
                lambda x, t, p, b: apply_taps_padded(x, t))
    return (lambda x, t, p, b, out=None: ss.apply_taps_streamk(x, t, k, p, b, out=out),
            lambda x, t, p, b: ss.apply_taps_streamk_ref(x, t, k, p, b))


def _run_kernel(name, u, taps, periodic, bcv, k=1):
    """(kernel output, plain output) of ``name`` on field ``u``."""
    kern, plain = _kernel_pair(name, k)
    x = _kernel_input(name, u, periodic, bcv, k)
    return kern(x, taps, periodic, bcv), plain(x, taps, periodic, bcv)


def _cases():
    """(kernel name, k) of every kernel instance."""
    from heat3d_tpu_torch.ops.stencil_stream import STREAMK_DEPTHS

    return ([("apply_taps_direct", 1), ("apply_taps_direct2", 2), ("apply_taps_stream", 1)]
            + [("apply_taps_streamk", k) for k in STREAMK_DEPTHS])


def _hold(worst: dict, name: str, got, want, what: str) -> None:
    """Fail unless kernel output ``got`` equals plain output ``want``
    bitwise; fold |got - want| into ``worst[name]``."""
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    worst[name] = max(worst[name], err)
    _check(torch.equal(got, want), f"{name} != plain {what}: max err {err}")


def _solve(n: int, kind: str, storage: str, periodic: bool, bcv: float, tb: int,
           steps: int, no_direct: bool = False):
    from heat3d_tpu_torch.core.config import (
        GridConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    cfg = SolverConfig(
        grid=GridConfig.cube(n),
        stencil=StencilConfig(kind=kind, bc=_bc(periodic), bc_value=bcv),
        precision=Precision(storage=storage), time_blocking=tb,
    )
    with _no_direct(no_direct):
        solver = HeatSolver3D(cfg)
        return solver.run(solver.init_state("random"), steps)


def phase_compare() -> dict:
    """Each kernel against its plain version on the card, bitwise; the
    streamk plain version against k direct launches; and the exchange-path
    solve against the direct-path solve. Returns the largest
    |kernel - plain| of each kernel (0.0 when bitwise)."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss
    from heat3d_tpu_torch.parallel.halo import exchange_halo

    worst = {k: 0.0 for k in KERNELS}
    n = chained = 0
    for shape in ((33, 17, 129), (64, 72, 200), (128, 128, 128), (256, 256, 256)):
        base = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in _BCS:
                    what = f"at {shape} {dtype} {kind} periodic={periodic} bc={bcv}"
                    for name, k in _cases():
                        got, want = _run_kernel(name, u, taps, periodic, bcv, k)
                        _hold(worst, name, got, want, f"k={k} {what}")
                        n += 1
                    for k in ss.STREAMK_DEPTHS:
                        want = u
                        for _ in range(k):
                            want = sd.apply_taps_direct(want, taps, periodic, bcv)
                        got = ss.apply_taps_streamk_ref(
                            exchange_halo(u, _bc(periodic), bcv, k), taps, k, periodic, bcv)
                        torch.cuda.synchronize()
                        _check(torch.equal(got, want),
                               f"streamk plain != {k} direct launches {what}")
                        chained += 1
            del u
        torch.cuda.empty_cache()
    solves = 0
    for k in (1, 2, 3, 4):
        for kind in ("7pt", "27pt"):
            for storage in ("float32", "bfloat16"):
                for periodic, bcv in ((False, 0.3), (True, 0.0)):
                    want = _solve(128, kind, storage, periodic, bcv, 1, k)
                    got = _solve(128, kind, storage, periodic, bcv, k, k, no_direct=True)
                    torch.cuda.synchronize()
                    _check(torch.equal(got, want),
                           f"exchange-path solve != direct solve: k={k} {kind} "
                           f"{storage} periodic={periodic}")
                    solves += 1
    _say("compare", cases=n, bitwise=True, max_abs_err=worst,
         streamk_plain_vs_direct_launches=chained, exchange_vs_direct_solves=solves,
         launches=ops.launch_counts())
    return worst


# (stencil, time_blocking, HEAT3D_NO_DIRECT) of the golden phase, with the
# kernel each must launch
_GOLDEN = (
    (1, False, "apply_taps_direct"), (2, False, "apply_taps_direct2"),
    (3, False, "apply_taps_streamk"), (4, False, "apply_taps_streamk"),
    (1, True, "apply_taps_stream"), (2, True, "apply_taps_streamk"),
)


def phase_golden() -> None:
    from heat3d_tpu_torch import cli

    for kind in ("7pt", "27pt"):
        for tb, no_direct, want in _GOLDEN:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), _no_direct(no_direct):
                rc = cli.main(["--grid", "128", "--steps", "20", "--stencil", kind,
                               "--time-blocking", str(tb), "--golden-check"])
            _check(rc == 0, f"solver CLI {kind} tb={tb} no_direct={no_direct} exited {rc}")
            summary = json.loads(buf.getvalue().strip().splitlines()[-1])
            _check(summary["golden_pass"], f"golden check failed: {summary}")
            _check(summary["kernel_launches"][want] > 0,
                   f"{want} not launched: {summary}")
            _say("golden", stencil=kind, time_blocking=tb, no_direct=no_direct,
                 steps=summary["steps"], golden_pass=summary["golden_pass"],
                 golden_rel_err=summary["golden_rel_err"],
                 kernel_launches=summary["kernel_launches"])


# (stencil, time_blocking, storage, HEAT3D_NO_DIRECT) of the full-width phase
_FULL_WIDTH = (
    ("7pt", 2, "float32", False), ("7pt", 1, "float32", False),
    ("27pt", 2, "float32", False), ("7pt", 2, "bfloat16", False),
    ("7pt", 4, "float32", False), ("7pt", 3, "float32", False),
    ("7pt", 1, "float32", True), ("27pt", 4, "float32", False),
    ("7pt", 4, "bfloat16", False),
)


def phase_full_width(bw: float) -> None:
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import (
        GridConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    n = 1024
    for kind, tb, storage, no_direct in _FULL_WIDTH:
        cfg = SolverConfig(
            grid=GridConfig.cube(n), stencil=StencilConfig(kind=kind),
            precision=Precision(storage=storage), time_blocking=tb,
        )
        with _no_direct(no_direct):
            row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3)
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
        b_ms, by = superstep_bound(route, n, tb, itemsize, flops_per_update(_taps(kind)), bw)
        _check(sum(row["kernel_launches"].values()) > 0, f"no launches: {row}")
        _say("full_width", grid=row["grid"], stencil=kind, dtype=storage,
             time_blocking=tb, no_direct=no_direct, route=route,
             steps=row["steps"], gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"],
             cost_redundant_flops_frac=row["cost_redundant_flops_frac"],
             bound_ms_per_superstep=b_ms, bound_by=by,
             bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
        del row
        torch.cuda.empty_cache()

    for tb in (2, 4):
        cfg = SolverConfig(
            grid=GridConfig.cube(n),
            stencil=StencilConfig(kind="7pt", bc=_bc(True)),
            time_blocking=tb,
        )
        solver = HeatSolver3D(cfg)
        u = solver.init_state("hot-cube")
        s0 = float(u.double().sum())
        u = solver.run(u, 11)
        s1 = float(u.double().sum())
        finite = bool(torch.isfinite(u).all())
        rel = abs(s1 - s0) / s0
        _check(finite and rel < 1e-5,
               f"periodic tb={tb} sum drifted: {s0} -> {s1} ({rel})")
        _say("conservation", grid=[n, n, n], time_blocking=tb, steps=11,
             sum_before=s0, sum_after=s1, rel_drift=rel, finite=finite)
        del u, solver
        torch.cuda.empty_cache()


def _time_ms(fn, iters: int = 5) -> float:
    from heat3d_tpu_torch.utils.timing import time_fn

    return min(time_fn(fn, warmup=1, iters=iters)) * 1e3


def _library_check(name: str, got, lib_out, taps, u) -> dict:
    """Hold the library call to a kernel: both sides sum at most 27 fp32
    products in their own order, each within 28 * 2^-24 * sum|w| * max|u|
    of the exact sum."""
    import numpy as np

    err = float((lib_out - got).abs().max())
    tol = 2 * 28 * 2.0**-24 * float(np.abs(taps).sum()) * float(u.abs().max())
    _check(err <= tol, f"library call disagrees with {name}: {err} > {tol}")
    return {f"library_vs_{name}_max_abs_err": err, f"library_vs_{name}_tol": tol}


def phase_kernel_times(bw: float, worst: dict) -> dict:
    """Kernel and plain-version times at 256^3 and 1024^3 fp32 7pt, with
    each kernel held bitwise to its plain version at those sizes (7pt fp32
    with bc 0, 0.3 and periodic, 27pt fp32 and 7pt bf16: the settings the
    full-width phase gives the kernels), folding the errors into
    ``worst``; the halo exchange's time at each width; and the library
    call (one cuDNN convolution, TF32 off, never called by the port) over
    the same input as the tb=1 kernel and the stream kernel, held to both
    within a rounding bound. Returns the 1024^3 numbers of each kernel
    (streamk at its headline depth)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from heat3d_tpu_torch.parallel.halo import exchange_halo

    times = {}
    for n in (256, 1024):
        taps = _taps("7pt", n)
        flops = flops_per_update(taps)
        u = torch.rand((n, n, n), device="cuda")
        out = torch.empty_like(u)
        times[n] = {}
        exchange_ms = {}
        cases = 0
        for name, k in _cases():
            key = name if name != "apply_taps_streamk" else f"{name}_k{k}"
            kern, plain = _kernel_pair(name, k)
            x = _kernel_input(name, u, False, 0.0, k)
            if x is not u:
                exchange_ms[k] = _time_ms(
                    lambda: exchange_halo(u, _bc(False), 0.0, k, out=x), iters=5)
            ms = _time_ms(lambda: kern(x, taps, False, 0.0, out=out), iters=10)
            plain_ms = _time_ms(lambda: plain(x, taps, False, 0.0), iters=3)
            # ``out`` holds the last timed launch's result
            _hold(worst, name, out, plain(x, taps, False, 0.0),
                  f"k={k} at {n}^3 7pt float32 bc=0.0")
            if name == "apply_taps_direct":
                direct_out = out.clone()
            elif name == "apply_taps_stream":
                up1, stream_out = x, out.clone()
            del x
            for kind, dtype, periodic, bcv in (
                ("7pt", torch.float32, False, 0.3), ("7pt", torch.float32, True, 0.0),
                ("27pt", torch.float32, False, 0.0), ("7pt", torch.bfloat16, False, 0.0),
            ):
                v = u.to(dtype)
                got, want = _run_kernel(name, v, _taps(kind, n), periodic, bcv, k)
                _hold(worst, name, got, want,
                      f"k={k} at {n}^3 {kind} {dtype} periodic={periodic} bc={bcv}")
                del v, got, want
                torch.cuda.empty_cache()
            cases += 5
            b_ms, by = kernel_bound(name, n, k, 4, flops, bw)
            times[n][key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": by, "library_ms": None}
        extra = {}
        if n == 1024:
            # yardstick, never called by the port: one cuDNN convolution
            # (TF32 off) over the Dirichlet-padded field computes the tb=1
            # update of both the direct and the stream kernel
            torch.backends.cudnn.allow_tf32 = False
            w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).cuda()[None, None]

            def library():
                return F.conv3d(up1[None, None], w)

            lib_ms = _time_ms(library, iters=3)
            lib = library()[0, 0]
            for name, got in (("apply_taps_direct", direct_out),
                              ("apply_taps_stream", stream_out)):
                times[n][name]["library_ms"] = lib_ms
                extra.update(_library_check(name, got, lib, taps, u))
            del lib
        del up1, direct_out, stream_out
        del u, out
        torch.cuda.empty_cache()
        _say("kernel_times", grid=[n, n, n], stencil="7pt", dtype="float32",
             times=times[n], exchange_ms_by_width=exchange_ms, bitwise_cases=cases,
             max_abs_err=worst, **extra)
    t = times[1024]
    t["apply_taps_streamk"] = t[f"apply_taps_streamk_k{_STREAMK_HEADLINE}"]
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    from heat3d_tpu_torch import ops

    t0 = time.perf_counter()
    smi = phase_identify()
    bw = bandwidth(torch.cuda.get_device_name(0))
    phase_build()
    worst = phase_compare()

    ops.reset_launch_counts()
    phase_golden()
    phase_full_width(bw)
    launches = ops.launch_counts()
    for name in KERNELS:
        _check(launches[name] > 0, f"{name} was not launched on the main path")
    _say("main_path", kernel_launches=launches)

    times = phase_kernel_times(bw, worst)
    kernels = [
        {"name": name, "route": "cuda", "source": _SOURCES[name],
         "replaces": _REPLACES[name], "launches": launches[name],
         "max_abs_err": worst[name], **times[name]}
        for name in KERNELS
    ]
    _say("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
