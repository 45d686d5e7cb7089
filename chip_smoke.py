#!/usr/bin/env python3
"""On-card smoke test of heat3d_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Phases, each printing its own lines:

1. identify the card (nvidia-smi name and power limit, torch and CUDA);
2. build the CUDA kernels from ``heat3d_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print the compiler's resource report;
3. hold each kernel against its plain PyTorch version on the card, bitwise,
   for 7pt/27pt x Dirichlet (bc 0 and 0.3)/periodic x fp32/bf16 storage at
   ragged shapes, 128^3 (the golden phase's grid) and 256^3;
4. the main path against the fp64 golden oracle: the solver command line
   at 128^3, 20 steps, tb=1 and tb=2, 7pt and 27pt, ``--golden-check``;
5. the main path at full width: ``bench_throughput`` at 1024^3 (fp32 7pt
   tb=2, the headline config; fp32 7pt tb=1; fp32 27pt tb=2; bf16 7pt tb=2)
   with Gcell-updates/s, ms per kernel launch and the bandwidth bound, and
   a periodic 1024^3 run held to conservation of sum(u);
6. kernel and plain-version times at 256^3 and 1024^3 fp32 7pt, each
   kernel held bitwise to its plain version there (also with bc 0.3,
   periodic, 27pt and bf16 storage: the full-width phase's shapes), and the
   library call's time (F.pad + F.conv3d, no TF32) at 1024^3, held to the
   tb=1 kernel within a stated rounding bound.

The kernel launch counts are zeroed just before phase 4 and read just after
phase 5; the script fails if either kernel was not launched there. The last
three lines are the kernels' JSON object (``{"kernels": [...]}``), the
nvidia-smi line, and the status object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

# Peak rates of the card (published, SXM H100 at 700 W unless the name says
# otherwise): device-memory bytes/s by name fragment, fp32 non-tensor FLOP/s.
_BANDWIDTH = (("H200", 4.8e12), ("NVL", 3.9e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
_FP32_FLOPS = 67e12

_SOURCE = "heat3d_tpu_torch/csrc/stencil_direct.cu"
_REPLACES = {
    "apply_taps_direct": "heat3d_tpu/ops/stencil_pallas_direct.py:422",
    "apply_taps_direct2": "heat3d_tpu/ops/stencil_pallas_direct.py:656",
}


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def _say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def flops_per_update(taps) -> int:
    """fp32 operations per cell and update of the tap chain, with the plane
    and row sums counted once (as the plain version caches them)."""
    from heat3d_tpu_torch.ops.stencil_direct import emission_program

    prog = emission_program(taps)
    sums = {("x",)} if any(s == 3 for s, _, _, _ in prog) else set()
    sums |= {("y", s) for s, r, _, _ in prog if r == 3}
    return 2 * len(prog) - 1 + len(sums)


def bound_ms(cells: int, itemsize: int, updates: int, flops: int, bw: float):
    """Least time of one launch: each cell read once and written once at the
    card's memory rate, or the chain's operations at its fp32 rate."""
    t_bytes = 2 * cells * itemsize / bw * 1e3
    t_ops = cells * updates * flops / _FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_identify() -> str:
    import torch

    smi = nvidia_smi()
    _say("identify", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from heat3d_tpu_torch.ops import _build

    seconds = _build.build_all()
    _say("build", seconds=seconds)
    for name in seconds:
        print(_build.build_log(name).strip(), flush=True)


def _pairs():
    from heat3d_tpu_torch.ops import stencil_direct as sd

    return {
        "apply_taps_direct": (sd.apply_taps_direct, sd.apply_taps_direct_ref),
        "apply_taps_direct2": (sd.apply_taps_direct2, sd.apply_taps_direct2_ref),
    }


def _hold(worst: dict, name: str, got, want, what: str) -> None:
    """Fail unless kernel output ``got`` equals plain output ``want``
    bitwise; fold |got - want| into ``worst[name]``."""
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    worst[name] = max(worst[name], err)
    _check(torch.equal(got, want), f"{name} != plain {what}: max err {err}")


def phase_compare() -> dict:
    """Each kernel against its plain version on the card, bitwise. Returns
    the largest |kernel - plain| of each kernel (0.0 when bitwise)."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd

    worst = {k: 0.0 for k in _pairs()}
    n = 0
    for shape in ((33, 17, 129), (64, 72, 200), (128, 128, 128), (256, 256, 256)):
        base = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                    for name, (kern, ref) in _pairs().items():
                        _hold(worst, name, kern(u, taps, periodic, bcv),
                              ref(u, taps, periodic, bcv),
                              f"at {shape} {dtype} {kind} periodic={periodic} bc={bcv}")
                        n += 1
    _say("compare", cases=n, bitwise=True, max_abs_err=worst,
         launches=sd.launch_counts())
    return worst


def phase_golden() -> None:
    from heat3d_tpu_torch import cli

    for kind in ("7pt", "27pt"):
        for tb in (1, 2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--grid", "128", "--steps", "20", "--stencil", kind,
                               "--time-blocking", str(tb), "--golden-check"])
            _check(rc == 0, f"solver CLI {kind} tb={tb} exited {rc}")
            summary = json.loads(buf.getvalue().strip().splitlines()[-1])
            want = "apply_taps_direct2" if tb == 2 else "apply_taps_direct"
            _check(summary["golden_pass"], f"golden check failed: {summary}")
            _check(summary["kernel_launches"][want] > 0,
                   f"{want} not launched: {summary}")
            _say("golden", stencil=kind, time_blocking=tb, steps=summary["steps"],
                 golden_pass=summary["golden_pass"],
                 golden_rel_err=summary["golden_rel_err"],
                 kernel_launches=summary["kernel_launches"])


def phase_full_width(bw: float) -> None:
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import (
        BoundaryCondition, GridConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    n = 1024
    for kind, tb, storage in (("7pt", 2, "float32"), ("7pt", 1, "float32"),
                              ("27pt", 2, "float32"), ("7pt", 2, "bfloat16")):
        cfg = SolverConfig(
            grid=GridConfig.cube(n), stencil=StencilConfig(kind=kind),
            precision=Precision(storage=storage), time_blocking=tb,
        )
        row = bench_throughput(cfg, steps=20, warmup=1, repeats=3)
        itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
        b_ms, by = bound_ms(n**3, itemsize, tb, flops_per_update(_taps(kind)), bw)
        _check(sum(row["kernel_launches"].values()) > 0, f"no launches: {row}")
        _say("full_width", grid=row["grid"], stencil=kind, dtype=storage,
             time_blocking=tb, steps=row["steps"],
             gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_launch=row["ms_per_launch"], bound_ms_per_launch=b_ms,
             bound_by=by, bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
        del row
        torch.cuda.empty_cache()

    cfg = SolverConfig(
        grid=GridConfig.cube(n),
        stencil=StencilConfig(kind="7pt", bc=BoundaryCondition.PERIODIC),
        time_blocking=2,
    )
    solver = HeatSolver3D(cfg)
    u = solver.init_state("hot-cube")
    s0 = float(u.double().sum())
    u = solver.run(u, 11)
    s1 = float(u.double().sum())
    finite = bool(torch.isfinite(u).all())
    rel = abs(s1 - s0) / s0
    _check(finite and rel < 1e-5, f"periodic sum drifted: {s0} -> {s1} ({rel})")
    _say("conservation", grid=[n, n, n], steps=11, sum_before=s0, sum_after=s1,
         rel_drift=rel, finite=finite)
    del u, solver
    torch.cuda.empty_cache()


def _time_ms(fn, iters: int = 5) -> float:
    from heat3d_tpu_torch.utils.timing import time_fn

    return min(time_fn(fn, warmup=1, iters=iters)) * 1e3


def phase_kernel_times(bw: float, worst: dict) -> dict:
    """Kernel and plain-version times at 256^3 and 1024^3 fp32 7pt, with
    each kernel held bitwise to its plain version at those sizes (7pt fp32
    with bc 0, 0.3 and periodic, 27pt fp32 and 7pt bf16: the shapes and
    settings the full-width phase gives the kernels), folding the errors
    into ``worst``; and the library call's time at 1024^3, held to the tb=1
    kernel within a rounding bound. Returns the 1024^3 numbers of each
    kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    times = {}
    for n in (256, 1024):
        taps = _taps("7pt", n)
        flops = flops_per_update(taps)
        u = torch.rand((n, n, n), device="cuda")
        out = torch.empty_like(u)
        times[n] = {}
        cases = 0
        for (name, (kern, ref)), updates in zip(_pairs().items(), (1, 2)):
            ms = _time_ms(lambda: kern(u, taps, False, 0.0, out=out), iters=10)
            plain_ms = _time_ms(lambda: ref(u, taps, False, 0.0), iters=3)
            # ``out`` holds the last timed launch's result
            _hold(worst, name, out, ref(u, taps, False, 0.0),
                  f"at {n}^3 7pt float32 bc=0.0")
            for kind, dtype, periodic, bcv in (
                ("7pt", torch.float32, False, 0.3), ("7pt", torch.float32, True, 0.0),
                ("27pt", torch.float32, False, 0.0), ("7pt", torch.bfloat16, False, 0.0),
            ):
                v = u.to(dtype)
                t = _taps(kind, n)
                _hold(worst, name, kern(v, t, periodic, bcv), ref(v, t, periodic, bcv),
                      f"at {n}^3 {kind} {dtype} periodic={periodic} bc={bcv}")
                del v
                torch.cuda.empty_cache()
            cases += 5
            b_ms, by = bound_ms(n**3, 4, updates, flops, bw)
            times[n][name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": by, "library_ms": None}
        extra = {}
        if n == 1024:
            # yardstick, never called by the port: one cuDNN convolution
            # (TF32 off) over the Dirichlet-padded field computes the same
            # tb=1 update
            torch.backends.cudnn.allow_tf32 = False
            w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).cuda()[None, None]

            def library():
                return F.conv3d(F.pad(u, (1, 1, 1, 1, 1, 1), value=0.0)[None, None], w)

            times[n]["apply_taps_direct"]["library_ms"] = _time_ms(library, iters=3)
            kern = _pairs()["apply_taps_direct"][0]
            lib_err = float((library()[0, 0] - kern(u, taps, out=out)).abs().max())
            # both sides sum at most 27 fp32 products in their own order: each
            # is within 28 * 2^-24 * sum|w| * max|u| of the exact sum
            lib_tol = 2 * 28 * 2.0**-24 * float(np.abs(taps).sum()) * float(u.abs().max())
            _check(lib_err <= lib_tol,
                   f"library call disagrees with the tb=1 kernel: {lib_err} > {lib_tol}")
            extra = {"library_vs_kernel_max_abs_err": lib_err,
                     "library_vs_kernel_tol": lib_tol}
        del u, out
        torch.cuda.empty_cache()
        _say("kernel_times", grid=[n, n, n], stencil="7pt", dtype="float32",
             times=times[n], bitwise_cases=cases, max_abs_err=worst, **extra)
    return times[1024]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    from heat3d_tpu_torch.ops import stencil_direct as sd

    t0 = time.perf_counter()
    smi = phase_identify()
    bw = bandwidth(torch.cuda.get_device_name(0))
    phase_build()
    worst = phase_compare()

    sd.reset_launch_counts()
    phase_golden()
    phase_full_width(bw)
    launches = sd.launch_counts()
    for name, count in launches.items():
        _check(count > 0, f"{name} was not launched on the main path")
    _say("main_path", kernel_launches=launches)

    times = phase_kernel_times(bw, worst)
    kernels = [
        {"name": name, "route": "cuda", "source": _SOURCE,
         "replaces": _REPLACES[name], "launches": launches[name],
         "max_abs_err": worst[name], **times[name]}
        for name in ("apply_taps_direct", "apply_taps_direct2")
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
