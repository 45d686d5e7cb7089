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
4. the sharded solve, every shard on ``cuda:0`` on a stream of its own,
   bitwise: the DMA halo kernels against their plain version (meshes
   (2,1,1) .. (2,2,2), widths 1-4, three boundary settings, fp32/bf16, at
   (66,34,258) and 128^3, and 50 exchanges in a row per mesh), the streamk
   kernel's domain-edge mask on the interior and edge shards of a (3,3,3)
   mesh, and the sharded solve on (2,2,2) against the (1,1,1) solve at
   128^3 for every route;
5. the main path against the fp64 golden oracle: the solver command line
   at 128^3, 20 steps, 7pt and 27pt, ``--golden-check``, at tb 1, 2, 3 and
   4, with ``HEAT3D_NO_DIRECT=1`` (the exchange path) at tb 1 and 2, and on
   a (2,2,2) mesh on ``cuda:0`` (``--halo ppermute`` tb 1/2/4, ``--halo
   dma`` tb 1/4; and an uneven 129^3 grid);
6. the main path at full width: ``bench_throughput`` at 1024^3 (fp32 7pt
   tb=2, the headline config; fp32 7pt tb=1; fp32 27pt tb=2; bf16 7pt
   tb=2; then the exchange path: fp32 7pt tb=4, tb=3 and tb=1 under
   ``HEAT3D_NO_DIRECT``, fp32 27pt tb=4, bf16 7pt tb=4; then sharded on a
   (2,2,2) mesh on one card: ``halo='dma'`` tb 1 and 4, ``ppermute`` tb 1
   and 2) with Gcell-updates/s, ms per superstep, the exchange's ms, the
   redundant-flops fraction and the end-to-end bound, and periodic 1024^3
   runs (tb=2 and tb=4, and ``halo='dma'`` tb=4 on (2,2,2); 11 steps) held
   to conservation of sum(u);
7. kernel and plain-version times at 256^3 and 1024^3 fp32 7pt, each
   kernel held bitwise to its plain version there (also with bc 0.3,
   periodic, 27pt and bf16 storage: the full-width phase's settings), the
   halo exchange's time at each width, and the library call's time
   (F.conv3d, no TF32) over the same input as the tb=1 and the stream
   kernel, held to them within a stated rounding bound; the DMA push+wait
   pairs per axis on 512^3 shards of a (2,2,2) mesh at widths 1 and 4;
   and each stencil kernel the (2,2,2) rows launch, on those 512^3 shards
   (streamk K=4 under corner shards' domain-edge masks), held bitwise to
   its plain version and timed beside its 512^3 bound;
8. across GPUs: the (2,1,1) DMA check with the shards on ``cuda:0`` and
   ``cuda:1``, when two GPUs are visible (else one line says it did not
   run, and why).

The kernel launch counts are zeroed just before phase 5 and read just after
phase 6; the script fails if any kernel was not launched there. The last
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
    "halo_dma": "heat3d_tpu_torch/csrc/halo_dma.cu",
}
_REPLACES = {
    "apply_taps_direct": "heat3d_tpu/ops/stencil_pallas_direct.py:422",
    "apply_taps_direct2": "heat3d_tpu/ops/stencil_pallas_direct.py:656",
    "apply_taps_stream": "heat3d_tpu/ops/stencil_pallas.py:257, "
                         "heat3d_tpu/ops/stencil_pallas.py:797",
    "apply_taps_streamk": "heat3d_tpu/ops/stencil_pallas.py:694, "
                          "heat3d_tpu/ops/stencil_pallas.py:451",
    "halo_dma": "heat3d_tpu/ops/halo_pallas.py:153, "
                "heat3d_tpu/ops/halo_pallas.py:274",
}
KERNELS = tuple(_SOURCES)
# the depth whose time stands in the kernels' line for streamk: the
# full-width phase's headline exchange-path config (tb=4)
_STREAMK_HEADLINE = 4
_BCS = ((False, 0.0), (False, 0.3), (True, 0.0))
# the sharded phases' mesh, every shard on cuda:0
_MESH = (2, 2, 2)
_DMA_MESHES = ((2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2))


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


_BOUND_PASSES = {
    "faces": "per shard: read u, write u_new (2 field passes), plus each "
             "ghost face cell read once from its neighbour and written once",
    "exchange": "per shard: read u, write the width-k padded block, read it, "
                "write u_new (4 passes), plus each ghost cell read once from "
                "its neighbour",
}


def sharded_superstep_bound(route: str, n: int, mesh, k: int, itemsize: int,
                            flops: int, bw: float):
    """Bound of one superstep (or step) of the sharded solve of an n^3 grid
    over ``mesh``: (ms, "bytes"/"operations", bytes) from the passes of
    ``_BOUND_PASSES``; the operations are the k useful updates (the
    faces-direct routes) or each shard's raw trapezoid (the exchange
    path, as ``superstep_bound``)."""
    m = [n // p for p in mesh]
    shards = mesh[0] * mesh[1] * mesh[2]
    cells = m[0] * m[1] * m[2]
    padded = (m[0] + 2 * k) * (m[1] + 2 * k) * (m[2] + 2 * k)
    if route.startswith("faces"):
        faces = 2 * (k * m[1] * m[2] + (m[0] + 2 * k) * k * m[2]
                     + (m[0] + 2 * k) * (m[1] + 2 * k) * k)
        moved = shards * (2 * cells + 2 * faces) * itemsize
        ops = n**3 * k * flops
    else:
        moved = shards * (2 * cells + 2 * padded + (padded - cells)) * itemsize
        raw = cells if k == 1 else sum(
            (m[0] + 2 * r) * (m[1] + 2 * r) * (m[2] + 2 * r) for r in range(k))
        ops = shards * raw * flops
    t, by = bound_ms(moved, ops, bw)
    return t, by, moved


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


def _one_shard_plan(u, periodic, k):
    """The width-k exchange plan the solver runs on a (1,1,1) mesh of ``u``
    on cuda:0."""
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    return ExchangePlan(_card_mesh((1, 1, 1), tuple(u.shape)), _bc(periodic), k,
                        "ppermute", u.dtype)


def _padded(u, periodic, bcv, k):
    """``u``'s width-k padded block, made by the solver's (1,1,1) plan."""
    return _one_shard_plan(u, periodic, k).apply([u], bcv)[0]


def _kernel_input(name, u, periodic, bcv, k):
    """What ``name``'s kernel reads: the field itself for the direct
    kernels, its width-k halo exchange for the exchange-path kernels."""
    if name in ("apply_taps_direct", "apply_taps_direct2"):
        return u
    return _padded(u, periodic, bcv, k)


def _kernel_pair(name, k, edges=(True,) * 6):
    """``name``'s kernel and its plain version, both called as
    ``f(x, taps, periodic, bc_value)`` on ``_kernel_input``'s ``x`` (the
    kernel also takes ``out=``); streamk with the domain-edge mask
    ``edges`` (default: a whole-domain block's)."""
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
    return (lambda x, t, p, b, out=None: ss.apply_taps_streamk(x, t, k, p, b, out=out,
                                                               edges=edges),
            lambda x, t, p, b: ss.apply_taps_streamk_ref(x, t, k, p, b, edges))


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
                            _padded(u, periodic, bcv, k), taps, k, periodic, bcv)
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
                    want = _solve_gathered(128, (1, 1, 1), kind, storage, periodic, bcv, 1, k)
                    got = _solve_gathered(128, (1, 1, 1), kind, storage, periodic, bcv, k, k,
                                          no_direct=True)
                    _check(got.tobytes() == want.tobytes(),
                           f"exchange-path solve != direct solve: k={k} {kind} "
                           f"{storage} periodic={periodic}")
                    solves += 1
    _say("compare", cases=n, bitwise=True, max_abs_err=worst,
         streamk_plain_vs_direct_launches=chained, exchange_vs_direct_solves=solves,
         launches=ops.launch_counts())
    return worst


def _card_mesh(shape, local, devices=None):
    """A ShardMesh of ``shape`` over ``local`` blocks, every shard on
    ``cuda:0`` (or on ``devices``), each on a stream of its own."""
    import torch

    from heat3d_tpu_torch.parallel.topology import ShardMesh

    n = shape[0] * shape[1] * shape[2]
    return ShardMesh(shape, local, devices or [torch.device("cuda", 0)] * n)


def _split(u, mesh):
    """The shards of global field ``u``, each on its shard's device."""
    return [u[tuple(slice(o, o + n) for o, n in zip(s.origin, mesh.local_shape))]
            .contiguous().to(s.device) for s in mesh.shards]


def _exchange_pair(mesh, us, periodic, bcv, width, dtype):
    """(DMA kernels' padded blocks, plain version's padded blocks) of one
    exchange of the shards ``us``: the plain version does every DMA axis
    with the slab copies of ``exchange_axis_dma_ref`` (the ppermute
    transport)."""
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    got = ExchangePlan(mesh, _bc(periodic), width, "dma", dtype)
    want = ExchangePlan(mesh, _bc(periodic), width, "ppermute", dtype)
    mesh.fork()
    a, b = got.apply(us, bcv), want.apply(us, bcv)
    mesh.join()
    return a, b


def _hold_blocks(worst, got, want, what):
    import torch

    from heat3d_tpu_torch.ops import halo_dma

    torch.cuda.synchronize()
    halo_dma.raise_if_timed_out()
    for g, w in zip(got, want):
        _hold(worst, "halo_dma", g, w, what)


def _dma_burst(worst, mesh, base_us, periodic, bcv, width, n=50):
    """``n`` DMA exchanges in a row on one plan (epochs 1..n on the same
    flag words), each shard's new input made and its padded block copied
    out on the shard's own stream, with no host synchronisation between
    them; then each held to the plain version."""
    import torch

    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    plan = ExchangePlan(mesh, _bc(periodic), width, "dma", torch.float32)
    snaps = []
    mesh.fork()
    for i in range(n):
        us = []
        for s, b in zip(mesh.shards, base_us):
            with mesh.on(s):
                us.append(b + i)
        pads = plan.apply(us, bcv)
        snap = []
        for s, p in zip(mesh.shards, pads):
            with mesh.on(s):
                snap.append(p.clone())
        snaps.append(snap)
    mesh.join()
    ref = ExchangePlan(mesh, _bc(periodic), width, "ppermute", torch.float32)
    for i, snap in enumerate(snaps):
        mesh.fork()
        want = ref.apply([b + i for b in base_us], bcv)
        mesh.join()
        _hold_blocks(worst, snap, want, f"exchange {i + 1} of {n} on {mesh.shape} "
                     f"width {width} periodic={periodic}")
    return n


def _solve_gathered(n, mesh, kind, storage, periodic, bcv, tb, steps, halo="ppermute",
                    no_direct=False, device=None):
    """The host field after ``steps`` updates of a random initial field."""
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    cfg = SolverConfig(
        grid=GridConfig(shape=n if isinstance(n, tuple) else (n, n, n)),
        stencil=StencilConfig(kind=kind, bc=_bc(periodic), bc_value=bcv),
        mesh=MeshConfig(shape=mesh), halo=halo,
        precision=Precision(storage=storage), time_blocking=tb,
    )
    with _no_direct(no_direct):
        solver = HeatSolver3D(cfg, device=device)
        return solver.gather(solver.run(solver.init_state("random"), steps))


# (halo, time_blocking, HEAT3D_NO_DIRECT, stencil, storage, periodic) of the
# sharded-vs-(1,1,1) solves
_SHARDED_SOLVES = (
    ("ppermute", 1, False, "7pt", "float32", False),
    ("ppermute", 2, False, "7pt", "float32", False),
    ("ppermute", 3, False, "7pt", "float32", False),
    ("ppermute", 4, False, "7pt", "float32", False),
    ("ppermute", 1, True, "7pt", "float32", False),
    ("dma", 1, False, "7pt", "float32", False),
    ("dma", 2, False, "7pt", "float32", False),
    ("dma", 4, False, "7pt", "float32", False),
    ("ppermute", 2, False, "7pt", "float32", True),
    ("dma", 4, False, "7pt", "float32", True),
    ("ppermute", 2, False, "27pt", "bfloat16", False),
    ("dma", 4, False, "27pt", "bfloat16", False),
)


def phase_compare_mesh(worst: dict) -> None:
    """The DMA kernels and the edge-masked streamk against their plain
    versions, and the sharded solve against the (1,1,1) solve, bitwise,
    every shard on cuda:0 on its own stream."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.ops import stencil_stream as ss
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    t0 = time.perf_counter()
    cases = bursts = 0
    for shape in ((66, 34, 258), (128, 128, 128)):
        base = torch.from_numpy(
            np.random.default_rng(3).standard_normal(shape).astype(np.float32)).cuda()
        for mesh_shape in _DMA_MESHES:
            mesh = _card_mesh(mesh_shape, tuple(g // p for g, p in zip(shape, mesh_shape)))
            for dtype in (torch.float32, torch.bfloat16):
                us = _split(base.to(dtype), mesh)
                for periodic, bcv in _BCS:
                    for width in (1, 2, 3, 4):
                        got, want = _exchange_pair(mesh, us, periodic, bcv, width, dtype)
                        _hold_blocks(worst, got, want,
                                     f"at {shape} mesh {mesh_shape} {dtype} width {width} "
                                     f"periodic={periodic} bc={bcv}")
                        cases += 1
            if shape == (128, 128, 128):
                us = _split(base, mesh)
                bursts += _dma_burst(worst, mesh, us, False, 0.3, 1)
                bursts += _dma_burst(worst, mesh, us, True, 0.0, 4)
        del base
    torch.cuda.empty_cache()

    # streamk's domain-edge mask: every shard of a (3,3,3) mesh, the centre
    # one interior on all six sides
    masked = 0
    mesh = _card_mesh((3, 3, 3), (32, 32, 32))
    base = torch.from_numpy(
        np.random.default_rng(8).standard_normal((96, 96, 96)).astype(np.float32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        us = _split(base.to(dtype), mesh)
        for kind in ("7pt", "27pt"):
            taps = _taps(kind)
            for k in ss.STREAMK_DEPTHS:
                for bcv in (0.0, 0.3):
                    plan = ExchangePlan(mesh, _bc(False), k, "ppermute", dtype)
                    mesh.fork()
                    pads = plan.apply(us, bcv)
                    mesh.join()
                    for s in mesh.shards:
                        got = ss.apply_taps_streamk(pads[s.rank], taps, k, False, bcv,
                                                    edges=s.edges)
                        want = ss.apply_taps_streamk_ref(pads[s.rank], taps, k, False, bcv,
                                                         s.edges)
                        _hold(worst, "apply_taps_streamk", got, want,
                              f"k={k} {kind} {dtype} bc={bcv} shard {s.coords} edges {s.edges}")
                        masked += 1
    del base, us, pads
    torch.cuda.empty_cache()

    solves = []
    for halo, tb, no_direct, kind, storage, periodic in _SHARDED_SOLVES:
        bcv = 0.0 if periodic else 0.3
        want = _solve_gathered(128, (1, 1, 1), kind, storage, periodic, bcv, 1, 20)
        got = _solve_gathered(128, _MESH, kind, storage, periodic, bcv, tb, 20, halo,
                              no_direct, device="cuda:0")
        _check(got.tobytes() == want.tobytes(),
               f"sharded solve != (1,1,1) solve: halo={halo} tb={tb} no_direct={no_direct} "
               f"{kind} {storage} periodic={periodic}: max err "
               f"{float(np.abs(got - want).max())}")
        solves.append([halo, tb, no_direct, kind, storage, periodic])
    _say("compare_mesh", dma_cases=cases, dma_exchanges_in_a_row=bursts,
         streamk_masked_cases=masked, sharded_vs_single_solves=solves, bitwise=True,
         max_abs_err=worst, launches=ops.launch_counts(),
         seconds=time.perf_counter() - t0)


# (stencil, time_blocking, HEAT3D_NO_DIRECT) of the golden phase, with the
# kernel each must launch
_GOLDEN = (
    (1, False, "apply_taps_direct"), (2, False, "apply_taps_direct2"),
    (3, False, "apply_taps_streamk"), (4, False, "apply_taps_streamk"),
    (1, True, "apply_taps_stream"), (2, True, "apply_taps_streamk"),
)


# (grid, halo, time_blocking, bc value, kernel it must launch) of the
# golden phase's sharded runs, on a (2,2,2) mesh on cuda:0
_GOLDEN_SHARDED = (
    (128, "ppermute", 1, 0.0, "apply_taps_direct"),
    (128, "ppermute", 2, 0.0, "apply_taps_direct2"),
    (128, "ppermute", 4, 0.0, "apply_taps_streamk"),
    (128, "dma", 1, 0.0, "halo_dma"),
    (128, "dma", 4, 0.0, "halo_dma"),
)
# uneven: 129^3 over (2,2,2) stores 130^3 with bc-pinned padding
_GOLDEN_UNEVEN = ((129, "ppermute", 1, 0.3, "apply_taps_stream"),
                  (129, "dma", 4, 0.3, "halo_dma"))


def _golden_cli(argv, want, **tags) -> None:
    from heat3d_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--golden-check"])
    _check(rc == 0, f"solver CLI {argv} exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    _check(summary["golden_pass"], f"golden check failed: {summary}")
    _check(summary["kernel_launches"][want] > 0, f"{want} not launched: {summary}")
    _say("golden", **tags, steps=summary["steps"], golden_pass=summary["golden_pass"],
         golden_rel_err=summary["golden_rel_err"],
         step_route=summary["step_route"], superstep_route=summary["superstep_route"],
         kernel_launches=summary["kernel_launches"])


def phase_golden() -> None:
    for kind in ("7pt", "27pt"):
        for tb, no_direct, want in _GOLDEN:
            with _no_direct(no_direct):
                _golden_cli(["--grid", "128", "--steps", "20", "--stencil", kind,
                             "--time-blocking", str(tb)], want,
                            stencil=kind, time_blocking=tb, no_direct=no_direct)
    for kind in ("7pt", "27pt"):
        for n, halo, tb, bcv, want in _GOLDEN_SHARDED + (
                _GOLDEN_UNEVEN if kind == "7pt" else ()):
            _golden_cli(["--grid", str(n), "--steps", "20", "--stencil", kind,
                         "--time-blocking", str(tb), "--mesh", *map(str, _MESH),
                         "--halo", halo, "--bc-value", str(bcv), "--device", "cuda:0"],
                        want, grid=n, stencil=kind, mesh=list(_MESH), halo=halo,
                        time_blocking=tb, bc_value=bcv)


# (stencil, time_blocking, storage, HEAT3D_NO_DIRECT) of the full-width phase
_FULL_WIDTH = (
    ("7pt", 2, "float32", False), ("7pt", 1, "float32", False),
    ("27pt", 2, "float32", False), ("7pt", 2, "bfloat16", False),
    ("7pt", 4, "float32", False), ("7pt", 3, "float32", False),
    ("7pt", 1, "float32", True), ("27pt", 4, "float32", False),
    ("7pt", 4, "bfloat16", False),
)
# (halo, time_blocking) of the full-width phase's sharded rows: fp32 7pt on
# a (2,2,2) mesh of 512^3 shards, every shard on cuda:0
_SHARDED_FULL_WIDTH = (("dma", 1), ("dma", 4), ("ppermute", 1), ("ppermute", 2))


def phase_full_width(bw: float) -> None:
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
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

    for halo, tb in _SHARDED_FULL_WIDTH:
        cfg = SolverConfig(grid=GridConfig.cube(n), mesh=MeshConfig(shape=_MESH),
                           halo=halo, time_blocking=tb)
        row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                               device="cuda:0")
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        b_ms, by, b_bytes = sharded_superstep_bound(
            route, n, _MESH, tb, 4, flops_per_update(_taps("7pt")), bw)
        _check(row["kernel_launches"].get("halo_dma", 0) > 0 or halo != "dma",
               f"no DMA launches: {row}")
        ex_ms = _exchange_ms(cfg, route)
        _say("full_width", grid=row["grid"], stencil="7pt", dtype="float32",
             mesh=row["mesh"], halo=halo, shards_per_device=row["shards_per_device"],
             time_blocking=tb, route=route, steps=row["steps"],
             gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"], exchange_ms=ex_ms,
             cost_redundant_flops_frac=row["cost_redundant_flops_frac"],
             bound_ms_per_superstep=b_ms, bound_by=by, bound_bytes=b_bytes,
             bound_passes=_BOUND_PASSES["faces" if route.startswith("faces") else "exchange"],
             bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
        del row
        torch.cuda.empty_cache()

    for mesh, halo, tb in (((1, 1, 1), "ppermute", 2), ((1, 1, 1), "ppermute", 4),
                           (_MESH, "dma", 4)):
        cfg = SolverConfig(
            grid=GridConfig.cube(n),
            stencil=StencilConfig(kind="7pt", bc=_bc(True)),
            mesh=MeshConfig(shape=mesh), halo=halo, time_blocking=tb,
        )
        solver = HeatSolver3D(cfg, device=None if mesh == (1, 1, 1) else "cuda:0")
        u = solver.init_state("hot-cube")
        s0 = _field_sum(u)
        u = solver.run(u, 11)
        s1 = _field_sum(u)
        finite = all(bool(torch.isfinite(t).all()) for t in _shard_list(u))
        rel = abs(s1 - s0) / s0
        _check(finite and rel < 1e-5,
               f"periodic tb={tb} mesh {mesh} {halo} sum drifted: {s0} -> {s1} ({rel})")
        _say("conservation", grid=[n, n, n], mesh=list(mesh), halo=halo,
             time_blocking=tb, steps=11, sum_before=s0, sum_after=s1, rel_drift=rel,
             finite=finite)
        del u, solver
        torch.cuda.empty_cache()


def _shard_list(u):
    return [u] if hasattr(u, "double") else list(u.shards)


def _field_sum(u) -> float:
    """fp64 sum of a field (a tensor, or a ShardedField's shards in order)."""
    return float(sum(t.double().sum() for t in _shard_list(u)))


def _exchange_ms(cfg, route: str) -> float:
    """One exchange of ``route`` (faces-only for the faces-direct routes,
    else the padded-block plan of the route's width on ``cfg.halo``) on
    1024^3 shards of random data, timed alone on cuda:0."""
    import torch

    from heat3d_tpu_torch.parallel.step import make_exchanges
    from heat3d_tpu_torch.parallel.topology import build_shard_mesh

    mesh = build_shard_mesh(cfg, "cuda:0")
    us = [torch.rand(mesh.local_shape, device=s.device) for s in mesh.shards]
    ex = make_exchanges(cfg, mesh)
    width = cfg.time_blocking if route in ("faces-direct2", "streamk") else 1
    plan = (ex.faces(width, torch.float32) if route.startswith("faces")
            else ex.plan(width, torch.float32))

    def go():
        mesh.fork()
        plan.apply(us, cfg.stencil.bc_value)
        mesh.join()

    ms = _time_ms(go, iters=5)
    del us, plan, ex
    torch.cuda.empty_cache()
    return ms


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
    ``worst``; the halo exchange's time at each width (the solver's
    (1,1,1) plan); and the library call (one cuDNN convolution, TF32 off,
    never called by the port) over the same input as the tb=1 kernel and
    the stream kernel, held to both within a rounding bound. Returns the
    1024^3 numbers of each kernel (streamk at its headline depth)."""
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
        exchange_ms = {}
        cases = 0
        for name, k in _cases():
            key = name if name != "apply_taps_streamk" else f"{name}_k{k}"
            kern, plain = _kernel_pair(name, k)
            x = u
            if name not in ("apply_taps_direct", "apply_taps_direct2"):
                plan = _one_shard_plan(u, False, k)
                x = plan.apply([u], 0.0)[0]
                exchange_ms[k] = _time_ms(lambda: plan.apply([u], 0.0), iters=5)
                del plan
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


def _dma_axis_bytes(mesh, axis: int, width: int, itemsize: int, periodic: bool) -> int:
    """Bytes one axis of the DMA exchange must move: each pushed face slab
    read once and written once into the neighbour, each domain-face ghost
    slab written once."""
    local = mesh.local_shape
    slab = 1
    for a, m in enumerate(local):
        slab *= width if a == axis else (m + 2 * width if a < axis else m)
    total = 0
    for s in mesh.shards:
        for d in (-1, +1):
            total += slab * (1 if mesh.neighbor(s, axis, d, periodic) is None else 2)
    return total * itemsize


def phase_dma_times(bw: float, worst: dict) -> dict:
    """The push+wait pairs of each axis on a (2,2,2) mesh of 512^3 fp32
    shards on cuda:0 (Dirichlet bc 0, the full-width phase's setting), at
    widths 1 and 4, against the plain version's slab copies (which are
    ``Tensor.copy_`` calls, the library yardstick too); each held bitwise
    to the plain version there. Returns the kernels-line entry: one whole
    width-1 exchange's DMA launches (all three axes), the tb=1 main path's."""
    import torch

    from heat3d_tpu_torch.ops import halo_dma

    mesh = _card_mesh(_MESH, (512, 512, 512))
    times = {}
    for width in (1, 4):
        pads = [torch.rand(tuple(m + 2 * width for m in mesh.local_shape),
                           device=s.device) for s in mesh.shards]
        state = halo_dma.DmaState(mesh)
        for axis in range(3):
            def kern():
                state.epoch += 1
                mesh.fork()
                halo_dma.exchange_axis_dma(pads, mesh, axis, width, False, 0.0, state)
                mesh.join()

            def plain():
                halo_dma.exchange_axis_dma_ref(pads, mesh, axis, width, False, 0.0)

            ms = _time_ms(kern, iters=10)
            plain_ms = _time_ms(plain, iters=10)
            moved = _dma_axis_bytes(mesh, axis, width, 4, False)
            b_ms, by = bound_ms(moved, 0, bw)
            times[f"w{width}_axis{axis}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                "bytes": moved, "library_ms": plain_ms}
            want = [p.clone() for p in pads]
            kern()
            halo_dma.exchange_axis_dma_ref(want, mesh, axis, width, False, 0.0)
            _hold_blocks(worst, pads, want, f"axis {axis} width {width} on 512^3 shards")
            del want
        del pads, state
        torch.cuda.empty_cache()
    _say("dma_times", mesh=list(_MESH), shard=[512, 512, 512], dtype="float32",
         times=times, max_abs_err=worst["halo_dma"])
    w1 = [times[f"w1_axis{a}"] for a in range(3)]
    total = {key: sum(t[key] for t in w1) for key in ("ms", "plain_ms", "bound_ms")}
    return {**total, "bound_by": "bytes", "library_ms": total["plain_ms"]}


def phase_shard_kernel_times(bw: float, worst: dict) -> None:
    """The stencil kernels the full-width phase's (2,2,2) rows launch, on
    their 512^3 shards (every shard on cuda:0), with those rows' settings
    (fp32 7pt, Dirichlet bc 0; streamk also periodic, as the conservation
    run): ``direct1``/``direct2`` (faces-direct tb 1/2) on an unpadded
    shard, ``stream1`` (dma tb=1) on a width-1 padded block and streamk K=4
    (dma tb=4) on width-4 padded blocks, both made by the sharded DMA
    exchange, under the domain-edge masks of the corner shards (0,0,0) and
    (1,1,1) (three domain faces, three faces inside the mesh), Dirichlet
    and periodic (which pins nothing). Each launch is held bitwise
    to its plain version and timed beside its 512^3 bound; ``eight_ms`` is
    eight launches, one superstep's kernel time on the card."""
    import torch

    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    m, k = 512, _STREAMK_HEADLINE
    mesh = _card_mesh(_MESH, (m, m, m))
    taps = _taps("7pt", 2 * m)
    flops = flops_per_update(taps)
    us = [torch.rand((m, m, m), device=s.device) for s in mesh.shards]
    out = torch.empty_like(us[0])
    lo, hi = mesh.shards[0], mesh.shards[-1]
    times = {}

    def held(key, name, kk, x, periodic, edges=(True,) * 6):
        kern, plain = _kernel_pair(name, kk, edges)
        ms = _time_ms(lambda: kern(x, taps, periodic, 0.0, out=out), iters=10)
        plain_ms = _time_ms(lambda: plain(x, taps, periodic, 0.0), iters=3)
        _hold(worst, name, out, plain(x, taps, periodic, 0.0),
              f"{key} on a {m}^3 shard, edges {edges}")
        b_ms, by = kernel_bound(name, m, kk, 4, flops, bw)
        times[key] = {"ms": ms, "eight_ms": 8 * ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": by,
                      "edges": list(edges) if name == "apply_taps_streamk" else None}

    held("apply_taps_direct", "apply_taps_direct", 1, us[0], False)
    held("apply_taps_direct2", "apply_taps_direct2", 2, us[0], False)
    for width, periodic, cases in (
        (1, False, (("apply_taps_stream", "apply_taps_stream", lo),)),
        (k, False, ((f"apply_taps_streamk_k{k}_shard000", "apply_taps_streamk", lo),
                    (f"apply_taps_streamk_k{k}_shard111", "apply_taps_streamk", hi))),
        (k, True, ((f"apply_taps_streamk_k{k}_periodic", "apply_taps_streamk", lo),)),
    ):
        plan = ExchangePlan(mesh, _bc(periodic), width, "dma", torch.float32)
        mesh.fork()
        pads = plan.apply(us, 0.0)
        mesh.join()
        for key, name, s in cases:
            held(key, name, width, pads[s.rank], periodic, s.edges)
        del plan, pads
        torch.cuda.empty_cache()
    del us, out
    torch.cuda.empty_cache()
    _say("shard_kernel_times", mesh=list(_MESH), shard=[m, m, m], stencil="7pt",
         dtype="float32", bc_value=0.0, times=times, bitwise=True,
         max_abs_err={n: worst[n] for n in KERNELS if n != "halo_dma"})


def phase_cross_gpu(worst: dict) -> None:
    """The (2,1,1) DMA check with shard 0 on cuda:0 and shard 1 on cuda:1:
    peer stores across GPUs. Runs only with two GPUs visible."""
    import numpy as np
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        _say("cross_gpu", ran=False,
             reason=f"{count} CUDA device visible; the phase needs 2 (the peer "
                    "writes between GPUs stay unchecked by this run)")
        return
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = _card_mesh((2, 1, 1), (64, 128, 128), devices)
    base = torch.from_numpy(
        np.random.default_rng(5).standard_normal((128, 128, 128)).astype(np.float32)).cuda()
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        us = _split(base.to(dtype), mesh)
        for periodic, bcv in _BCS:
            for width in (1, 2, 3, 4):
                got, want = _exchange_pair(mesh, us, periodic, bcv, width, dtype)
                for d in devices:
                    torch.cuda.synchronize(d)
                _hold_blocks(worst, [g.cpu() for g in got], [w.cpu() for w in want],
                             f"across GPUs width {width} {dtype} periodic={periodic}")
                cases += 1
    bursts = _dma_burst(worst, mesh, _split(base, mesh), True, 0.0, 4)
    _say("cross_gpu", ran=True, devices=[str(d) for d in devices], dma_cases=cases,
         dma_exchanges_in_a_row=bursts, bitwise=True)


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
    phase_compare_mesh(worst)

    ops.reset_launch_counts()
    phase_golden()
    phase_full_width(bw)
    launches = ops.launch_counts()
    for name in KERNELS:
        _check(launches[name] > 0, f"{name} was not launched on the main path")
    _say("main_path", kernel_launches=launches)

    times = phase_kernel_times(bw, worst)
    times["halo_dma"] = phase_dma_times(bw, worst)
    phase_shard_kernel_times(bw, worst)
    phase_cross_gpu(worst)
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
