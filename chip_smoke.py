#!/usr/bin/env python3
"""On-card smoke test of heat3d_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py
    python3 chip_smoke.py --only dma_times,fused_times   # a short check

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Phases, each printing its own lines:

1. identify the card (nvidia-smi name and power limit, torch and CUDA);
2. build the CUDA kernels from ``heat3d_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print each source's build seconds,
   the compiler's resource report, and each stream instance's (k = 1..4 x
   the 7pt, 27pt and generic instances x fp32/bf16 storage), direct
   instance's (halo 1 and 2 x the same instances and the Mehrstellen
   q-ring instance) and fused instance's (the one- and two-update
   kernels' 7pt, 27pt and generic instances) shared memory, registers,
   spills and resident blocks per SM, each compile-time instance in fp32
   and in bf16 compute (the ``Bf16Math`` policy; keys end ``_bf16c``);
3. hold each kernel against its plain PyTorch version on the card, bitwise,
   for 7pt/27pt x Dirichlet (bc 0 and 0.3)/periodic x fp32/bf16 storage at
   ragged shapes, 128^3 (the golden phase's grid) and 256^3: the direct
   kernels (tb 1 and 2), the stream kernel and streamk at k = 2, 3, 4 over
   the halo exchange; the direct kernels also at shapes with nx below 2H+1,
   odd nz, y and z no multiple of their tiles, nx = 1024 cut into x-chunks
   and a forced 3-plane x-chunk; every stencil kernel's generic instance at
   128^3 under the factoring knobs (``HEAT3D_FACTOR_7PT=1``,
   ``HEAT3D_FACTOR_Y=0``, both; the fused kernels too, over (4,1,1)),
   each launch on the instance ``stream_instance`` names; also
   the streamk plain version against k
   direct kernel launches, and the exchange-path solve of k steps against
   the direct-path solve, both bitwise;
   ``compare_mehrstellen``: under ``HEAT3D_MEHRSTELLEN=1`` both
   Mehrstellen instances bitwise against their plain versions at the
   direct kernels' ragged shapes, a forced 3-plane x-chunk, 128^3 and
   1024^3 (fp32/bf16 x three boundary settings), the (2,2,2) faces-direct
   solve against the (1,1,1) solve at 128^3 (tb 1 and 2), and the 27pt
   tb=4 and ``fused-dma2`` solves, which keep the tap chain, equal to
   their knob-off solves;
   ``compare_bf16``: every bf16-compute instance (``compute_dtype=
   torch.bfloat16``) bitwise against its plain version in bf16 compute,
   each launch counted as one: the direct kernels at their ragged shapes
   and a forced 3-plane x-chunk, every stencil kernel at (33,17,129) and
   128^3, the Mehrstellen instances, the generic instances forced (the
   fused ones over (4,1,1)), the fused kernels over (8,1,1), the RDMA ones
   over (4,1,1) (floor 0 and the default) and over a ragged (2,1,1);
   7pt/27pt x fp32/bf16 storage x the boundary settings;
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
   dma`` tb 1/4; and an uneven 129^3 grid); under ``HEAT3D_MEHRSTELLEN=1``
   27pt tb 1 and 2 in fp32 and bf16 storage on the Mehrstellen instance;
   with ``--compute-dtype bf16`` (10 steps): 7pt tb 1, 2 and 4 in fp32
   and bf16 storage, the exchange path, the Mehrstellen instances and the
   four fused kernels, each launching its bf16-compute instance; and the
   7pt bf16-compute drift at 10 and 20 steps (``_bf16_drift``: printed
   beside the gate, the solve held bitwise to the plain per-op update);
6. the main path at full width: ``bench_throughput`` at 1024^3 (fp32 7pt
   tb=2, the headline config; fp32 7pt tb=1; fp32 27pt tb=2; bf16 7pt
   tb=2; then the exchange path: fp32 7pt tb=4, tb=3 and tb=1 under
   ``HEAT3D_NO_DIRECT``, fp32 27pt tb=4, bf16 7pt tb=4; then sharded on a
   (2,2,2) mesh on one card: ``halo='dma'`` tb 1 and 4, ``ppermute`` tb 1
   and 2) with Gcell-updates/s, ms per superstep, the exchange's ms, the
   redundant-flops fraction and the end-to-end bound, and periodic 1024^3
   runs (tb=2 and tb=4, and ``halo='dma'`` tb=4 on (2,2,2); 11 steps) held
   to conservation of sum(u); under ``HEAT3D_MEHRSTELLEN=1`` (27pt) direct
   tb=2, tb=1, bf16 tb=2, (2,2,2) faces-direct tb 1 and 2 (Mehrstellen
   instance) and tb=4 and (8,1,1) ``fused-dma2`` (the chain), each row's
   route provenance checked, and the (2,2,2) faces-direct solve at 1024^3
   held bitwise to the (1,1,1) solve (tb 1 and 2); and BASELINE config
   5's precision (bf16 stencil, fp32 residual) cut to one card
   (``_FULL_WIDTH_BF16``: fp32 storage 7pt tb 2 and 4, bf16 storage tb=2,
   27pt Mehrstellen tb=2, (8,1,1) ``fused-dma2``, (4,1,1) ``fused-rdma``
   tb=1), each launching bf16-compute instances;
7. kernel and plain-version times at 256^3 and 1024^3 fp32 7pt, each
   kernel held bitwise to its plain version there (also with bc 0.3,
   periodic, 27pt and bf16 storage: the full-width phase's settings), the
   halo exchange's time at each width, and the library call's time
   (F.conv3d, no TF32) over the same input as the tb=1 and the stream
   kernel, held to them within a stated rounding bound; the direct kernels'
   generic instance forced on the 7pt chain beside them (the first
   design), and direct1/direct2 in their 27pt fp32 and 7pt bf16 instances
   at 1024^3 with registers, spills and blocks per SM; the stream kernel
   and streamk K=4 in their 27pt fp32 and 7pt bf16 instances at 1024^3
   (bitwise, timed beside their bounds), and the ratios stream1 / direct1,
   streamk K=2 / direct2 and K=4 / direct2 of the same call; the DMA
   exchange per axis on 512^3 shards of a (2,2,2) mesh at widths 1 and 4
   (ms of a single call and of 20 calls in a row, beside the plain slab
   copies timed both ways, the byte bound, the sector floor and the
   launches a call makes);
   and each stencil kernel the (2,2,2) rows launch, on those 512^3 shards
   (streamk K=4 under corner shards' domain-edge masks), held bitwise to
   its plain version and timed beside its 512^3 bound;
   ``mehrstellen_times``: the Mehrstellen instances at 1024^3 (fp32, bf16)
   beside the 27pt chain instances of the same call and their bounds, with
   registers, spills and blocks per SM, and at tb=1 the library call (a
   27pt ``F.conv3d``, TF32 off);
   ``compute_bf16_times``: each bf16-compute instance at 1024^3 beside
   the fp32-compute instance of the same chain in the same call (timed
   fp32, bf16, bf16, fp32), with the bound (the storage dtype's bytes),
   registers, spills and blocks per SM, each bf16 launch held bitwise;
8. across GPUs: the (2,1,1) DMA check with the shards on ``cuda:0`` and
   ``cuda:1``, and the four fused kernels on that mesh, when two GPUs are
   visible (else one line says it did not run, and why);
9. the fused exchange-and-sweep kernels (``csrc/stencil_fused.cu``: fused
   DMA tb 1/2, fused RDMA tb 1/2), every shard on ``cuda:0`` in one launch:
   phase 4 holds them bitwise to their plain versions on (4,1,1), (8,1,1)
   and (2,2,2) at 128^3 (with the landed ghosts), 7pt/27pt x Dirichlet
   0.3/periodic x fp32/bf16, the RDMA ones with the plan's sub-blocks at
   the default floor and at floor 0, at the full-width shard shapes of
   1024^3 over (8,1,1) and (4,1,1), and on a ragged, odd ny*nz (2,1,1)
   mesh (sends whole, in two and in three ranges); 50 launches in a row
   without a host
   sync; a state built mid-run on busy streams (1024^3 on (8,1,1), tb=2, 11
   steps, equal to the (1,1,1) solve); and every overlap route's 128^3
   solve against the (1,1,1) solve. Phases 5 and 6 run the overlap routes
   through the command line (golden) and ``bench_throughput`` (1024^3);
   phase 7 times each fused kernel at 1024^3 over all shards of the card
   (on its compile-time instance and on the generic instance forced, in
   the same call).

``--only`` runs phases 1 and 2 and the named ones of ``PHASES`` (the
check after a kernel change, before the whole run) and prints no kernels
line. The kernel launch counts are zeroed just before phase 5 and read just after
phase 6; the script fails if any kernel was not launched there, if a
direct, stream or fused kernel launch there took the generic instance, or
if a computing wrapper (all but the DMA pair; the Mehrstellen instances
too) launched no bf16-compute instance there
(``compute_bf16_instance_launches``).
The ``main_path``
line also gives each wrapper's output cells as launches of the size the
kernels line times (1024^3-equivalent launches) and the Mehrstellen
instances' launches; the script fails if the knob's rows launched none.
The last
three lines are the kernels' JSON object (``{"kernels": [...]}``: the
nine wrappers and the two Mehrstellen instances; each computing entry
with ``compute_bf16_ms``, its ``max_abs_err`` the worst over both compute
dtypes), the
nvidia-smi line, and the status object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
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
    "apply_step_fused_dma": "heat3d_tpu_torch/csrc/stencil_fused.cu",
    "apply_superstep_fused_dma": "heat3d_tpu_torch/csrc/stencil_fused.cu",
    "apply_step_fused_rdma": "heat3d_tpu_torch/csrc/stencil_fused.cu",
    "apply_superstep_fused_rdma": "heat3d_tpu_torch/csrc/stencil_fused.cu",
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
    "apply_step_fused_dma": "heat3d_tpu/ops/stencil_dma_fused.py:515",
    "apply_superstep_fused_dma": "heat3d_tpu/ops/stencil_dma_fused.py:894",
    "apply_step_fused_rdma": "heat3d_tpu/ops/stencil_fused_rdma.py:193",
    "apply_superstep_fused_rdma": "heat3d_tpu/ops/stencil_fused_rdma.py:299",
}
# the fused kernels: (updates, plain version's name in ops.stencil_dma_fused)
_FUSED = {
    "apply_step_fused_dma": (1, "reference_fused_step"),
    "apply_superstep_fused_dma": (2, "reference_fused_superstep"),
    "apply_step_fused_rdma": (1, "reference_fused_step"),
    "apply_superstep_fused_rdma": (2, "reference_fused_superstep"),
}
KERNELS = tuple(_SOURCES)
# the Mehrstellen q-ring instances of the direct kernels (HEAT3D_MEHRSTELLEN,
# 27pt): a line each in the kernels' JSON beside their wrapper's, as
# (wrapper, halo)
_MEHR = {"apply_taps_direct:mehrstellen": ("apply_taps_direct", 1),
         "apply_taps_direct2:mehrstellen": ("apply_taps_direct2", 2)}
# the kernels that compute (all but the DMA pair, which moves bytes), with a
# bf16-compute instance each
COMPUTE_KERNELS = tuple(n for n in KERNELS if n != "halo_dma") + tuple(_MEHR)
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
    and row sums counted once (as the plain version caches them): the
    package's ``chain_ops``, which the bench rows carry too."""
    from heat3d_tpu_torch.ops.stencil_direct import chain_ops

    return chain_ops(taps)


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
    "fused": "per shard: read u, write u_new (2 field passes), plus each x-face "
             "slab sent read once and written once into the neighbour's landing "
             "buffer",
}


def x_sends(mesh, periodic: bool) -> int:
    """The x-face sends of one fused launch over ``mesh``: one each way
    between x neighbours (a Dirichlet x domain face sends nothing)."""
    px, py, pz = mesh
    return 2 * (px if periodic else px - 1) * py * pz


def fused_bound(n: int, mesh, k: int, itemsize: int, flops: int, bw: float,
                periodic: bool = False):
    """Bound of one fused launch (the whole step or superstep of the x-slab
    fused routes) over an n^3 grid on ``mesh``: (ms, "bytes"/"operations",
    bytes); the operations are the k useful updates."""
    m = [n // p for p in mesh]
    moved = (2 * n**3 + 2 * x_sends(mesh, periodic) * k * m[1] * m[2]) * itemsize
    t, by = bound_ms(moved, n**3 * k * flops, bw)
    return t, by, moved


def sharded_superstep_bound(route: str, n: int, mesh, k: int, itemsize: int,
                            flops: int, bw: float):
    """Bound of one superstep (or step) of the sharded solve of an n^3 grid
    over ``mesh``: (ms, "bytes"/"operations", bytes) from the passes of
    ``_BOUND_PASSES``; the operations are the k useful updates (the
    faces-direct and fused routes; the 3D fused route counts as
    faces-direct, whose bytes it moves) or each shard's raw trapezoid (the
    exchange path and the overlap split, as ``superstep_bound``)."""
    if route in ("fused-dma", "fused-dma2", "fused-rdma", "fused-rdma2"):
        return fused_bound(n, mesh, k, itemsize, flops, bw)
    m = [n // p for p in mesh]
    shards = mesh[0] * mesh[1] * mesh[2]
    cells = m[0] * m[1] * m[2]
    padded = (m[0] + 2 * k) * (m[1] + 2 * k) * (m[2] + 2 * k)
    if route.startswith("faces") or route == "fused-dma-3d":
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


def _instance_name(code: int) -> str:
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    if code == sd.MEHRSTELLEN:
        return "mehrstellen"
    return ss.CHAINS[code][0] if code in ss.CHAINS else "generic"


# the key suffix of a bf16-compute instance (the arithmetic policy
# Bf16Math of csrc/stencil_common.cuh); fp32-compute keys have none
BF16C = "_bf16c"
_DTYPE_NAMES = {"f": "float32", "13__nv_bfloat16": "bfloat16"}


def _compute_tag(entry: str) -> str:
    """``BF16C`` for a kernel of the bf16 policy, by its mangled name."""
    return BF16C if "Bf16Math" in entry else ""


def _ptxas(source: str, kernel: str, prefix: str) -> dict:
    """Registers and spills (bytes) of each compile-time instance of
    ``kernel`` in ``source``, from the compiler's report, keyed
    ``<prefix><n>_<chain>_<dtype>`` (+ ``BF16C`` in bf16 compute)."""
    import re

    from heat3d_tpu_torch.ops import _build

    out = {}
    for entry, r in _build.ptxas_report(source).items():
        m = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d)ELi(\d)E", entry)
        if m:
            out[f"{prefix}{m.group(2)}_{_instance_name(int(m.group(3)))}_"
                f"{_DTYPE_NAMES[m.group(1)]}{_compute_tag(entry)}"] = r
    return out


def _direct_ptxas() -> dict:
    """Registers and spills (bytes) of each compile-time direct instance,
    keyed ``h<halo>_<chain>_<dtype>`` (+ ``BF16C``)."""
    return _ptxas("stencil_direct", "direct_kernel", "h")


def _stream_ptxas() -> dict:
    """Registers and spills (bytes) of each compile-time stream instance,
    keyed ``k<k>_<chain>_<dtype>`` (+ ``BF16C``)."""
    return _ptxas("stencil_stream", "stream_kernel", "k")


def _fused_ptxas() -> dict:
    """Registers and spills (bytes) of each fused kernel instance, from the
    compiler's report, keyed ``h<halo>_<instance>_<dtype>`` (the
    compile-time instances by chain, + ``BF16C`` in bf16 compute; the
    interpreted kernels, one for both compute dtypes, as ``generic``)."""
    import re

    from heat3d_tpu_torch.ops import _build

    out = _ptxas("stencil_fused", "fused_chain_kernel", "h")
    for entry, r in _build.ptxas_report("stencil_fused").items():
        m = re.search(r"fused_kernelI(f|13__nv_bfloat16)Li(\d)E", entry)
        if m:
            out[f"h{m.group(2)}_generic_{_DTYPE_NAMES[m.group(1)]}"] = r
    return out


def _computes(code: int):
    """(compute dtype, key suffix) of the instances of ``code``: both
    policies for a compile-time instance; the generic instance serves both
    compute dtypes with one kernel, reported once."""
    import torch

    from heat3d_tpu_torch.ops.stencil_stream import GENERIC

    both = ((torch.float32, ""), (torch.bfloat16, BF16C))
    return both if code != GENERIC else both[:1]


def phase_build() -> dict:
    """Build every source; print the compiler's report and each source's
    build seconds, each stream, direct and fused instance's shared memory,
    registers, spills and resident blocks per SM (fp32 and bf16 compute).
    Returns those, keyed ``k<k>_<instance>_<dtype>`` (stream),
    ``h<halo>_<instance>_<dtype>`` (direct) and
    ``fused_h<halo>_<instance>_<dtype>``, + ``BF16C`` for a bf16-compute
    instance."""
    import torch

    from heat3d_tpu_torch.ops import _build
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    seconds = _build.build_all()
    _say("build", seconds=seconds)
    for name in seconds:
        print(_build.build_log(name).strip(), flush=True)
    spills = ("registers", "spill_stores", "spill_loads")
    ptxas = _stream_ptxas()
    _check(len(ptxas) == 32, f"compiler report of the stream instances: {sorted(ptxas)}")
    resources = {}
    for k in (1, *ss.STREAMK_DEPTHS):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype in (torch.float32, torch.bfloat16):
                for cd, tag in _computes(code):
                    key = f"k{k}_{_instance_name(code)}_{str(dtype)[6:]}{tag}"
                    resources[key] = {**ss.instance_resources(k, code, dtype, cd),
                                      **{f: ptxas.get(key, {}).get(f) for f in spills[1:]}}
                    _check(resources[key]["blocks_per_sm"] > 0,
                           f"stream instance {key} fits no SM: {resources[key]}")
    _say("build", stream_instances=resources)
    ptxas = _direct_ptxas()
    direct = {}
    for h in (1, 2):
        for code in (ss.GENERIC, *ss.CHAINS, sd.MEHRSTELLEN):
            for dtype in (torch.float32, torch.bfloat16):
                for cd, tag in _computes(code):
                    key = f"h{h}_{_instance_name(code)}_{str(dtype)[6:]}{tag}"
                    direct[key] = {**sd.instance_resources(h, code, dtype, cd),
                                   **{f: ptxas.get(key, {}).get(f) for f in spills[1:]}}
                    _check(direct[key]["blocks_per_sm"] > 0,
                           f"direct instance {key} fits no SM: {direct[key]}")
    _check(len(ptxas) == 24, f"compiler report of the direct instances: {sorted(ptxas)}")
    _say("build", direct_instances=direct)
    resources.update(direct)
    ptxas = _fused_ptxas()
    fused = {}
    for h in (1, 2):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype in (torch.float32, torch.bfloat16):
                for cd, tag in _computes(code):
                    key = f"h{h}_{_instance_name(code)}_{str(dtype)[6:]}{tag}"
                    fused[key] = {**fd.instance_resources(h, code, dtype, cd),
                                  **{f: ptxas.get(key, {}).get(f) for f in spills[1:]}}
                    _check(fused[key]["blocks_per_sm"] > 0,
                           f"fused instance {key} fits no SM: {fused[key]}")
    _check(len(ptxas) == 20, f"compiler report of the fused instances: {sorted(ptxas)}")
    _say("build", fused_instances=fused)
    resources.update({f"fused_{k}": v for k, v in fused.items()})
    return resources


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


def _kernel_pair(name, k, edges=(True,) * 6, cd=None):
    """``name``'s kernel and its plain version, both called as
    ``f(x, taps, periodic, bc_value)`` on ``_kernel_input``'s ``x`` (the
    kernel also takes ``out=``) in compute dtype ``cd`` (default float32);
    streamk with the domain-edge mask ``edges`` (default: a whole-domain
    block's)."""
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss
    from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded

    cd = cd or torch.float32
    if name in ("apply_taps_direct", "apply_taps_direct2"):
        kern = getattr(sd, name)
        ref = getattr(sd, name + "_ref")
        return (lambda x, t, p, b, out=None: kern(x, t, p, b, out=out, compute_dtype=cd),
                lambda x, t, p, b: ref(x, t, p, b, cd))
    if name == "apply_taps_stream":
        return (lambda x, t, p, b, out=None: ss.apply_taps_stream(x, t, out=out,
                                                                  compute_dtype=cd),
                lambda x, t, p, b: apply_taps_padded(x, t, compute_dtype=cd))
    return (lambda x, t, p, b, out=None: ss.apply_taps_streamk(x, t, k, p, b, out=out,
                                                               edges=edges, compute_dtype=cd),
            lambda x, t, p, b: ss.apply_taps_streamk_ref(x, t, k, p, b, edges, cd))


def _run_kernel(name, u, taps, periodic, bcv, k=1, cd=None):
    """(kernel output, plain output) of ``name`` on field ``u`` in compute
    dtype ``cd``."""
    kern, plain = _kernel_pair(name, k, cd=cd)
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


def phase_compare(worst: dict) -> None:
    """Each kernel against its plain version on the card, bitwise, folding
    the largest |kernel - plain| of each kernel into ``worst``; the
    streamk plain version against k direct launches; and the exchange-path
    solve against the direct-path solve."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss

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
    direct = _compare_direct(worst)
    generic = _compare_generic(worst)
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
         direct_instances=direct, generic_instance=generic, launches=ops.launch_counts())


# the direct kernels' ragged shapes: nx below 2H+1, odd nz, y and z no
# multiple of the compile-time tiles (38 x 62 at halo 1, 28 x 60 at halo 2),
# several tiles each way, and nx = 1024 (x cut into chunks); with the
# x-chunk forced to 3 planes on (40, 70, 65)
_DIRECT_SHAPES = ((1, 1, 1), (2, 3, 5), (4, 45, 130), (5, 77, 125), (6, 39, 127),
                  (1024, 257, 131))
_DIRECT_FORCED_CHUNK = ((40, 70, 65), 3)


def _generic_counts() -> dict:
    """Launches that took the generic instance, per kernel wrapper (the
    one-update fused wrappers too)."""
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.ops import stencil_stream as ss

    return {**sd.generic_launch_counts(), **ss.generic_launch_counts(),
            **fd.generic_launch_counts(), **fr.generic_launch_counts()}


def _hold_instance(worst, name, u, taps, periodic, bcv, k, what, chunk=None) -> None:
    """``name`` on ``u`` bitwise against its plain version, on the instance
    ``stream_instance`` names (the wrapper's generic count says which ran);
    ``chunk`` forces the direct kernels' x-chunk to that many planes."""
    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    code = ss.stream_instance(taps)
    before = _generic_counts()[name]
    if chunk is None:
        got, want = _run_kernel(name, u, taps, periodic, bcv, k)
    else:
        got = sd.launch_instance(k, sd.direct_instance(taps), u, taps, periodic, bcv,
                                 xchunk=chunk)
        want = _kernel_pair(name, k)[1](u, taps, periodic, bcv)
    _hold(worst, name, got, want, what)
    took = _generic_counts()[name] - before
    _check(took == (code == ss.GENERIC),
           f"{name} {what}: generic launches {took}, instance {_instance_name(code)}")


def _compare_direct(worst: dict) -> int:
    """The direct kernels (halo 1 and 2) at ``_DIRECT_SHAPES`` and a forced
    multi-chunk case, 7pt/27pt x fp32/bf16 x Dirichlet bc 0 and 0.3 and
    periodic, bitwise against their plain versions on the instance
    ``stream_instance`` names. Returns the number of cases."""
    import numpy as np
    import torch

    cases = 0
    shapes = [(shape, None) for shape in _DIRECT_SHAPES] + [_DIRECT_FORCED_CHUNK]
    for shape, chunk in shapes:
        base = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in _BCS:
                    for name, k in _cases()[:2]:
                        _hold_instance(worst, name, u, taps, periodic, bcv, k,
                                       f"at {shape} chunk {chunk} {dtype} {kind} "
                                       f"periodic={periodic} bc={bcv}", chunk)
                        cases += 1
            del u
        torch.cuda.empty_cache()
    return cases


# the factoring knobs of the compare phase's generic-instance cases
_KNOBS = ({"HEAT3D_FACTOR_7PT": "1"}, {"HEAT3D_FACTOR_Y": "0"},
          {"HEAT3D_FACTOR_7PT": "1", "HEAT3D_FACTOR_Y": "0"})


def _compare_generic(worst: dict) -> dict:
    """Every stencil kernel (direct1, direct2, the stream kernel and streamk
    at k = 2..4, and the one- and two-update fused kernels over (4,1,1)) at 128^3
    under the factoring knobs, 7pt/27pt x fp32/bf16 x three boundary
    settings (fused: Dirichlet 0.3 and periodic), bitwise against its plain
    version; each launch must take the instance ``stream_instance`` names
    (the generic one exactly where the emission program is not a ``CHAINS``
    entry), counted by the wrappers."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    base = np.random.default_rng(9).standard_normal((128, 128, 128)).astype(np.float32)
    mesh = _card_mesh((4, 1, 1), (32, 128, 128))
    cases = {}
    for knobs in _KNOBS:
        with _env(**knobs):
            for dtype in (torch.float32, torch.bfloat16):
                u = torch.from_numpy(base).cuda().to(dtype)
                us = _split(u, mesh)
                for kind in ("7pt", "27pt"):
                    taps = _taps(kind)
                    code = ss.stream_instance(taps)
                    tag = f"{'+'.join(f'{k}={v}' for k, v in knobs.items())} {kind}"
                    cases[tag] = _instance_name(code)
                    for periodic, bcv in _BCS:
                        for name, k in _cases():
                            _hold_instance(worst, name, u, taps, periodic, bcv, k,
                                           f"k={k} at 128^3 {dtype} {tag} "
                                           f"periodic={periodic} bc={bcv}")
                    for (periodic, bcv), name in itertools.product(
                            ((False, 0.3), (True, 0.0)),
                            ("apply_step_fused_dma", "apply_superstep_fused_dma")):
                        kern, plain = _fused_pair(name)
                        before = _generic_counts()[name]
                        state = fd.FusedState(mesh, _FUSED[name][0], dtype, periodic)
                        got = kern(us, taps, mesh, state, periodic, bcv)
                        _hold_fused(worst, name, got, plain(us, taps, mesh, None, periodic, bcv),
                                    f"128^3 on (4,1,1) {dtype} {tag} periodic={periodic}")
                        took = _generic_counts()[name] - before
                        _check(took == (code == ss.GENERIC),
                               f"{name} {tag}: generic launches {took}, instance "
                               f"{_instance_name(code)}")
                del u, us
    return cases


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
                    no_direct=False, device=None, **knobs):
    """The host field after ``steps`` updates of a random initial field."""
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    cfg = SolverConfig(
        grid=GridConfig(shape=n if isinstance(n, tuple) else (n, n, n)),
        stencil=StencilConfig(kind=kind, bc=_bc(periodic), bc_value=bcv),
        mesh=MeshConfig(shape=mesh), halo=halo,
        precision=Precision(storage=storage), time_blocking=tb, **knobs,
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


# (mesh, extra flags, time_blocking, HEAT3D_NO_DIRECT, kernel it must launch)
# of the golden phase's overlap-route runs on cuda:0; the partitioned runs
# with HEAT3D_PLAN_PART_MIN_BYTES=0, so a 128^3 face ships as sub-blocks
_GOLDEN_FUSED = (
    ((8, 1, 1), ["--halo", "dma", "--overlap"], 1, False, "apply_step_fused_dma"),
    ((8, 1, 1), ["--halo", "dma", "--overlap"], 2, False, "apply_superstep_fused_dma"),
    ((2, 2, 2), ["--halo", "dma", "--overlap"], 1, False, "apply_step_fused_dma"),
    ((4, 1, 1), ["--fused-rdma", "on", "--halo-plan", "partitioned"], 1, False,
     "apply_step_fused_rdma"),
    ((4, 1, 1), ["--fused-rdma", "on", "--halo-plan", "partitioned"], 2, False,
     "apply_superstep_fused_rdma"),
    ((2, 2, 2), ["--overlap"], 1, True, "apply_taps_stream"),
)


@contextlib.contextmanager
def _env(**kw):
    """Set environment variables for the block."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    for kind in ("7pt", "27pt"):
        for mesh, flags, tb, no_direct, want in _GOLDEN_FUSED:
            with _no_direct(no_direct), _env(HEAT3D_PLAN_PART_MIN_BYTES="0"):
                _golden_cli(["--grid", "128", "--steps", "20", "--stencil", kind,
                             "--time-blocking", str(tb), "--mesh", *map(str, mesh), *flags,
                             "--device", "cuda:0"],
                            want, grid=128, stencil=kind, mesh=list(mesh), flags=flags,
                            time_blocking=tb, no_direct=no_direct)


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
# (mesh, knobs, time_blocking, HEAT3D_NO_DIRECT) of the full-width phase's
# overlap-route rows: fp32 7pt, every shard on cuda:0
_FUSED_FULL_WIDTH = (
    ((8, 1, 1), {"halo": "dma", "overlap": True}, 1, False),
    ((8, 1, 1), {"halo": "dma", "overlap": True}, 2, False),
    ((2, 2, 2), {"halo": "dma", "overlap": True}, 1, False),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 1, False),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 2, False),
    ((2, 2, 2), {"overlap": True}, 1, True),
)


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

    for mesh, knobs, tb, no_direct in _FUSED_FULL_WIDTH:
        cfg = SolverConfig(grid=GridConfig.cube(n), mesh=MeshConfig(shape=mesh),
                           time_blocking=tb, **knobs)
        with _no_direct(no_direct):
            row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                                   device="cuda:0")
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        b_ms, by, b_bytes = sharded_superstep_bound(
            route, n, mesh, tb, 4, flops_per_update(_taps("7pt")), bw)
        _check(route in ("fused-dma", "fused-dma2", "fused-dma-3d", "fused-rdma",
                         "fused-rdma2", "overlap"), f"not an overlap route: {row}")
        ex_ms = _exchange_ms(cfg, route) if route == "overlap" else None
        passes = ("fused" if route.startswith("fused") and route != "fused-dma-3d"
                  else "faces" if route == "fused-dma-3d" else "exchange")
        _say("full_width", grid=row["grid"], stencil="7pt", dtype="float32",
             mesh=row["mesh"], halo=row["halo"], overlap=row["overlap"],
             fused_rdma=row["fused_rdma"], halo_plan=row["halo_plan"],
             messages_per_exchange=row["messages_per_exchange"], no_direct=no_direct,
             shards_per_device=row["shards_per_device"], time_blocking=tb, route=route,
             steps=row["steps"], gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"], exchange_ms=ex_ms,
             bound_ms_per_superstep=b_ms, bound_by=by, bound_bytes=b_bytes,
             bound_passes=_BOUND_PASSES[passes],
             bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
        del row
        torch.cuda.empty_cache()

    for mesh, halo, tb, knobs in (((1, 1, 1), "ppermute", 2, {}),
                                  ((1, 1, 1), "ppermute", 4, {}),
                                  (_MESH, "dma", 4, {}),
                                  ((8, 1, 1), "dma", 2, {"overlap": True})):
        cfg = SolverConfig(
            grid=GridConfig.cube(n),
            stencil=StencilConfig(kind="7pt", bc=_bc(True)),
            mesh=MeshConfig(shape=mesh), halo=halo, time_blocking=tb, **knobs,
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
        _say("conservation", grid=[n, n, n], mesh=list(mesh), halo=halo, **knobs,
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


def phase_kernel_times(bw: float, worst: dict, resources: dict) -> dict:
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
            if name.startswith("apply_taps_stream"):
                times[n][key]["blocks_per_sm"] = resources[f"k{k}_7pt_float32"]["blocks_per_sm"]
            else:
                times[n][key].update(_direct_generic_ms(worst, name, k, u, taps, out))
                times[n][key].update(resources[f"h{k}_7pt_float32"])
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
    _say("direct_times", grid=[1024] * 3,
         variants=_direct_variant_times(bw, worst, resources),
         generic_over_compiled={name: t[name]["generic_ms"] / t[name]["ms"]
                                for name in ("apply_taps_direct", "apply_taps_direct2")},
         max_abs_err={n: worst[n] for n in ("apply_taps_direct", "apply_taps_direct2")})
    variants = _stream_variant_times(bw, worst, resources)
    d1, d2 = t["apply_taps_direct"]["ms"], t["apply_taps_direct2"]["ms"]
    ratios = {
        "stream1_over_direct1": t["apply_taps_stream"]["ms"] / d1,
        "streamk_k2_over_direct2": t["apply_taps_streamk_k2"]["ms"] / d2,
        "streamk_k4_over_direct2": t["apply_taps_streamk_k4"]["ms"] / d2,
    }
    _say("stream_times", grid=[1024] * 3, variants=variants, ratios_7pt_float32=ratios,
         direct_ms={"apply_taps_direct": d1, "apply_taps_direct2": d2},
         max_abs_err={n: worst[n] for n in ("apply_taps_stream", "apply_taps_streamk")})
    t["apply_taps_streamk"] = t[f"apply_taps_streamk_k{_STREAMK_HEADLINE}"]
    return t


def _direct_generic_ms(worst: dict, name: str, halo: int, u, taps, out) -> dict:
    """The generic (interpreted) direct instance forced on ``taps``' chain:
    its ms per launch on ``u``, the last launch held bitwise to the plain
    version. ``out`` is overwritten."""
    from heat3d_tpu_torch.ops import stencil_direct as sd

    ms = _time_ms(lambda: sd.launch_instance(halo, 0, u, taps, out=out), iters=10)
    _, plain = _kernel_pair(name, halo)
    _hold(worst, name, out, plain(u, taps, False, 0.0),
          f"generic instance at {tuple(u.shape)} {u.dtype}")
    return {"generic_ms": ms}


def _direct_variant_times(bw: float, worst: dict, resources: dict) -> dict:
    """direct1 and direct2 at 1024^3, Dirichlet bc 0, in the 27pt fp32 and
    7pt bf16 instances (the 7pt fp32 ones are ``kernel_times``'): ms per
    launch, bound, registers, spills, blocks per SM and shared memory, each
    launch held bitwise to its plain version."""
    import torch

    from heat3d_tpu_torch.ops import stencil_stream as ss

    n = 1024
    out_times = {}
    for kind, dtype in (("27pt", torch.float32), ("7pt", torch.bfloat16)):
        taps = _taps(kind, n)
        u = torch.rand((n, n, n), device="cuda").to(dtype)
        out = torch.empty_like(u)
        for name, halo in _cases()[:2]:
            kern, plain = _kernel_pair(name, halo)
            ms = _time_ms(lambda: kern(u, taps, False, 0.0, out=out), iters=10)
            _hold(worst, name, out, plain(u, taps, False, 0.0),
                  f"at {n}^3 {kind} {dtype} bc=0.0")
            b_ms, by = kernel_bound(name, n, halo, u.element_size(), flops_per_update(taps), bw)
            code = ss.stream_instance(taps)
            out_times[f"h{halo}_{kind}_{str(dtype)[6:]}"] = {
                "ms": ms, "bound_ms": b_ms, "bound_by": by, "instance": _instance_name(code),
                **resources[f"h{halo}_{_instance_name(code)}_{str(dtype)[6:]}"]}
        del u, out
        torch.cuda.empty_cache()
    return out_times


def _stream_variant_times(bw: float, worst: dict, resources: dict) -> dict:
    """The stream kernel and streamk K=4 at 1024^3, Dirichlet bc 0, in the
    27pt fp32 and 7pt bf16 instances (the 7pt fp32 ones are
    ``kernel_times``'): ms per launch, bound, blocks per SM and shared
    memory, each launch held bitwise to its plain version."""
    import torch

    from heat3d_tpu_torch.ops import stencil_stream as ss

    n = 1024
    out_times = {}
    for kind, dtype in (("27pt", torch.float32), ("7pt", torch.bfloat16)):
        taps = _taps(kind, n)
        u = torch.rand((n, n, n), device="cuda").to(dtype)
        for name, k in (("apply_taps_stream", 1), ("apply_taps_streamk", _STREAMK_HEADLINE)):
            kern, plain = _kernel_pair(name, k)
            x = _padded(u, False, 0.0, k)
            out = torch.empty_like(u)
            ms = _time_ms(lambda: kern(x, taps, False, 0.0, out=out), iters=10)
            _hold(worst, name, out, plain(x, taps, False, 0.0),
                  f"k={k} at {n}^3 {kind} {dtype} bc=0.0")
            b_ms, by = kernel_bound(name, n, k, u.element_size(), flops_per_update(taps), bw)
            code = ss.stream_instance(taps)
            out_times[f"k{k}_{kind}_{str(dtype)[6:]}"] = {
                "ms": ms, "bound_ms": b_ms, "bound_by": by,
                "instance": _instance_name(code),
                **resources[f"k{k}_{_instance_name(code)}_{str(dtype)[6:]}"]}
            del x, out
            torch.cuda.empty_cache()
        del u
        torch.cuda.empty_cache()
    return out_times


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


def _unit_cells(name: str) -> int:
    """Output cells of the launch the kernels line times: a 1024^3 field for
    the stencil and fused kernels; for the DMA pairs the ghost cells of one
    whole width-1 exchange over the (2,2,2) mesh of 512^3 shards (two slabs
    a shard and axis, as ``halo_dma.cell_counts`` counts them)."""
    if name != "halo_dma":
        return 1024**3
    m, w = 512, 1
    padded = m + 2 * w
    per_shard = 2 * (w * m * m + padded * w * m + padded * padded * w)
    return 8 * per_shard


def _dma_sector_bytes(mesh, axis: int, width: int, itemsize: int, periodic: bool) -> int:
    """The least bytes one axis of the DMA exchange moves in 32-byte sectors:
    each slab row (contiguous along z) touches at least ceil(row bytes / 32)
    sectors, once read and once written where pushed, once written where
    filled. x and y rows are whole z rows, so this is their byte count; a
    z slab's rows are ``width`` elements, a sector each."""
    local = mesh.local_shape
    ext = [width if a == axis else (m + 2 * width if a < axis else m)
           for a, m in enumerate(local)]
    per_side = ext[0] * ext[1] * -(-ext[2] * itemsize // 32) * 32
    total = 0
    for s in mesh.shards:
        for d in (-1, +1):
            total += per_side * (1 if mesh.neighbor(s, axis, d, periodic) is None else 2)
    return total


def _per_call_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """Device ms per call of ``fn(calls)`` (which makes ``calls`` calls in a
    row), the least of ``samples``, after one warm-up call."""
    import torch

    fn(1)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(calls)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def phase_dma_times(bw: float, worst: dict) -> dict:
    """The DMA exchange of each axis on a (2,2,2) mesh of 512^3 fp32 shards
    on cuda:0 (Dirichlet bc 0, the full-width phase's setting), at widths 1
    and 4, against the plain version's slab copies (which are
    ``Tensor.copy_`` calls, the library yardstick too). ``ms``: the least of
    10 single calls, each between its own events (the kernels' with its own
    fork and join of the shard streams), as earlier PRs timed it;
    ``ms_in_a_row``: the mean of 20 calls in a row (the kernels' between one
    fork and one join), the least of 5 samples; the same two for the copies.
    Beside them the byte bound, the sector floor (``_dma_sector_bytes``) and
    the kernel launches a call makes; each held bitwise to the plain version
    there. Returns the kernels-line entry: one whole width-1 exchange's DMA
    launches (all three axes, single calls), the tb=1 main path's."""
    import torch

    from heat3d_tpu_torch.ops import halo_dma

    mesh = _card_mesh(_MESH, (512, 512, 512))
    times = {}
    for width in (1, 4):
        pads = [torch.rand(tuple(m + 2 * width for m in mesh.local_shape),
                           device=s.device) for s in mesh.shards]
        state = halo_dma.DmaState(mesh, pads, width, False)
        for axis in range(3):
            def kern(calls=1):
                mesh.fork()
                for _ in range(calls):
                    state.epoch += 1
                    halo_dma.exchange_axis_dma(pads, mesh, axis, width, False, 0.0, state)
                mesh.join()

            def plain(calls=1):
                for _ in range(calls):
                    halo_dma.exchange_axis_dma_ref(pads, mesh, axis, width, False, 0.0)

            before = halo_dma.launch_counts()["halo_dma"]
            kern()
            launches = halo_dma.launch_counts()["halo_dma"] - before
            ms = _time_ms(kern, iters=10)
            plain_ms = _time_ms(plain, iters=10)
            moved = _dma_axis_bytes(mesh, axis, width, 4, False)
            sectors = _dma_sector_bytes(mesh, axis, width, 4, False)
            b_ms, by = bound_ms(moved, 0, bw)
            times[f"w{width}_axis{axis}"] = {
                "ms": ms, "plain_ms": plain_ms, "ms_in_a_row": _per_call_ms(kern),
                "plain_ms_in_a_row": _per_call_ms(plain), "bound_ms": b_ms,
                "bound_by": by, "bytes": moved, "sector_bytes": sectors,
                "sector_floor_ms": sectors / bw * 1e3, "launches_per_call": launches,
                "library_ms": plain_ms}
            want = [p.clone() for p in pads]
            kern()
            halo_dma.exchange_axis_dma_ref(want, mesh, axis, width, False, 0.0)
            _hold_blocks(worst, pads, want, f"axis {axis} width {width} on 512^3 shards")
            _check(launches <= 2, f"DMA axis {axis} width {width}: {launches} launches a call")
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
    and periodic (which pins nothing); and ``stream1`` as the overlap split
    runs it, on the unpadded shard as its own padded input (512^3 ->
    510^3). Each launch is held bitwise to its plain version and timed
    beside its bound; ``eight_ms`` is eight launches, one superstep's
    kernel time on the card."""
    import torch

    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    m, k = 512, _STREAMK_HEADLINE
    mesh = _card_mesh(_MESH, (m, m, m))
    taps = _taps("7pt", 2 * m)
    flops = flops_per_update(taps)
    us = [torch.rand((m, m, m), device=s.device) for s in mesh.shards]
    lo, hi = mesh.shards[0], mesh.shards[-1]
    times = {}

    def held(key, name, kk, x, periodic, edges=(True,) * 6, n_out=m):
        kern, plain = _kernel_pair(name, kk, edges)
        want = plain(x, taps, periodic, 0.0)
        out = torch.empty_like(want)
        ms = _time_ms(lambda: kern(x, taps, periodic, 0.0, out=out), iters=10)
        plain_ms = _time_ms(lambda: plain(x, taps, periodic, 0.0), iters=3)
        _hold(worst, name, out, want, f"{key} on a {tuple(x.shape)} input, edges {edges}")
        b_ms, by = kernel_bound(name, n_out, kk, 4, flops, bw)
        times[key] = {"ms": ms, "eight_ms": 8 * ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": by, "out": list(out.shape),
                      "edges": list(edges) if name == "apply_taps_streamk" else None}

    held("apply_taps_direct", "apply_taps_direct", 1, us[0], False)
    held("apply_taps_direct2", "apply_taps_direct2", 2, us[0], False)
    # the overlap split's interior: the shard as its own padded input
    held("apply_taps_stream_overlap_interior", "apply_taps_stream", 1, us[0], False,
         n_out=m - 2)
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
    del us
    torch.cuda.empty_cache()
    _say("shard_kernel_times", mesh=list(_MESH), shard=[m, m, m], stencil="7pt",
         dtype="float32", bc_value=0.0, times=times, bitwise=True,
         max_abs_err={n: worst[n] for n in KERNELS if n != "halo_dma"})


def _fused_state(mesh, name, dtype, periodic, floor=None):
    """The state of fused kernel ``name`` over ``mesh``: whole-face sends
    for the DMA kernels; the RDMA ones take the x-face sub-blocks of a
    partitioned plan schedule at the granularity ``floor`` (default: the
    plan's own)."""
    import torch

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.parallel.plan import DEFAULT_PART_MIN_BYTES, Schedule

    k = _FUSED[name][0]
    bounds = None
    if name.endswith("rdma"):
        sched = Schedule(mesh.shape, k, "partitioned",
                         min_part_bytes=DEFAULT_PART_MIN_BYTES if floor is None else floor)
        bounds = fr.plan_send_bounds(sched, mesh.local_shape,
                                     torch.empty((), dtype=dtype).element_size())
    return fd.FusedState(mesh, k, dtype, periodic, bounds)


def _fused_wrapper(name):
    """The wrapper function of fused kernel ``name`` (it holds the counts)."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr

    return getattr(fd, name, None) or getattr(fr, name)


def _fused_pair(name, cd=None):
    """(kernel wrapper, plain version) of fused kernel ``name``, both
    called ``f(us, taps, mesh, state, periodic, bc_value)``, in compute
    dtype ``cd`` (default float32; the kernel also takes ``outs=``)."""
    import torch

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    cd = cd or torch.float32
    wrapper = _fused_wrapper(name)
    ref = getattr(fd, _FUSED[name][1])

    def kern(us, t, m, st, p, b, outs=None):
        return wrapper(us, t, m, st, p, b, outs=outs, compute_dtype=cd)

    return kern, (lambda us, t, m, st, p, b: ref(us, t, m, p, b, compute_dtype=cd))


def _fused_names(mesh_shape, nx):
    """The fused kernels a mesh takes: all four on an x-slab (tb=2 needs
    nx >= 4), the one-update DMA kernel on an x-sharded block mesh."""
    if mesh_shape[1] == mesh_shape[2] == 1:
        return [n for n in _FUSED if _FUSED[n][0] == 1 or nx >= 4]
    return ["apply_step_fused_dma"]


def _hold_fused(worst, name, got, want, what):
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    import torch

    torch.cuda.synchronize()
    fd.raise_if_timed_out()
    for g, w in zip(got, want):
        _hold(worst, name, g, w, what)


def _fused_burst(worst, mesh, name, base_us, periodic, bcv, n=50):
    """``n`` launches of fused kernel ``name`` in a row on one state, each
    shard's new input made and its output copied out on the shard's own
    stream, with no host synchronisation between them; then each held to
    the plain version."""
    import torch

    taps = _taps("7pt")
    kern, plain = _fused_pair(name)
    state = _fused_state(mesh, name, base_us[0].dtype, periodic, floor=0)
    snaps = []
    mesh.fork()
    for i in range(n):
        us = []
        for s, b in zip(mesh.shards, base_us):
            with mesh.on(s):
                us.append(b + i)
        outs = kern(us, taps, mesh, state, periodic, bcv)
        snap = []
        for s, o in zip(mesh.shards, outs):
            with mesh.on(s):
                snap.append(o.clone())
        snaps.append(snap)
    mesh.join()
    for i, snap in enumerate(snaps):
        want = plain([b + i for b in base_us], taps, mesh, None, periodic, bcv)
        _hold_fused(worst, name, snap, want, f"launch {i + 1} of {n} on {mesh.shape}")
    del snaps
    torch.cuda.empty_cache()
    return n


# (mesh, knobs, HEAT3D_NO_DIRECT, stencil, storage, periodic) of the overlap
# routes' 128^3 solves against the (1,1,1) solve
_FUSED_SOLVES = (
    ((8, 1, 1), {"halo": "dma", "overlap": True}, 1, False, "7pt", "float32", False),
    ((8, 1, 1), {"halo": "dma", "overlap": True}, 2, False, "27pt", "bfloat16", True),
    ((4, 1, 1), {"halo": "dma", "overlap": True}, 2, False, "7pt", "float32", False),
    ((2, 2, 2), {"halo": "dma", "overlap": True}, 1, False, "27pt", "float32", False),
    ((2, 2, 2), {"halo": "dma", "overlap": True}, 1, False, "7pt", "float32", True),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 1, False, "7pt",
     "float32", False),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 2, False, "27pt",
     "float32", True),
    ((8, 1, 1), {"fused_rdma": "on"}, 2, False, "7pt", "bfloat16", False),
    ((2, 2, 2), {"overlap": True}, 1, True, "27pt", "float32", False),
    ((2, 2, 2), {"halo_plan": "partitioned"}, 2, False, "7pt", "float32", False),
)


def phase_compare_fused(worst: dict) -> None:
    """The fused kernels against their plain versions, bitwise, every shard
    on cuda:0 in one launch: 128^3 over (4,1,1), (8,1,1) and (2,2,2) (the
    landed ghosts too), 7pt/27pt x Dirichlet 0.3/periodic x fp32/bf16, the
    RDMA kernels at floor 0 and the default floor; the full-width shard
    shapes (1024^3 over (8,1,1), (4,1,1) and (2,2,2), the landed ghosts
    too); (8,77,125) over (2,1,1), a ragged, odd ny*nz (bf16 planes, landed
    ones too, start on either parity) with sends whole and in two and
    three ranges, the same settings; 50 launches in a row; the overlap
    routes' 128^3 solves against the
    (1,1,1) solve; and at 1024^3 against the (1,1,1) solve: the (8,1,1)
    tb=2 run whose tb=1 state is built mid-run on busy streams, the (2,2,2)
    3D fused route and the (2,2,2) overlap split."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.parallel.plan import partition_bounds
    from heat3d_tpu_torch.parallel.step import step_route, superstep_route

    t0 = time.perf_counter()
    cases = ghosts = 0
    for n, mesh_shapes, settings in (
        (128, ((4, 1, 1), (8, 1, 1), (2, 2, 2)),
         [(k, d, p, b) for k in ("7pt", "27pt") for d in (torch.float32, torch.bfloat16)
          for p, b in ((False, 0.3), (True, 0.0))]),
        (1024, ((8, 1, 1), (4, 1, 1), (2, 2, 2)),
         [("7pt", torch.float32, False, 0.3), ("7pt", torch.float32, True, 0.0),
          ("27pt", torch.float32, False, 0.0), ("7pt", torch.bfloat16, False, 0.0)]),
    ):
        base = torch.from_numpy(
            np.random.default_rng(12).standard_normal((n, n, n)).astype(np.float32)).cuda()
        for mesh_shape in mesh_shapes:
            mesh = _card_mesh(mesh_shape, tuple(n // p for p in mesh_shape))
            for kind, dtype, periodic, bcv in settings:
                taps = _taps(kind)
                us = _split(base.to(dtype), mesh)
                what = f"{n}^3 on {mesh_shape} {kind} {dtype} periodic={periodic} bc={bcv}"
                for name in _fused_names(mesh_shape, mesh.local_shape[0]):
                    kern, plain = _fused_pair(name)
                    for floor in ((0, None) if name.endswith("rdma") else (None,)):
                        state = _fused_state(mesh, name, dtype, periodic, floor)
                        got = kern(us, taps, mesh, state, periodic, bcv)
                        _hold_fused(worst, name, got,
                                    plain(us, taps, mesh, None, periodic, bcv),
                                    f"{what} ranges {state.bounds}")
                        cases += 1
                        del got, state
                state = fd.FusedState(mesh, 1, dtype, periodic)
                _, got = fd.apply_step_fused_dma(us, taps, mesh, state, periodic, bcv,
                                                 return_ghosts=True)
                _, want = fd.reference_fused_step(us, taps, mesh, periodic, bcv,
                                                  return_ghosts=True)
                for g, w in zip(got, want):
                    _hold_fused(worst, "apply_step_fused_dma", g, w, f"ghosts {what}")
                ghosts += 1
                del us, got, want, state
                torch.cuda.empty_cache()
        del base
        torch.cuda.empty_cache()

    mesh = _card_mesh((2, 1, 1), (4, 77, 125))
    base = torch.from_numpy(
        np.random.default_rng(16).standard_normal((8, 77, 125)).astype(np.float32)).cuda()
    for kind, dtype, (periodic, bcv) in itertools.product(
            ("7pt", "27pt"), (torch.float32, torch.bfloat16), ((False, 0.3), (True, 0.0))):
        taps = _taps(kind)
        us = _split(base.to(dtype), mesh)
        for name, parts in itertools.product(_FUSED, (1, 2, 3)):
            kern, plain = _fused_pair(name)
            state = fd.FusedState(mesh, _FUSED[name][0], dtype, periodic,
                                  partition_bounds(77, parts))
            got = kern(us, taps, mesh, state, periodic, bcv)
            _hold_fused(worst, name, got, plain(us, taps, mesh, None, periodic, bcv),
                        f"(8,77,125) on (2,1,1) {kind} {dtype} periodic={periodic} bc={bcv} "
                        f"ranges {state.bounds}")
            cases += 1
    del base, us

    mesh = _card_mesh((8, 1, 1), (16, 128, 128))
    base_us = _split(torch.from_numpy(
        np.random.default_rng(13).standard_normal((128, 128, 128)).astype(np.float32)).cuda(),
        mesh)
    bursts = (_fused_burst(worst, mesh, "apply_step_fused_dma", base_us, False, 0.3)
              + _fused_burst(worst, mesh, "apply_superstep_fused_rdma", base_us, True, 0.0))
    del base_us

    # 1024^3, 11 steps, against the (1,1,1) solve: (8,1,1) tb=2 builds the
    # tb=1 state of the remainder step while the supersteps still run on the
    # eight shard streams; (2,2,2) runs the 3D fused route and the overlap
    # split on 512^3 shards, the full-width rows' shapes
    def solve(mesh, **knobs):
        cfg = SolverConfig(grid=GridConfig.cube(1024),
                           stencil=StencilConfig(kind="7pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), **knobs)
        solver = HeatSolver3D(cfg, device="cuda:0")
        return solver, solver.run(solver.init_state("hot-cube"), 11)

    _, want = solve((1, 1, 1))
    full_solves = []
    for mesh_shape, knobs, no_direct, route in (
        ((8, 1, 1), dict(halo="dma", overlap=True, time_blocking=2), False, "fused-dma2"),
        ((2, 2, 2), dict(halo="dma", overlap=True), False, "fused-dma-3d"),
        ((2, 2, 2), dict(overlap=True), True, "overlap"),
    ):
        with _no_direct(no_direct):
            solver, got = solve(mesh_shape, **knobs)
            took = (superstep_route(solver.cfg) if solver.cfg.time_blocking > 1
                    else step_route(solver.cfg))
        torch.cuda.synchronize()
        fd.raise_if_timed_out()
        _check(took == route, f"{mesh_shape} {knobs} took {took}, not {route}")
        for s, shard in zip(solver.mesh.shards, got.shards):
            region = tuple(slice(o, o + m) for o, m in zip(s.origin, solver.mesh.local_shape))
            _check(torch.equal(shard, want[region]),
                   f"1024^3 {route} on {mesh_shape} != (1,1,1) at shard {s.coords}")
        full_solves.append([list(mesh_shape), route])
        del got, solver
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()

    solves = []
    for mesh_shape, knobs, tb, no_direct, kind, storage, periodic in _FUSED_SOLVES:
        bcv = 0.0 if periodic else 0.3
        want = _solve_gathered(128, (1, 1, 1), kind, storage, periodic, bcv, 1, 21)
        with _env(HEAT3D_PLAN_PART_MIN_BYTES="0"):
            got = _solve_gathered(128, mesh_shape, kind, storage, periodic, bcv, tb, 21,
                                  no_direct=no_direct, device="cuda:0", **knobs)
        _check(got.tobytes() == want.tobytes(),
               f"overlap-route solve != (1,1,1) solve: {mesh_shape} {knobs} tb={tb} "
               f"{kind} {storage} periodic={periodic}: max err "
               f"{float(np.abs(got - want).max())}")
        solves.append([list(mesh_shape), knobs, tb, no_direct, kind, storage, periodic])
    _say("compare_fused", cases=cases, ghost_cases=ghosts, launches_in_a_row=bursts,
         mid_run_state=True, overlap_vs_single_solves=solves,
         full_width_vs_single_solves=full_solves, bitwise=True,
         max_abs_err={k: worst[k] for k in _FUSED}, launches=ops.launch_counts(),
         seconds=time.perf_counter() - t0)


def _bf16_counts() -> dict:
    """Launches in bf16 compute, per stencil kernel wrapper and of the
    Mehrstellen instances (keyed as ``_MEHR``)."""
    from heat3d_tpu_torch import ops
    from heat3d_tpu_torch.ops import stencil_direct as sd

    return {**ops.compute_bf16_launch_counts(),
            **{f"{name}:mehrstellen": n
               for name, n in sd.compute_bf16_mehrstellen_launch_counts().items()}}


def _hold_bf16(worst, name, run, want, what, counted=None) -> None:
    """``run()`` (one launch of ``name``'s wrapper in bf16 compute) bitwise
    against ``want`` (a tensor, or the shards' list), counted once as a
    bf16-compute launch of ``counted`` (default ``name``)."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    counted = counted or name
    before = _bf16_counts()[counted]
    got = run()
    if isinstance(got, list):
        _hold_fused(worst, name, got, want, what)
    else:
        _hold(worst, name, got, want, what)
    fd.raise_if_timed_out()
    _check(_bf16_counts()[counted] == before + 1,
           f"{counted} {what}: not one bf16-compute launch")


def phase_compare_bf16(worst: dict) -> None:
    """bf16 compute: every bf16-compute instance bitwise against its plain
    version on the card (the plain version's bf16 ops round as the
    kernel's policy does), each launch counted as one; the errors fold into
    ``worst`` beside the fp32-compute ones. The direct kernels at their
    ragged shapes and a forced 3-plane x-chunk; every stencil kernel
    (direct1, direct2, the stream kernel, streamk k = 2..4) at
    (33,17,129) and 128^3; the Mehrstellen instances under
    ``HEAT3D_MEHRSTELLEN=1`` at the ragged shapes and 128^3; 7pt/27pt x
    fp32/bf16 storage x Dirichlet bc 0 and 0.3/periodic; the generic
    instances forced (both factoring knobs, and the direct kernels' generic
    instance on the default chain) at 128^3, fused over (4,1,1) too; the
    fused one- and two-update kernels over (8,1,1), the RDMA ones over
    (4,1,1) with the plan's sub-blocks (floor 0 and the default), and
    (8,77,125) over (2,1,1) in one and three send ranges."""
    import numpy as np
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    t0 = time.perf_counter()
    bf = torch.bfloat16
    cases = {"direct_ragged": 0, "kernels": 0, "mehrstellen": 0, "generic": 0, "fused": 0}
    shapes = [(shape, None) for shape in _DIRECT_SHAPES[:5]] + [_DIRECT_FORCED_CHUNK]
    for shape, chunk in shapes:
        base = np.random.default_rng(18).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in _BCS:
                    for name, halo in _cases()[:2]:
                        what = f"bf16 compute at {shape} chunk {chunk} {dtype} {kind} " \
                               f"periodic={periodic} bc={bcv}"
                        _hold_bf16(worst, name, lambda: sd.launch_instance(
                            halo, sd.direct_instance(taps), u, taps, periodic, bcv,
                            xchunk=chunk, compute_dtype=bf),
                            _kernel_pair(name, halo, cd=bf)[1](u, taps, periodic, bcv), what)
                        cases["direct_ragged"] += 1
                with _env(HEAT3D_MEHRSTELLEN="1"):
                    for periodic, bcv in _BCS:
                        cases["mehrstellen"] += _hold_mehrstellen_bf16(
                            worst, u, periodic, bcv,
                            f"bf16 compute at {shape} chunk {chunk} {dtype} "
                            f"periodic={periodic} bc={bcv}", chunk)
    for shape in ((33, 17, 129), (128, 128, 128)):
        base = np.random.default_rng(19).standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.from_numpy(base).cuda().to(dtype)
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                for periodic, bcv in _BCS:
                    for name, k in _cases():
                        kern, plain = _kernel_pair(name, k, cd=bf)
                        x = _kernel_input(name, u, periodic, bcv, k)
                        _hold_bf16(worst, name, lambda: kern(x, taps, periodic, bcv),
                                   plain(x, taps, periodic, bcv),
                                   f"bf16 compute k={k} at {shape} {dtype} {kind} "
                                   f"periodic={periodic} bc={bcv}")
                        cases["kernels"] += 1
            if shape == (128, 128, 128):
                with _env(HEAT3D_MEHRSTELLEN="1"):
                    for periodic, bcv in _BCS:
                        cases["mehrstellen"] += _hold_mehrstellen_bf16(
                            worst, u, periodic, bcv,
                            f"bf16 compute at 128^3 {dtype} periodic={periodic} bc={bcv}")
            del u
        torch.cuda.empty_cache()

    # the generic instances: under both factoring knobs every chain is
    # generic; and the direct kernels' generic instance forced on the
    # default 7pt chain
    base = np.random.default_rng(20).standard_normal((128, 128, 128)).astype(np.float32)
    mesh4 = _card_mesh((4, 1, 1), (32, 128, 128))
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.from_numpy(base).cuda().to(dtype)
        us = _split(u, mesh4)
        with _env(HEAT3D_FACTOR_7PT="1", HEAT3D_FACTOR_Y="0"):
            for kind in ("7pt", "27pt"):
                taps = _taps(kind)
                _check(ss.stream_instance(taps) == ss.GENERIC, f"{kind} not generic")
                for periodic, bcv in _BCS:
                    for name, k in _cases():
                        kern, plain = _kernel_pair(name, k, cd=bf)
                        x = _kernel_input(name, u, periodic, bcv, k)
                        before = _generic_counts()[name]
                        _hold_bf16(worst, name, lambda: kern(x, taps, periodic, bcv),
                                   plain(x, taps, periodic, bcv),
                                   f"bf16 compute generic k={k} at 128^3 {dtype} {kind} "
                                   f"periodic={periodic} bc={bcv}")
                        _check(_generic_counts()[name] == before + 1,
                               f"{name} {kind}: not on the generic instance")
                        cases["generic"] += 1
                for (periodic, bcv), name in itertools.product(
                        ((False, 0.3), (True, 0.0)),
                        ("apply_step_fused_dma", "apply_superstep_fused_dma")):
                    kern, plain = _fused_pair(name, cd=bf)
                    state = fd.FusedState(mesh4, _FUSED[name][0], dtype, periodic)
                    before = _generic_counts()[name]
                    _hold_bf16(worst, name, lambda: kern(us, taps, mesh4, state, periodic, bcv),
                               plain(us, taps, mesh4, None, periodic, bcv),
                               f"bf16 compute generic 128^3 on (4,1,1) {dtype} {kind} "
                               f"periodic={periodic}")
                    _check(_generic_counts()[name] == before + 1,
                           f"{name} {kind}: not on the generic instance")
                    cases["generic"] += 1
        taps = _taps("7pt")
        for name, halo in _cases()[:2]:
            _hold_bf16(worst, name, lambda: sd.launch_instance(
                halo, ss.GENERIC, u, taps, False, 0.3, compute_dtype=bf),
                _kernel_pair(name, halo, cd=bf)[1](u, taps, False, 0.3),
                f"bf16 compute generic instance forced on the 7pt chain, 128^3 {dtype}")
            cases["generic"] += 1
        del u, us
    torch.cuda.empty_cache()

    # the fused kernels
    base = torch.from_numpy(
        np.random.default_rng(21).standard_normal((128, 128, 128)).astype(np.float32)).cuda()
    for mesh_shape in ((8, 1, 1), (4, 1, 1)):
        mesh = _card_mesh(mesh_shape, tuple(128 // p for p in mesh_shape))
        names = [n for n in _FUSED if n.endswith("dma") == (mesh_shape == (8, 1, 1))]
        for kind, dtype, (periodic, bcv) in itertools.product(
                ("7pt", "27pt"), (torch.float32, torch.bfloat16),
                ((False, 0.3), (True, 0.0))):
            taps = _taps(kind)
            us = _split(base.to(dtype), mesh)
            for name in names:
                kern, plain = _fused_pair(name, cd=bf)
                for floor in ((0, None) if name.endswith("rdma") else (None,)):
                    state = _fused_state(mesh, name, dtype, periodic, floor)
                    _hold_bf16(worst, name, lambda: kern(us, taps, mesh, state, periodic, bcv),
                               plain(us, taps, mesh, None, periodic, bcv),
                               f"bf16 compute 128^3 on {mesh_shape} {kind} {dtype} "
                               f"periodic={periodic} ranges {state.bounds}")
                    cases["fused"] += 1
            del us
    del base
    mesh = _card_mesh((2, 1, 1), (4, 77, 125))
    base = torch.from_numpy(
        np.random.default_rng(22).standard_normal((8, 77, 125)).astype(np.float32)).cuda()
    for kind, dtype, (periodic, bcv) in itertools.product(
            ("7pt", "27pt"), (torch.float32, torch.bfloat16), ((False, 0.3), (True, 0.0))):
        taps = _taps(kind)
        us = _split(base.to(dtype), mesh)
        for name, parts in itertools.product(_FUSED, (1, 3)):
            kern, plain = _fused_pair(name, cd=bf)
            state = fd.FusedState(mesh, _FUSED[name][0], dtype, periodic,
                                  partition_bounds(77, parts))
            _hold_bf16(worst, name, lambda: kern(us, taps, mesh, state, periodic, bcv),
                       plain(us, taps, mesh, None, periodic, bcv),
                       f"bf16 compute (8,77,125) on (2,1,1) {kind} {dtype} "
                       f"periodic={periodic} ranges {state.bounds}")
            cases["fused"] += 1
    del base, us
    torch.cuda.empty_cache()
    _say("compare_bf16", cases=cases, bitwise=True, max_abs_err=worst,
         compute_bf16_launches=_bf16_counts(), seconds=time.perf_counter() - t0)


def _hold_mehrstellen_bf16(worst: dict, u, periodic, bcv, what, chunk=None) -> int:
    """Both Mehrstellen instances in bf16 compute on ``u`` (27pt, the knob
    on), bitwise against their plain versions, each counted as a
    bf16-compute Mehrstellen launch."""
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd

    bf = torch.bfloat16
    taps = _taps("27pt")
    for name, (wrapper, halo) in _MEHR.items():
        _hold_bf16(worst, name, lambda: sd.launch_instance(
            halo, sd.MEHRSTELLEN, u, taps, periodic, bcv, xchunk=chunk, compute_dtype=bf),
            _kernel_pair(wrapper, halo, cd=bf)[1](u, taps, periodic, bcv), what, counted=name)
    return len(_MEHR)


# interior x-chunks a shard that fused_times sweeps the compile-time
# instances over (ms_by_xchunks)
_FUSED_CHUNK_SWEEP = (1, 2, 3, 4, 6, 8, 12)


def phase_fused_times(bw: float, worst: dict, resources: dict) -> dict:
    """Each fused kernel's ms per launch at 1024^3 fp32 7pt Dirichlet bc 0,
    one launch over all shards of the card (the DMA kernels on (8,1,1), the
    RDMA kernels on (4,1,1) with the partitioned plan's default sub-blocks:
    the full-width rows' meshes), its plain version's ms, and its bound:
    the field read once and written once plus each x-face slab sent read
    and written once; with the instance's registers, spills and resident
    blocks per SM. Each kernel runs on its compile-time 7pt instance (also
    at 1 to 12 interior x-chunks a shard, ``ms_by_xchunks``) and, timed in
    the same call, on the generic instance forced (the first design); the
    DMA kernels also over (2,1,1) (``ms_on_2x1x1``: two 512-plane shards,
    little skin and push). Each timed launch is held bitwise to its plain
    version. The one-update kernels' result over all shards is one update
    of the 1024^3 field: their library call is one cuDNN convolution (TF32
    off, never called by the port) over the shards joined and padded with
    bc, held to the kernel within the rounding bound; the shard split and
    the padding are data layout, left out of the time as for row 1. No
    single PyTorch call computes two updates, so the two-update kernels
    have no library time."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    n = 1024
    taps = _taps("7pt", n)
    flops = flops_per_update(taps)
    times = {}
    for name, mesh_shape in (("apply_step_fused_dma", (8, 1, 1)),
                             ("apply_superstep_fused_dma", (8, 1, 1)),
                             ("apply_step_fused_rdma", (4, 1, 1)),
                             ("apply_superstep_fused_rdma", (4, 1, 1))):
        k = _FUSED[name][0]
        mesh = _card_mesh(mesh_shape, tuple(n // p for p in mesh_shape))
        us = [torch.rand(mesh.local_shape, device=s.device) for s in mesh.shards]
        outs = [torch.empty_like(u) for u in us]
        kern, plain = _fused_pair(name)
        state = _fused_state(mesh, name, torch.float32, False)
        want = plain(us, taps, mesh, None, False, 0.0)
        inst = fd.fused_instance(k, taps)

        def go(instance=None, dst=outs, xchunk=None):
            mesh.fork()
            if instance is None:
                kern(us, taps, mesh, state, False, 0.0, outs=dst)
            else:
                fd.launch_instance(instance, us, taps, mesh, state, False, 0.0, outs=dst,
                                   wrapper=_fused_wrapper(name), xchunk=xchunk)
            mesh.join()

        ms = _time_ms(go, iters=10)
        _hold_fused(worst, name, outs, want, f"at {n}^3 on {mesh_shape}")
        plain_ms = _time_ms(lambda: plain(us, taps, mesh, None, False, 0.0), iters=3)
        b_ms, by, moved = fused_bound(n, mesh_shape, k, 4, flops, bw)
        res = resources[f"fused_h{k}_{_instance_name(inst)}_float32"]
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                       "library_ms": None, "bytes": moved, "mesh": list(mesh_shape),
                       "send_ranges": [list(b) for b in state.bounds],
                       "instance": _instance_name(inst),
                       "kernel": (f"fused_chain_kernel<float,{k},{_instance_name(inst)}>"
                                  if inst else f"fused_kernel<float,{k}>"),
                       "xchunk": fd._launch_xchunk(k, inst, tuple(mesh.local_shape),
                                                   len(mesh), 0, torch.float32),
                       **{f: res[f] for f in ("blocks_per_sm", "registers", "spill_stores",
                                              "spill_loads")}}
        # the interior cut into c x-chunks a shard (each re-reads 2k planes)
        inner = mesh.local_shape[0] - 2 * k
        sweep = {}
        for c in _FUSED_CHUNK_SWEEP:
            swept = [torch.empty_like(u) for u in us]
            sweep[c] = _time_ms(lambda: go(inst, swept, -(-inner // c)), iters=5)
            _hold_fused(worst, name, swept, want,
                        f"{c} x-chunks at {n}^3 on {mesh_shape}")
        times[name]["ms_by_xchunks"] = sweep
        del swept
        outs_generic = [torch.empty_like(u) for u in us]
        generic_ms = _time_ms(lambda: go(0, outs_generic), iters=10)
        _hold_fused(worst, name, outs_generic, want,
                    f"generic instance at {n}^3 on {mesh_shape}")
        gres = resources[f"fused_h{k}_generic_float32"]
        times[name]["generic"] = {
            "ms": generic_ms, "xchunk": fd._launch_xchunk(k, 0, tuple(mesh.local_shape),
                                                          len(mesh), 0, torch.float32),
            **{f: gres[f] for f in ("blocks_per_sm", "registers", "spill_stores",
                                    "spill_loads")}}
        _check(ms < generic_ms, f"{name}: compile-time instance {ms} ms, generic "
                                f"{generic_ms} ms at {n}^3 on {mesh_shape}")
        del outs_generic
        if k == 1:
            torch.backends.cudnn.allow_tf32 = False
            w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).cuda()[None, None]
            up = F.pad(torch.cat(us), (1, 1, 1, 1, 1, 1), value=0.0)[None, None]
            times[name]["library_ms"] = _time_ms(lambda: F.conv3d(up, w), iters=3)
            times[name].update(_library_check(name, torch.cat(outs),
                                              F.conv3d(up, w)[0, 0], taps, up))
            del up
        del us, outs, state, want
        torch.cuda.empty_cache()
    # the DMA kernels over (2,1,1), two 512-plane shards, where the skin
    # planes and the pushes are a small part of the launch: the sweep beside
    # the direct kernels' (kernel_times)
    mesh = _card_mesh((2, 1, 1), (n // 2, n, n))
    us = [torch.rand(mesh.local_shape, device=s.device) for s in mesh.shards]
    outs = [torch.empty_like(u) for u in us]
    for name in ("apply_step_fused_dma", "apply_superstep_fused_dma"):
        kern, plain = _fused_pair(name)
        state = _fused_state(mesh, name, torch.float32, False)

        def go2():
            mesh.fork()
            kern(us, taps, mesh, state, False, 0.0, outs=outs)
            mesh.join()

        times[name]["ms_on_2x1x1"] = _time_ms(go2, iters=10)
        _hold_fused(worst, name, outs, plain(us, taps, mesh, None, False, 0.0),
                    f"at {n}^3 on (2, 1, 1)")
        del state
    del us, outs
    torch.cuda.empty_cache()
    _say("fused_times", grid=[n, n, n], stencil="7pt", dtype="float32", bc_value=0.0,
         times=times, bitwise=True, max_abs_err={k: worst[k] for k in _FUSED})
    return times


def phase_cross_gpu(worst: dict) -> None:
    """The (2,1,1) DMA check with shard 0 on cuda:0 and shard 1 on cuda:1:
    peer stores across GPUs. Runs only with two GPUs visible."""
    import numpy as np
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        _say("cross_gpu", ran=False,
             reason=f"{count} CUDA device visible; the phase needs 2 (the peer "
                    "writes of the DMA and fused kernels between GPUs stay "
                    "unchecked by this run)")
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
    # the fused kernels: one launch per GPU, the pushes peer stores
    fused = 0
    for dtype in (torch.float32, torch.bfloat16):
        us = _split(base.to(dtype), mesh)
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            for name in _FUSED:
                kern, plain = _fused_pair(name)
                for floor in ((0, None) if name.endswith("rdma") else (None,)):
                    state = _fused_state(mesh, name, dtype, periodic, floor)
                    for _ in range(5):
                        got = kern(us, _taps("27pt"), mesh, state, periodic, bcv)
                        for d in devices:
                            torch.cuda.synchronize(d)
                        _hold_fused(worst, name, [g.cpu() for g in got],
                                    [w.cpu() for w in plain(us, _taps("27pt"), mesh, None,
                                                            periodic, bcv)],
                                    f"across GPUs {dtype} periodic={periodic}")
                        fused += 1
    _say("cross_gpu", ran=True, devices=[str(d) for d in devices], dma_cases=cases,
         dma_exchanges_in_a_row=bursts, fused_cases=fused, bitwise=True)


def _mehrstellen_counts(cells: bool = False) -> dict:
    """Launches (or output cells) of the Mehrstellen instances, keyed as
    ``_MEHR``."""
    from heat3d_tpu_torch.ops import stencil_direct as sd

    counts = sd.mehrstellen_cell_counts() if cells else sd.mehrstellen_launch_counts()
    return {f"{name}:mehrstellen": n for name, n in counts.items()}


def _hold_mehrstellen(worst: dict, u, periodic, bcv, what, chunk=None) -> int:
    """Both direct wrappers on ``u`` under ``HEAT3D_MEHRSTELLEN`` (27pt):
    each launch on the Mehrstellen instance (counted as such; ``chunk``
    forces the x-chunk) and bitwise equal to its plain version."""
    from heat3d_tpu_torch.ops import stencil_direct as sd

    taps = _taps("27pt")
    for name, (wrapper, halo) in _MEHR.items():
        kern, plain = _kernel_pair(wrapper, halo)
        before = _mehrstellen_counts()[name]
        if chunk is None:
            got = kern(u, taps, periodic, bcv)
        else:
            got = sd.launch_instance(halo, sd.MEHRSTELLEN, u, taps, periodic, bcv,
                                     xchunk=chunk)
        _hold(worst, name, got, plain(u, taps, periodic, bcv), what)
        _check(_mehrstellen_counts()[name] == before + 1,
               f"{name} {what}: not launched on the Mehrstellen instance")
    return len(_MEHR)


# (time_blocking, route, mesh, knobs) of the 27pt routes
# that keep the tap chain under HEAT3D_MEHRSTELLEN, as the JAX kernels do
_MEHR_CHAIN_ROUTES = ((4, "streamk", (1, 1, 1), {}),
                      (2, "fused-dma2", (8, 1, 1), {"halo": "dma", "overlap": True}))


def phase_compare_mehrstellen(worst: dict) -> None:
    """Under ``HEAT3D_MEHRSTELLEN=1``: both Mehrstellen instances bitwise
    against their plain versions at the direct kernels' ragged shapes, a
    forced 3-plane x-chunk, 128^3 and 1024^3 (fp32/bf16 x Dirichlet bc 0
    and 0.3/periodic); the (2,2,2) faces-direct solve against the (1,1,1)
    solve at 128^3 (tb 1 and 2, fp32/bf16, Dirichlet 0.3/periodic), every
    shard on cuda:0; and the routes that keep the chain (27pt tb=4 streamk,
    fused-dma2 over (8,1,1)) equal to their knob-off solves, no Mehrstellen
    launch among them."""
    import torch

    t0 = time.perf_counter()
    cases = 0
    shapes = ([(shape, None) for shape in _DIRECT_SHAPES] + [_DIRECT_FORCED_CHUNK]
              + [((128,) * 3, None), ((1024,) * 3, None)])
    gen = torch.Generator(device="cuda").manual_seed(10)
    with _env(HEAT3D_MEHRSTELLEN="1"):
        for shape, chunk in shapes:
            base = torch.randn(shape, generator=gen, device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                u = base.to(dtype)
                for periodic, bcv in _BCS:
                    cases += _hold_mehrstellen(
                        worst, u, periodic, bcv,
                        f"at {shape} chunk {chunk} {dtype} periodic={periodic} bc={bcv}", chunk)
                del u
            del base
            torch.cuda.empty_cache()
        solves = []
        for tb in (1, 2):
            for storage in ("float32", "bfloat16"):
                for periodic in (False, True):
                    bcv = 0.0 if periodic else 0.3
                    before = sum(_mehrstellen_counts().values())
                    want = _solve_gathered(128, (1, 1, 1), "27pt", storage, periodic, bcv, tb, 20)
                    got = _solve_gathered(128, _MESH, "27pt", storage, periodic, bcv, tb, 20,
                                          device="cuda:0")
                    _check(sum(_mehrstellen_counts().values()) > before,
                           f"no Mehrstellen launch in the tb={tb} solves")
                    _check(got.tobytes() == want.tobytes(),
                           f"faces-direct solve != (1,1,1) solve under the knob: tb={tb} "
                           f"{storage} periodic={periodic}")
                    solves.append([tb, storage, periodic])
    chain = []
    for tb, route, mesh, knobs in _MEHR_CHAIN_ROUTES:
        device = None if mesh == (1, 1, 1) else "cuda:0"
        want = _solve_gathered(128, mesh, "27pt", "float32", False, 0.3, tb, 20, device=device,
                               **knobs)
        with _env(HEAT3D_MEHRSTELLEN="1"):
            before = _mehrstellen_counts()
            got = _solve_gathered(128, mesh, "27pt", "float32", False, 0.3, tb, 20,
                                  device=device, **knobs)
            _check(_mehrstellen_counts() == before, f"{route} launched a Mehrstellen instance")
        _check(got.tobytes() == want.tobytes(), f"{route} under the knob != knob off")
        chain.append(route)
    _say("compare_mehrstellen", cases=cases, bitwise=True,
         max_abs_err={name: worst[name] for name in _MEHR},
         sharded_vs_single_solves=solves, chain_routes_equal_knob_off=chain,
         mehrstellen_launches=_mehrstellen_counts(), seconds=time.perf_counter() - t0)


def _golden_mehrstellen() -> None:
    """The command line at 128^3 under ``HEAT3D_MEHRSTELLEN=1``, 27pt tb 1
    and 2, fp32 and bf16 storage, ``--golden-check``: each run launches the
    Mehrstellen instance."""
    for tb, want in ((1, "apply_taps_direct"), (2, "apply_taps_direct2")):
        for dtype in ("fp32", "bf16"):
            with _env(HEAT3D_MEHRSTELLEN="1"):
                before = _mehrstellen_counts()[f"{want}:mehrstellen"]
                _golden_cli(["--grid", "128", "--steps", "20", "--stencil", "27pt",
                             "--time-blocking", str(tb), "--dtype", dtype], want,
                            stencil="27pt", time_blocking=tb, dtype=dtype, mehrstellen=True)
                _check(_mehrstellen_counts()[f"{want}:mehrstellen"] > before,
                       f"golden tb={tb} {dtype}: no Mehrstellen launch")


# (time_blocking, storage, mesh, knobs, Mehrstellen route) of the full-width
# rows under HEAT3D_MEHRSTELLEN=1, 27pt: the direct routes on the
# Mehrstellen instance, the exchange path and the fused route on the chain
_MEHR_FULL_WIDTH = (
    (2, "float32", (1, 1, 1), {}, True), (1, "float32", (1, 1, 1), {}, True),
    (2, "bfloat16", (1, 1, 1), {}, True), (1, "float32", _MESH, {}, True),
    (2, "float32", _MESH, {}, True), (4, "float32", (1, 1, 1), {}, False),
    (2, "float32", (8, 1, 1), {"halo": "dma", "overlap": True}, False),
)


def _full_width_mehrstellen(bw: float) -> None:
    """The full-width rows under the knob (``_MEHR_FULL_WIDTH``), each
    beside its bound; then the (2,2,2) faces-direct solve at 1024^3 held
    bitwise to the (1,1,1) solve (tb 1 and 2, 4 steps, hot cube)."""
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.ops import stencil_direct as sd

    n = 1024
    with _env(HEAT3D_MEHRSTELLEN="1"):
        for tb, storage, mesh, knobs, q_ring in _MEHR_FULL_WIDTH:
            cfg = SolverConfig(grid=GridConfig.cube(n), stencil=StencilConfig(kind="27pt"),
                               precision=Precision(storage=storage),
                               mesh=MeshConfig(shape=mesh), time_blocking=tb, **knobs)
            before = sum(_mehrstellen_counts().values())
            row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                                   device=None if mesh == (1, 1, 1) else "cuda:0")
            took = sum(_mehrstellen_counts().values()) - before
            route = row["superstep_route"] if tb > 1 else row["step_route"]
            _check(row["mehrstellen_route"] is q_ring and (took > 0) is q_ring,
                   f"{route} under the knob: mehrstellen_route {row['mehrstellen_route']}, "
                   f"{took} Mehrstellen launches")
            itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
            flops = sd.MEHRSTELLEN_KERNEL_OPS if q_ring else flops_per_update(_taps("27pt"))
            if mesh == (1, 1, 1):
                b_ms, by = superstep_bound(route, n, tb, itemsize, flops, bw)
            else:
                b_ms, by, _ = sharded_superstep_bound(route, n, mesh, tb, itemsize, flops, bw)
            _say("full_width", grid=row["grid"], stencil="27pt", dtype=storage, mehrstellen=True,
                 mesh=row["mesh"], halo=row["halo"], overlap=row["overlap"], time_blocking=tb,
                 route=route, mehrstellen_route=row["mehrstellen_route"],
                 chain_ops=row["chain_ops"], mehrstellen_launches=took, steps=row["steps"],
                 gcell_updates_per_sec=row["gcell_updates_per_sec"],
                 ms_per_superstep=row["ms_per_launch"], bound_ms_per_superstep=b_ms,
                 bound_by=by, bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
                 kernel_launches=row["kernel_launches"], seconds_all=row["seconds_all"])
            del row
            torch.cuda.empty_cache()
        for tb in (1, 2):
            fields = {}
            for mesh in ((1, 1, 1), _MESH):
                cfg = SolverConfig(grid=GridConfig.cube(n), stencil=StencilConfig(kind="27pt"),
                                   mesh=MeshConfig(shape=mesh), time_blocking=tb)
                solver = HeatSolver3D(cfg, device="cuda:0")
                fields[mesh] = solver.run(solver.init_state("hot-cube"), 4)
                del solver
            whole = _shard_list(fields[(1, 1, 1)])[0]
            m = n // _MESH[0]
            equal = all(
                torch.equal(fields[_MESH][c], whole[c[0] * m:(c[0] + 1) * m,
                                                    c[1] * m:(c[1] + 1) * m,
                                                    c[2] * m:(c[2] + 1) * m])
                for c in itertools.product(range(2), repeat=3))
            _check(equal, f"faces-direct tb={tb} at {n}^3 != (1,1,1) under the knob")
            _say("full_width_sharded_bitwise", grid=[n] * 3, mesh=list(_MESH), stencil="27pt",
                 time_blocking=tb, steps=4, mehrstellen=True, bitwise=True)
            del fields, whole
            torch.cuda.empty_cache()


def phase_mehrstellen_times(bw: float, worst: dict, resources: dict) -> dict:
    """The Mehrstellen instances at 1024^3 (27pt, Dirichlet bc 0), fp32 and
    bf16, beside the 27pt chain instances of the same call (the knob off):
    ms per launch, bound (bytes, or the instance's own fp32 operations),
    registers, spills and blocks per SM, each launch held bitwise to its
    plain version; fp32 also the plain version's time and, at tb=1, the
    library call (one cuDNN 27pt convolution, TF32 off, never called by the
    port) held to the kernel within a rounding bound. Returns the fp32
    numbers of each instance, keyed as ``_MEHR``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops.stencil_eager import pad_local

    n = 1024
    taps = _taps("27pt", n)
    variants, res = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.rand((n, n, n), device="cuda").to(dtype)
        out = torch.empty_like(u)
        tag = str(dtype)[6:]
        for name, (wrapper, halo) in _MEHR.items():
            kern, plain = _kernel_pair(wrapper, halo)
            with _env(HEAT3D_MEHRSTELLEN="0"):
                chain_ms = _time_ms(lambda: kern(u, taps, False, 0.0, out=out), iters=10)
                _hold(worst, wrapper, out, plain(u, taps, False, 0.0),
                      f"27pt chain at {n}^3 {dtype}")
            with _env(HEAT3D_MEHRSTELLEN="1"):
                ms = _time_ms(lambda: kern(u, taps, False, 0.0, out=out), iters=10)
                _hold(worst, name, out, plain(u, taps, False, 0.0), f"at {n}^3 {dtype}")
                plain_ms = (_time_ms(lambda: plain(u, taps, False, 0.0), iters=3)
                            if dtype == torch.float32 else None)
            b_ms, by = kernel_bound(wrapper, n, halo, u.element_size(),
                                    sd.MEHRSTELLEN_KERNEL_OPS, bw)
            cb_ms, cby = kernel_bound(wrapper, n, halo, u.element_size(),
                                      flops_per_update(taps), bw)
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                   "library_ms": None,
                   "kernel": f"direct_kernel<{'float' if tag == 'float32' else '__nv_bfloat16'},"
                             f"{halo},SPEC_MEHR>",
                   **resources[f"h{halo}_mehrstellen_{tag}"],
                   "chain_27pt": {"ms": chain_ms, "bound_ms": cb_ms, "bound_by": cby,
                                  **resources[f"h{halo}_27pt_{tag}"]},
                   "mehrstellen_over_chain": ms / chain_ms}
            if halo == 1 and dtype == torch.float32:
                with _env(HEAT3D_MEHRSTELLEN="1"):
                    got = kern(u, taps, False, 0.0)
                up = pad_local(u, _bc(False), 0.0)
                w = torch.from_numpy(np.asarray(taps, dtype=np.float32)).cuda()[None, None]
                torch.backends.cudnn.allow_tf32 = False

                def library():
                    return F.conv3d(up[None, None], w)

                row["library_ms"] = _time_ms(library, iters=3)
                row.update(_library_check(name, got, library()[0, 0], taps, u))
                del up, got
            variants[f"{name}_{tag}"] = row
            if dtype == torch.float32:
                res[name] = row
        del u, out
        torch.cuda.empty_cache()
    _say("mehrstellen_times", grid=[n] * 3, stencil="27pt", variants=variants,
         max_abs_err={name: worst[name] for name in _MEHR})
    return res


# Steps of the golden runs in bf16 compute. The bf16 stencil rounds the
# weights and every operation to bf16, which drifts the 7pt hot cube by
# about 0.25% a step against the fp64 oracle: at 20 steps (the fp32
# goldens' count) 7pt reaches 0.0501 relative error, above the 5e-2 gate,
# in the port and in the JAX package alike once XLA rounds every operation
# (``--xla_allow_excess_precision=false``; its default-flag CPU run, 0.0492,
# keeps float32 between operations). ``_bf16_drift`` shows that 20-step
# run; the gated runs take 10 steps.
_BF16_GOLDEN_STEPS = 10
# (stencil, extra flags, time_blocking, storage, env, kernel it must launch)
# of the golden runs in bf16 compute (--compute-dtype bf16), 128^3: the
# direct kernels and streamk (fp32 and bf16 storage), the stream kernel on
# the exchange path, the Mehrstellen instances, and the four fused kernels
# on cuda:0
_GOLDEN_BF16 = tuple(
    ("7pt", [], tb, storage, {}, want)
    for tb, want in ((1, "apply_taps_direct"), (2, "apply_taps_direct2"),
                     (4, "apply_taps_streamk"))
    for storage in ("fp32", "bf16")) + (
    ("7pt", [], 1, "fp32", {"HEAT3D_NO_DIRECT": "1"}, "apply_taps_stream"),
    ("27pt", [], 1, "fp32", {"HEAT3D_MEHRSTELLEN": "1"}, "apply_taps_direct:mehrstellen"),
    ("27pt", [], 2, "fp32", {"HEAT3D_MEHRSTELLEN": "1"}, "apply_taps_direct2:mehrstellen"),
    ("7pt", ["--mesh", "8", "1", "1", "--halo", "dma", "--overlap", "--device", "cuda:0"],
     1, "fp32", {}, "apply_step_fused_dma"),
    ("7pt", ["--mesh", "8", "1", "1", "--halo", "dma", "--overlap", "--device", "cuda:0"],
     2, "fp32", {}, "apply_superstep_fused_dma"),
    ("27pt", ["--mesh", "4", "1", "1", "--fused-rdma", "on", "--halo-plan", "partitioned",
              "--device", "cuda:0"], 1, "bf16", {"HEAT3D_PLAN_PART_MIN_BYTES": "0"},
     "apply_step_fused_rdma"),
    ("27pt", ["--mesh", "4", "1", "1", "--fused-rdma", "on", "--halo-plan", "partitioned",
              "--device", "cuda:0"], 2, "bf16", {"HEAT3D_PLAN_PART_MIN_BYTES": "0"},
     "apply_superstep_fused_rdma"),
)


def _golden_bf16() -> None:
    """The command line at 128^3 with ``--compute-dtype bf16`` and
    ``--golden-check`` (the 5e-2 gate of a chain with bf16 in it): each
    run launches its kernel's bf16-compute instance (``_GOLDEN_BF16``);
    then ``_bf16_drift``."""
    for kind, flags, tb, storage, env, want in _GOLDEN_BF16:
        before = _bf16_counts()[want]
        with _env(**env):
            _golden_cli(["--grid", "128", "--steps", str(_BF16_GOLDEN_STEPS), "--stencil", kind,
                         "--time-blocking", str(tb), "--dtype", storage,
                         "--compute-dtype", "bf16", *flags], want.split(":")[0],
                        stencil=kind, time_blocking=tb, dtype=storage, compute_dtype="bf16",
                        flags=flags, env=env)
        _check(_bf16_counts()[want] > before,
               f"golden bf16 compute {kind} tb={tb} {storage} {flags} {env}: no "
               f"bf16-compute launch of {want}")
    _bf16_drift()


def _bf16_drift() -> None:
    """The 7pt hot cube at 128^3 in bf16 compute (fp32 storage, tb=1), 10
    and 20 steps, against the fp64 oracle: the relative error printed
    beside the 5e-2 gate (not gated: at 20 steps it is the bf16 stencil's
    own drift, see ``_BF16_GOLDEN_STEPS``); gated: the solver's field
    equals, bitwise, the plain per-op bf16 update applied as many times on
    the card (the arithmetic the JAX package computes when XLA rounds every
    operation)."""
    import numpy as np
    import torch

    from heat3d_tpu_torch import eqn
    from heat3d_tpu_torch.core import golden
    from heat3d_tpu_torch.core.config import GridConfig, Precision, SolverConfig
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D
    from heat3d_tpu_torch.ops import stencil_direct as sd

    cfg = SolverConfig(grid=GridConfig.cube(128),
                       precision=Precision(storage="float32", compute="bfloat16"))
    taps = eqn.solver_taps(cfg)
    solver = HeatSolver3D(cfg)
    u = solver.init_state("hot-cube")
    plain = u.clone()
    u0 = golden.make_init("hot-cube", cfg.grid.shape, seed=cfg.run.seed)
    rel, done = {}, 0
    for steps in (10, 20):
        u = solver.run(u, steps - done)
        for _ in range(steps - done):
            plain = sd.apply_taps_direct_ref(plain, taps, False, 0.0, torch.bfloat16)
        done = steps
        torch.cuda.synchronize()
        _check(torch.equal(u, plain), f"bf16 compute solve != plain per-op update at {steps}")
        g = golden.run(u0, cfg.grid, cfg.stencil, steps, taps=taps)
        got = solver.gather(u).astype(np.float64)
        rel[steps] = float(np.max(np.abs(got - g)) / np.max(np.abs(g)))
    _say("bf16_drift", grid=[128] * 3, stencil="7pt", dtype="float32", compute_dtype="bfloat16",
         time_blocking=1, golden_rel_err_by_steps=rel, gate=5e-2,
         golden_pass_by_steps={k: v < 5e-2 for k, v in rel.items()},
         solve_equals_plain_per_op_update=True)


# BASELINE.json config 5 ("bf16 stencil + fp32 residual norm, 4096^3
# strong-scale on v5p-128") cut to one card: 1024^3, every shard on cuda:0
_CONFIG5_CUT = ("BASELINE.json config 5 is 4096^3 over 128 chips; here 1024^3 on one "
                "H100, every shard of a mesh on cuda:0")
# (stencil, storage, time_blocking, mesh, knobs, env) of the full-width rows
# in bf16 compute
_FULL_WIDTH_BF16 = (
    ("7pt", "float32", 2, (1, 1, 1), {}, {}),
    ("7pt", "float32", 4, (1, 1, 1), {}, {}),
    ("7pt", "bfloat16", 2, (1, 1, 1), {}, {}),
    ("27pt", "float32", 2, (1, 1, 1), {}, {"HEAT3D_MEHRSTELLEN": "1"}),
    ("7pt", "float32", 2, (8, 1, 1), {"halo": "dma", "overlap": True}, {}),
    ("7pt", "float32", 1, (4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, {}),
)


def _full_width_bf16(bw: float) -> None:
    """The full-width rows of BASELINE config 5's precision (bf16 stencil,
    fp32 residual) cut to one card (``_CONFIG5_CUT``), each beside its
    bound: the compute dtype moves no bytes, so the bound is the storage
    dtype's (its operations counted at the fp32 rate, below the bytes
    either way). Each row must launch bf16-compute instances."""
    import torch

    from heat3d_tpu_torch.bench.harness import bench_throughput
    from heat3d_tpu_torch.core.config import (
        GridConfig, MeshConfig, Precision, SolverConfig, StencilConfig,
    )
    from heat3d_tpu_torch.ops import stencil_direct as sd

    n = 1024
    for kind, storage, tb, mesh, knobs, env in _FULL_WIDTH_BF16:
        with _env(**env):
            cfg = SolverConfig(grid=GridConfig.cube(n), stencil=StencilConfig(kind=kind),
                               precision=Precision(storage=storage, compute="bfloat16"),
                               mesh=MeshConfig(shape=mesh), time_blocking=tb, **knobs)
            before = sum(_bf16_counts().values())
            row = bench_throughput(cfg, steps=tb * -(-20 // tb), warmup=1, repeats=3,
                                   device=None if mesh == (1, 1, 1) else "cuda:0")
            took = sum(_bf16_counts().values()) - before
        route = row["superstep_route"] if tb > 1 else row["step_route"]
        _check(took > 0 and row["compute_dtype"] == "bfloat16",
               f"{route} bf16 compute: {took} bf16-compute launches, row {row}")
        itemsize = torch.empty((), dtype=getattr(torch, storage)).element_size()
        flops = (sd.MEHRSTELLEN_KERNEL_OPS if row.get("mehrstellen_route")
                 else flops_per_update(_taps(kind)))
        if mesh == (1, 1, 1):
            b_ms, by = superstep_bound(route, n, tb, itemsize, flops, bw)
        else:
            b_ms, by, _ = sharded_superstep_bound(route, n, mesh, tb, itemsize, flops, bw)
        _say("full_width", grid=row["grid"], stencil=kind, dtype=storage,
             compute_dtype=row["compute_dtype"], cut=_CONFIG5_CUT, mesh=row["mesh"],
             halo=row["halo"], overlap=row["overlap"], fused_rdma=row["fused_rdma"],
             halo_plan=row["halo_plan"], env=env, time_blocking=tb, route=route,
             mehrstellen_route=row.get("mehrstellen_route"), steps=row["steps"],
             gcell_updates_per_sec=row["gcell_updates_per_sec"],
             ms_per_superstep=row["ms_per_launch"], bound_ms_per_superstep=b_ms,
             bound_by=by, bound_gcell_updates_per_sec=n**3 * tb / (b_ms / 1e3) / 1e9,
             compute_bf16_launches=took, kernel_launches=row["kernel_launches"],
             seconds_all=row["seconds_all"])
        del row
        torch.cuda.empty_cache()


def phase_compute_bf16_times(bw: float, worst: dict, resources: dict) -> dict:
    """Each bf16-compute instance at 1024^3 (Dirichlet bc 0) beside the
    fp32-compute instance of the same chain in the same call, timed in the
    order fp32, bf16, bf16, fp32 (the least of each arm's 20 launches):
    direct1, direct2, the stream kernel and streamk k = 2..4 (7pt, fp32
    storage), direct1/direct2 in bf16 storage, the Mehrstellen instances
    (27pt, fp32 storage), the fused DMA kernels over (8,1,1) and the RDMA
    ones over (4,1,1) (7pt, fp32 storage; the partitioned plan's default
    sub-blocks). Each bf16 launch is held bitwise to its plain version.
    The bound is the fp32 arm's: compute moves no bytes. Returns, per
    kernels-line name, ``{"compute_fp32": ..., "compute_bf16": ...}`` with
    ms, bound, blocks per SM, registers and spills."""
    import torch

    from heat3d_tpu_torch.ops import stencil_direct as sd
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_stream as ss

    n = 1024
    f32, bf = torch.float32, torch.bfloat16
    fields = ("blocks_per_sm", "registers", "spill_stores", "spill_loads")
    res = {}

    def ab(run32, runbf):
        a, b = _time_ms(run32, iters=10), _time_ms(runbf, iters=10)
        b = min(b, _time_ms(runbf, iters=10))
        return min(a, _time_ms(run32, iters=10)), b

    def pair(ms32, msbf, b_ms, by, key):
        return {"compute_fp32": {"ms": ms32, "bound_ms": b_ms, "bound_by": by,
                                 **{f: resources[key].get(f) for f in fields}},
                "compute_bf16": {"ms": msbf, "bound_ms": b_ms, "bound_by": by,
                                 **{f: resources[key + BF16C].get(f) for f in fields}},
                "bf16_over_fp32": msbf / ms32, "instance_key": key}

    cases = ([(name if name != "apply_taps_streamk" else f"{name}_k{k}", name, k, "7pt", f32, {})
              for name, k in _cases()]
             + [(f"{name}_bfloat16", name, k, "7pt", bf, {}) for name, k in _cases()[:2]]
             + [(m, w, h, "27pt", f32, {"HEAT3D_MEHRSTELLEN": "1"}) for m, (w, h) in _MEHR.items()])
    base = torch.rand((n, n, n), device="cuda")
    for key, name, k, kind, dtype, env in cases:
        taps = _taps(kind, n)
        u = base.to(dtype)
        with _env(**env):
            k32 = _kernel_pair(name, k)[0]
            kbf, pbf = _kernel_pair(name, k, cd=bf)
            x = _kernel_input(name, u, False, 0.0, k)
            o32, obf = torch.empty_like(u), torch.empty_like(u)
            ms32, msbf = ab(lambda: k32(x, taps, False, 0.0, out=o32),
                            lambda: kbf(x, taps, False, 0.0, out=obf))
            _hold(worst, key if key in _MEHR else name, obf, pbf(x, taps, False, 0.0),
                  f"bf16 compute k={k} at {n}^3 {kind} {dtype} bc=0.0")
            direct = name in ("apply_taps_direct", "apply_taps_direct2")
            code = sd.direct_instance(taps) if direct else ss.stream_instance(taps)
        flops = sd.MEHRSTELLEN_KERNEL_OPS if key in _MEHR else flops_per_update(taps)
        b_ms, by = kernel_bound(name, n, k, u.element_size(), flops, bw)
        res[key] = pair(ms32, msbf, b_ms, by, f"{'h' if direct else 'k'}{k}_"
                                              f"{_instance_name(code)}_{str(dtype)[6:]}")
        del u, x, o32, obf
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    taps = _taps("7pt", n)
    for name, mesh_shape in (("apply_step_fused_dma", (8, 1, 1)),
                             ("apply_superstep_fused_dma", (8, 1, 1)),
                             ("apply_step_fused_rdma", (4, 1, 1)),
                             ("apply_superstep_fused_rdma", (4, 1, 1))):
        k = _FUSED[name][0]
        mesh = _card_mesh(mesh_shape, tuple(n // p for p in mesh_shape))
        us = [torch.rand(mesh.local_shape, device=s.device) for s in mesh.shards]
        o32 = [torch.empty_like(u) for u in us]
        obf = [torch.empty_like(u) for u in us]
        state = _fused_state(mesh, name, f32, False)
        k32 = _fused_pair(name)[0]
        kbf, pbf = _fused_pair(name, cd=bf)

        def go(kern, dst):
            mesh.fork()
            kern(us, taps, mesh, state, False, 0.0, outs=dst)
            mesh.join()

        ms32, msbf = ab(lambda: go(k32, o32), lambda: go(kbf, obf))
        _hold_fused(worst, name, obf, pbf(us, taps, mesh, None, False, 0.0),
                    f"bf16 compute at {n}^3 on {mesh_shape}")
        b_ms, by, _ = fused_bound(n, mesh_shape, k, 4, flops_per_update(taps), bw)
        inst = fd.fused_instance(k, taps)
        res[name] = pair(ms32, msbf, b_ms, by, f"fused_h{k}_{_instance_name(inst)}_float32")
        res[name]["mesh"] = list(mesh_shape)
        res[name]["send_ranges"] = [list(b) for b in state.bounds]
        del us, o32, obf, state
        torch.cuda.empty_cache()
    res["apply_taps_streamk"] = res[f"apply_taps_streamk_k{_STREAMK_HEADLINE}"]
    _say("compute_bf16_times", grid=[n] * 3, bc_value=0.0, times=res, bitwise=True,
         max_abs_err={name: worst[name] for name in COMPUTE_KERNELS})
    return res


def phase_main_path(bw: float) -> dict:
    """Phases 5 and 6 between zeroed and read launch counts; fails unless
    every kernel was launched there, none on a generic instance. Returns
    the launch counts."""
    from heat3d_tpu_torch import ops

    ops.reset_launch_counts()
    phase_golden()
    _golden_mehrstellen()
    _golden_bf16()
    phase_full_width(bw)
    _full_width_mehrstellen(bw)
    _full_width_bf16(bw)
    launches = {**ops.launch_counts(), **_mehrstellen_counts()}
    generic = _generic_counts()
    bf16 = _bf16_counts()
    cells = {**ops.cell_counts(), **_mehrstellen_counts(cells=True)}
    for name in KERNELS + tuple(_MEHR):
        _check(launches[name] > 0, f"{name} was not launched on the main path")
    for name in COMPUTE_KERNELS:
        _check(bf16[name] > 0, f"{name} launched no bf16-compute instance on the main path")
    _check(not any(generic.values()),
           f"the main path's 7pt/27pt direct, stream or fused launches took the generic "
           f"instance: {generic}")
    unit = {name: _unit_cells(_MEHR[name][0] if name in _MEHR else name)
            for name in KERNELS + tuple(_MEHR)}
    equiv = {name: cells[name] / unit[name] for name in unit}
    _say("main_path", kernel_launches={name: launches[name] for name in KERNELS},
         mehrstellen_instance_launches=_mehrstellen_counts(),
         compute_bf16_instance_launches=bf16,
         generic_instance_launches=generic, output_cells=cells,
         launches_1024_equivalent=equiv, launches_1024_equivalent_unit=unit)
    return launches


# the phases after the build, in the order they run; ``--only`` picks some
PHASES = ("compare", "compare_mehrstellen", "compare_bf16", "compare_mesh", "compare_fused",
          "main_path", "kernel_times", "mehrstellen_times", "compute_bf16_times", "dma_times",
          "fused_times", "shard_kernel_times", "cross_gpu")


def _args(argv):
    import argparse

    p = argparse.ArgumentParser(description="On-card smoke test of heat3d_tpu_torch.")
    p.add_argument("--only", default=None, metavar="PHASE[,PHASE...]",
                   help="run the card identification, the build and only these phases "
                        f"({', '.join(PHASES)}), and print no kernels line: a short "
                        "check after a kernel change")
    args = p.parse_args(argv)
    if args.only is not None:
        args.only = args.only.split(",")
        bad = sorted(set(args.only) - set(PHASES))
        if bad:
            p.error(f"unknown phases {bad}; choose from {', '.join(PHASES)}")
    return args


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    run = set(args.only or PHASES)

    t0 = time.perf_counter()
    smi = phase_identify()
    bw = bandwidth(torch.cuda.get_device_name(0))
    resources = phase_build()
    worst = {name: 0.0 for name in KERNELS + tuple(_MEHR)}
    times = {}
    if "compare" in run:
        phase_compare(worst)
    if "compare_mehrstellen" in run:
        phase_compare_mehrstellen(worst)
    if "compare_bf16" in run:
        phase_compare_bf16(worst)
    if "compare_mesh" in run:
        phase_compare_mesh(worst)
    if "compare_fused" in run:
        phase_compare_fused(worst)
    if "main_path" in run:
        launches = phase_main_path(bw)
    if "kernel_times" in run:
        times.update(phase_kernel_times(bw, worst, resources))
    if "mehrstellen_times" in run:
        times.update(phase_mehrstellen_times(bw, worst, resources))
    if "compute_bf16_times" in run:
        bf16_times = phase_compute_bf16_times(bw, worst, resources)
    if "dma_times" in run:
        times["halo_dma"] = phase_dma_times(bw, worst)
    if "fused_times" in run:
        times.update(phase_fused_times(bw, worst, resources))
    if "shard_kernel_times" in run:
        phase_shard_kernel_times(bw, worst)
    if "cross_gpu" in run:
        phase_cross_gpu(worst)
    _say("done", seconds=time.perf_counter() - t0, phases=[p for p in PHASES if p in run])
    if args.only is None:
        kernels = [
            {"name": name, "route": "cuda", "source": _SOURCES[_MEHR.get(name, (name,))[0]],
             "replaces": _REPLACES[_MEHR.get(name, (name,))[0]], "launches": launches[name],
             "max_abs_err": worst[name],
             **{key: times[name][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             **({"compute_bf16_ms": bf16_times[name]["compute_bf16"]["ms"]}
                if name in COMPUTE_KERNELS else {}),
             **({"instance": times[name]["kernel"]} if "kernel" in times[name] else {})}
            for name in KERNELS + tuple(_MEHR)
        ]
        print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
