"""The port's CUDA kernels against their plain PyTorch versions on the card,
bitwise. Marked ``cuda``: they skip on a host without a CUDA device and run
on the GPU with ``python -m pytest tests/test_torch_kernels.py -m cuda``.

Bitwise holds because the kernels evaluate the same tap chain, operation by
operation, with ``__fmul_rn``/``__fadd_rn`` (built with ``--fmad=false``),
and round to bf16 with the same round-to-nearest-even as ``Tensor.to``.
"""

import numpy as np
import pytest
import torch

from heat3d_tpu_torch.core.config import (
    BoundaryCondition, GridConfig, SolverConfig, StencilConfig,
)
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.ops import stencil_direct as sd
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded
from heat3d_tpu_torch.parallel.halo import exchange_halo

pytestmark = pytest.mark.cuda

PAIRS = [
    (sd.apply_taps_direct, sd.apply_taps_direct_ref),
    (sd.apply_taps_direct2, sd.apply_taps_direct2_ref),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


def _taps(kind):
    g = GridConfig.cube(8)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(3, 3, 3), (33, 17, 129), (40, 70, 65)])
def test_kernel_equals_plain_version(cuda, shape, kind, dtype):
    base = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    taps = _taps(kind)
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        for kernel, plain in PAIRS:
            got = kernel(u, taps, periodic, bcv)
            want = plain(u, taps, periodic, bcv)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel.__name__, periodic, bcv)


def test_launch_counts_and_out_checks(cuda):
    u = torch.rand((8, 8, 8), device=cuda)
    taps = _taps("7pt")
    sd.reset_launch_counts()
    out = torch.empty_like(u)
    assert sd.apply_taps_direct(u, taps, out=out).data_ptr() == out.data_ptr()
    sd.apply_taps_direct2(u, taps)
    assert sd.launch_counts() == {"apply_taps_direct": 1, "apply_taps_direct2": 1}
    with pytest.raises(ValueError, match="overlaps"):
        sd.apply_taps_direct(u, taps, out=u)
    with pytest.raises(ValueError, match="contiguous"):
        sd.apply_taps_direct(u.transpose(0, 2), taps)
    with pytest.raises(ValueError, match="dtype"):
        sd.apply_taps_direct(u.half(), taps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(3, 9, 67), (4, 4, 4), (33, 17, 129), (40, 70, 65)])
def test_stream_kernels_equal_plain_versions(cuda, shape, kind, dtype):
    """Includes extents of exactly max(3, k) and x-chunks cut inside the
    ghost rings (33 and 40 planes run as two chunks)."""
    base = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    taps = _taps(kind)
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
        up = exchange_halo(u, bc, bcv, 1)
        assert torch.equal(ss.apply_taps_stream(up, taps), apply_taps_padded(up, taps))
        for k in (k for k in ss.STREAMK_DEPTHS if k <= min(shape)):
            upk = exchange_halo(u, bc, bcv, k)
            got = ss.apply_taps_streamk(upk, taps, k, periodic, bcv)
            want = ss.apply_taps_streamk_ref(upk, taps, k, periodic, bcv)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, periodic, bcv)


@pytest.mark.parametrize("tb", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
def test_exchange_path_solve_equals_direct_solve(cuda, monkeypatch, tb, kind):
    """k steps on the exchange path (stream kernel at tb=1, streamk at
    tb=2..4) equal k direct-kernel steps bitwise."""
    def solve(time_blocking):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind=kind, bc_value=0.3),
                           time_blocking=time_blocking)
        solver = HeatSolver3D(cfg)
        return solver.run(solver.init_state("random"), tb)

    want = solve(1)
    monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    ss.reset_launch_counts()
    got = solve(tb)
    assert ss.launch_counts()["apply_taps_stream" if tb == 1 else "apply_taps_streamk"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_stream_launch_counts_and_out_checks(cuda):
    taps = _taps("7pt")
    up = torch.rand((10, 10, 10), device=cuda)
    ss.reset_launch_counts()
    out = torch.empty((8, 8, 8), device=cuda)
    assert ss.apply_taps_stream(up, taps, out=out).data_ptr() == out.data_ptr()
    ss.apply_taps_stream2(up[:8, :8, :8].contiguous(), taps)
    ss.apply_taps_streamk(up, taps, 3)
    assert ss.launch_counts() == {"apply_taps_stream": 1, "apply_taps_streamk": 2}
    with pytest.raises(ValueError, match="out must match"):
        ss.apply_taps_stream(up, taps, out=torch.empty_like(up))
    with pytest.raises(ValueError, match="overlaps"):
        ss.apply_taps_stream(up, taps, out=up.view(-1)[: 8**3].view(8, 8, 8))


def _card_mesh(cuda, shape, local):
    from heat3d_tpu_torch.parallel.topology import ShardMesh

    n = shape[0] * shape[1] * shape[2]
    return ShardMesh(shape, local, [cuda] * n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2), (3, 1, 2)])
def test_dma_exchange_equals_plain_version(cuda, mesh_shape, dtype):
    """Every shard on one card, each on its own stream: the push/wait
    kernels against their plain version (the ppermute slab copies), 10
    exchanges in a row per plan, widths 1-4, three boundary settings."""
    from heat3d_tpu_torch.ops import halo_dma
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    local = (6, 5, 9)
    mesh = _card_mesh(cuda, mesh_shape, local)
    rng = np.random.default_rng(9)
    halo_dma.reset_launch_counts()
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
        for width in (1, 2, 3, 4):
            dma = ExchangePlan(mesh, bc, width, "dma", dtype)
            ref = ExchangePlan(mesh, bc, width, "ppermute", dtype)
            for _ in range(10):
                us = [torch.from_numpy(rng.standard_normal(local).astype(np.float32))
                      .to(cuda).to(dtype) for _ in mesh.shards]
                mesh.fork()
                got = [p.clone() for p in dma.apply(us, bcv)]
                want = ref.apply(us, bcv)
                mesh.join()
                torch.cuda.synchronize()
                halo_dma.raise_if_timed_out()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (periodic, bcv, width)
    assert halo_dma.launch_counts()["halo_dma"] > 0


def test_streamk_edge_mask_equals_plain_version(cuda):
    """Each shard of a (3,1,2) mesh with its own domain-edge mask."""
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    local = (6, 9, 7)
    mesh = _card_mesh(cuda, (3, 1, 2), local)
    taps = _taps("27pt")
    rng = np.random.default_rng(4)
    for k in ss.STREAMK_DEPTHS:
        plan = ExchangePlan(mesh, BoundaryCondition.DIRICHLET, k, "ppermute", torch.float32)
        us = [torch.from_numpy(rng.standard_normal(local).astype(np.float32)).to(cuda)
              for _ in mesh.shards]
        mesh.fork()
        pads = plan.apply(us, 0.3)
        mesh.join()
        for s in mesh.shards:
            got = ss.apply_taps_streamk(pads[s.rank], taps, k, False, 0.3, edges=s.edges)
            want = ss.apply_taps_streamk_ref(pads[s.rank], taps, k, False, 0.3, s.edges)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, s.coords)


@pytest.mark.parametrize("tb,halo,no_direct", [
    (1, "ppermute", False), (2, "ppermute", False), (3, "ppermute", False),
    (4, "ppermute", False), (1, "ppermute", True), (1, "dma", False),
    (2, "dma", False), (4, "dma", False)])
def test_sharded_solve_equals_single_shard_on_card(cuda, monkeypatch, tb, halo, no_direct):
    from heat3d_tpu_torch.core.config import MeshConfig

    def solve(mesh, time_blocking, halo):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind="7pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), halo=halo,
                           time_blocking=time_blocking)
        solver = HeatSolver3D(cfg, device=cuda)
        return solver.gather(solver.run(solver.init_state("random"), 9))

    want = solve((1, 1, 1), 1, "ppermute")
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    got = solve((2, 2, 2), tb, halo)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("tb,periodic", [(4, True), (4, False), (2, False)])
def test_dma_plan_built_mid_run_on_busy_streams(cuda, tb, periodic):
    """1024^3 on (2,2,2), every shard on one card, ``halo='dma'``, 11 steps:
    the width-1 plan of the remainder steps is built while the supersteps
    still run on the eight shard streams. Its flag words must be zeroed in
    stream order before any neighbour signals them; zeroed out of order
    (on the caller's stream, which shares a hardware queue with a busy
    shard stream), a signal is lost and a wait times out. The result
    equals the (1,1,1) solve bitwise."""
    from heat3d_tpu_torch.core.config import MeshConfig
    from heat3d_tpu_torch.ops import halo_dma

    bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET

    def solve(mesh, time_blocking, halo):
        cfg = SolverConfig(grid=GridConfig.cube(1024),
                           stencil=StencilConfig(kind="7pt", bc=bc,
                                                 bc_value=0.0 if periodic else 0.3),
                           mesh=MeshConfig(shape=mesh), halo=halo,
                           time_blocking=time_blocking)
        solver = HeatSolver3D(cfg, device=cuda)
        return solver, solver.run(solver.init_state("hot-cube"), 11)

    _, want = solve((1, 1, 1), 1, "ppermute")
    solver, got = solve((2, 2, 2), tb, "dma")
    torch.cuda.synchronize()
    halo_dma.raise_if_timed_out()
    for s, shard in zip(solver.mesh.shards, got.shards):
        region = tuple(slice(o, o + n) for o, n in zip(s.origin, solver.mesh.local_shape))
        assert torch.equal(shard, want[region]), s.coords
