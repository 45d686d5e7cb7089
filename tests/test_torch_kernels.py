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
@pytest.mark.parametrize("shape", [(3, 3, 3), (33, 17, 129), (40, 70, 65), (1, 1, 1),
                                   (2, 3, 5), (4, 45, 130), (5, 77, 125), (6, 39, 127)])
def test_kernel_equals_plain_version(cuda, shape, kind, dtype):
    """The direct kernels on the instance the default knobs pick (the
    compile-time one for both stencils), Dirichlet bc 0 and 0.3 and
    periodic: extents below 2H+1, odd nz (periodic rows whose wrapped
    source starts on the other parity), y and z no multiple of the tiles,
    several tiles each way; each also with the x-chunk forced to 3
    planes."""
    base = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    taps = _taps(kind)
    assert sd.direct_instance(taps) != ss.GENERIC
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        for halo, (kernel, plain) in enumerate(PAIRS, start=1):
            want = plain(u, taps, periodic, bcv)
            got = kernel(u, taps, periodic, bcv)
            chunked = sd.launch_instance(halo, sd.direct_instance(taps), u, taps, periodic,
                                         bcv, xchunk=3)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel.__name__, periodic, bcv)
            assert torch.equal(chunked, want), (kernel.__name__, periodic, bcv, "xchunk 3")


@pytest.mark.parametrize("knobs", [{"HEAT3D_FACTOR_7PT": "1"}, {"HEAT3D_FACTOR_Y": "0"},
                                   {"HEAT3D_FACTOR_7PT": "1", "HEAT3D_FACTOR_Y": "0"}],
                         ids=["f7", "fy0", "both"])
def test_direct_generic_instance_equals_plain_version(cuda, monkeypatch, knobs):
    """Under the factoring knobs the direct kernels take the generic
    (interpreted) instance exactly where the emission program is no
    ``CHAINS`` entry, counted apart, and stay bitwise; the generic instance
    forced on the default 7pt chain is bitwise too."""
    for key, value in knobs.items():
        monkeypatch.setenv(key, value)
    shape = (9, 45, 131)
    base = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.from_numpy(base).to(cuda).to(dtype)
        for kind in ("7pt", "27pt"):
            taps = _taps(kind)
            generic = sd.direct_instance(taps) == ss.GENERIC
            sd.reset_launch_counts()
            for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
                for kernel, plain in PAIRS:
                    got = kernel(u, taps, periodic, bcv)
                    torch.cuda.synchronize()
                    assert torch.equal(got, plain(u, taps, periodic, bcv)), \
                        (kernel.__name__, kind, periodic, bcv)
            launches = sd.launch_counts()
            assert sd.generic_launch_counts() == (launches if generic else
                                                  {n: 0 for n in launches})
    monkeypatch.delenv("HEAT3D_FACTOR_7PT", raising=False)
    monkeypatch.delenv("HEAT3D_FACTOR_Y", raising=False)
    taps = _taps("7pt")
    u = torch.from_numpy(base).to(cuda)
    for halo, (_, plain) in enumerate(PAIRS, start=1):
        got = sd.launch_instance(halo, ss.GENERIC, u, taps, False, 0.3)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(u, taps, False, 0.3))


def test_direct_instances_fit_and_raise_without_fallback(cuda):
    """Every direct instance fits an SM, the compile-time ones four blocks
    of 256 threads; a compile-time instance given another chain refuses
    the launch and the wrapper raises (no fallback to another instance);
    a bf16 field must start on a 4-byte boundary."""
    for halo in (1, 2):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype in (torch.float32, torch.bfloat16):
                r = sd.instance_resources(halo, code, dtype)
                assert r["blocks_per_sm"] >= (4 if code != ss.GENERIC else 1), \
                    (halo, code, dtype, r)
    u = torch.rand((8, 8, 8), device=cuda)
    sd.reset_launch_counts()
    with pytest.raises(RuntimeError, match="bad arguments"):
        sd.launch_instance(1, 2, u, _taps("7pt"))
    with pytest.raises(RuntimeError, match="bad arguments"):
        sd.launch_instance(2, 1, u, _taps("27pt"))
    assert sd.launch_counts() == {"apply_taps_direct": 0, "apply_taps_direct2": 0}
    flat = torch.zeros(10**3 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="4-byte boundary"):
        sd.apply_taps_direct(flat[1:].view(10, 10, 10), _taps("7pt"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 5), (3, 9, 67), (5, 77, 125),
                                   (6, 39, 127), (33, 17, 129), (40, 70, 65), (70, 45, 131)])
def test_mehrstellen_instance_equals_plain_version(cuda, monkeypatch, shape, dtype):
    """Under ``HEAT3D_MEHRSTELLEN`` the 27pt direct launches take the
    compile-time Mehrstellen instance (counted in ``mehrstellen_launches``)
    and equal its plain version bitwise, Dirichlet bc 0 and 0.3 and
    periodic, at halo 1 and 2: extents below 2H+1, odd nz, y and z no
    multiple of the tiles, and several x-chunks (the wrapper's, and forced
    to 3 planes)."""
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    base = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    taps = _taps("27pt")
    assert sd.direct_instance(taps) == sd.MEHRSTELLEN
    sd.reset_launch_counts()
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        for halo, (kernel, plain) in enumerate(PAIRS, start=1):
            want = plain(u, taps, periodic, bcv)
            got = kernel(u, taps, periodic, bcv)
            chunked = sd.launch_instance(halo, sd.MEHRSTELLEN, u, taps, periodic, bcv,
                                         xchunk=3)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel.__name__, periodic, bcv)
            assert torch.equal(chunked, want), (kernel.__name__, periodic, bcv, "xchunk 3")
    assert sd.mehrstellen_launch_counts() == sd.launch_counts() == {
        "apply_taps_direct": 6, "apply_taps_direct2": 6}
    assert sd.generic_launch_counts() == {"apply_taps_direct": 0, "apply_taps_direct2": 0}


def test_mehrstellen_instance_fits_and_raises_without_fallback(cuda, monkeypatch):
    """The Mehrstellen instances fit three blocks of 256 threads an SM (their
    launch bounds: the bf16 one-update instance four); forced on taps that
    do not decompose the launch raises, and a 7pt solve under the knob
    keeps its chain instance."""
    for halo in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            r = sd.instance_resources(halo, sd.MEHRSTELLEN, dtype)
            want = 4 if (halo, dtype) == (1, torch.bfloat16) else 3
            assert r["blocks_per_sm"] >= want, (halo, dtype, r)
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    u = torch.rand((8, 8, 8), device=cuda)
    sd.reset_launch_counts()
    with pytest.raises(ValueError, match="a\\*delta"):
        sd.launch_instance(1, sd.MEHRSTELLEN, u, _taps("7pt"))
    sd.apply_taps_direct2(u, _taps("7pt"))
    assert sd.mehrstellen_launch_counts() == {"apply_taps_direct": 0, "apply_taps_direct2": 0}
    assert sd.launch_counts() == {"apply_taps_direct": 0, "apply_taps_direct2": 1}


@pytest.mark.parametrize("tb", [1, 2])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_mehrstellen_sharded_solve_equals_single_shard_on_card(cuda, monkeypatch, tb,
                                                               storage):
    """Under the knob the (2,2,2) faces-direct solve (Mehrstellen instance
    on each shard, Mehrstellen plain shells) equals the (1,1,1) solve."""
    from heat3d_tpu_torch.core.config import MeshConfig, Precision

    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")

    def solve(mesh):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind="27pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), time_blocking=tb,
                           precision=Precision(storage=storage))
        solver = HeatSolver3D(cfg, device=cuda)
        return solver.gather(solver.run(solver.init_state("random"), 9))

    sd.reset_launch_counts()
    want = solve((1, 1, 1))
    assert sum(sd.mehrstellen_launch_counts().values()) > 0
    assert solve((2, 2, 2)).tobytes() == want.tobytes()


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
@pytest.mark.parametrize("shape", [(3, 9, 67), (4, 4, 4), (33, 17, 129), (40, 70, 65),
                                   (1, 1, 1), (2, 1, 3), (5, 61, 131), (70, 39, 63)])
def test_stream_kernels_equal_plain_versions(cuda, monkeypatch, shape, kind, dtype):
    """Includes extents of exactly max(3, k) and x-chunks cut inside the
    ghost rings (33 and 40 planes run as two chunks); extents that are no
    multiple of the specialised instances' tiles in y (24-38 rows) or z
    (56-62 columns), or of the x-chunk (70 planes: 24 + 24 + 22); and
    extents down to 1, where streamk runs on a random padded block (the
    exchange needs extents >= k). Each case runs the instance the default
    knobs pick (specialised for both stencils) and the generic instance
    (``HEAT3D_FACTOR_7PT=1`` and ``HEAT3D_FACTOR_Y=0``)."""
    base = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    rng = np.random.default_rng(6)
    for generic in (False, True):
        if generic:
            monkeypatch.setenv("HEAT3D_FACTOR_7PT", "1")
            monkeypatch.setenv("HEAT3D_FACTOR_Y", "0")
        taps = _taps(kind)
        assert (ss.stream_instance(taps) == ss.GENERIC) == generic
        ss.reset_launch_counts()
        for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
            bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
            up = exchange_halo(u, bc, bcv, 1)
            got = ss.apply_taps_stream(up, taps)
            torch.cuda.synchronize()
            assert torch.equal(got, apply_taps_padded(up, taps)), (periodic, bcv, generic)
            for k in ss.STREAMK_DEPTHS:
                if k <= min(shape):
                    upk = exchange_halo(u, bc, bcv, k)
                else:
                    upk = torch.from_numpy(rng.standard_normal(
                        tuple(n + 2 * k for n in shape)).astype(np.float32)).to(cuda).to(dtype)
                got = ss.apply_taps_streamk(upk, taps, k, periodic, bcv)
                want = ss.apply_taps_streamk_ref(upk, taps, k, periodic, bcv)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (k, periodic, bcv, generic)
        launches = ss.launch_counts()
        assert ss.generic_launch_counts() == (launches if generic else
                                              {n: 0 for n in launches})
        assert ss.cell_counts()["apply_taps_stream"] == 3 * u.numel()


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


def test_stream_instances_fit_and_check_alignment(cuda):
    """Every instance fits an SM; the specialised streamk K=4 instances keep
    four blocks of 256 threads on one (the design's register and shared
    memory budget). A bf16 padded field must start on a 4-byte boundary
    (its rows are copied as element pairs)."""
    for k in (1, *ss.STREAMK_DEPTHS):
        for code in (ss.GENERIC, *ss.CHAINS):
            for dtype in (torch.float32, torch.bfloat16):
                r = ss.instance_resources(k, code, dtype)
                assert r["blocks_per_sm"] >= (4 if code != ss.GENERIC and k == 4 else 1), \
                    (k, code, dtype, r)
    flat = torch.zeros(10**3 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="4-byte boundary"):
        ss.apply_taps_stream(flat[1:].view(10, 10, 10), _taps("7pt"))


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
                got = dma.apply(us, bcv)
                want = ref.apply(us, bcv)
                mesh.join()  # the blocks are written on the shard streams
                torch.cuda.synchronize()
                halo_dma.raise_if_timed_out()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (periodic, bcv, width)
    assert halo_dma.launch_counts()["halo_dma"] > 0


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (3, 1, 2), (1, 2, 1)])
def test_dma_exchange_odd_extents_bf16(cuda, mesh_shape):
    """bf16 blocks of odd extents, so padded rows start on either 4-byte
    parity and the push copies them in the widest vectors each row allows:
    widths 1-4, three boundary settings, 3 exchanges a plan, against the
    ppermute slab copies; each axis one push and one wait launch on the
    one card."""
    from heat3d_tpu_torch.ops import halo_dma
    from heat3d_tpu_torch.parallel.plan import ExchangePlan

    local = (7, 5, 9)
    mesh = _card_mesh(cuda, mesh_shape, local)
    rng = np.random.default_rng(10)
    axes = sum(1 for n in mesh_shape if n > 1)
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
        for width in (1, 2, 3, 4):
            dma = ExchangePlan(mesh, bc, width, "dma", torch.bfloat16)
            ref = ExchangePlan(mesh, bc, width, "ppermute", torch.bfloat16)
            for _ in range(3):
                us = [torch.from_numpy(rng.standard_normal(local).astype(np.float32))
                      .to(cuda).to(torch.bfloat16) for _ in mesh.shards]
                before = halo_dma.launch_counts()["halo_dma"]
                mesh.fork()
                got = dma.apply(us, bcv)
                want = ref.apply(us, bcv)
                mesh.join()
                torch.cuda.synchronize()
                halo_dma.raise_if_timed_out()
                assert halo_dma.launch_counts()["halo_dma"] - before == 2 * axes
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (periodic, bcv, width)


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


def _split(u, mesh):
    return [u[tuple(slice(o, o + n) for o, n in zip(s.origin, mesh.local_shape))].contiguous()
            for s in mesh.shards]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mesh_shape,shape", [
    ((4, 1, 1), (16, 20, 70)), ((2, 1, 1), (8, 33, 65)), ((3, 1, 1), (18, 17, 40)),
    ((2, 2, 2), (12, 20, 70)), ((2, 1, 3), (8, 9, 66))])
def test_fused_kernels_equal_plain_versions(cuda, mesh_shape, shape, dtype):
    """The four fused kernels (fused DMA tb 1/2, fused RDMA tb 1/2 with the
    plan's ranges), every shard on one card in one launch, against their
    plain versions, five launches in a row per state; the landed ghosts of
    ``return_ghosts`` too. The tb=2 kernel only on x-slab meshes."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    local = tuple(g // p for g, p in zip(shape, mesh_shape))
    mesh = _card_mesh(cuda, mesh_shape, local)
    rng = np.random.default_rng(11)
    slab = mesh_shape[1] == mesh_shape[2] == 1
    fd.reset_launch_counts()
    fr.reset_launch_counts()
    for kind in ("7pt", "27pt"):
        taps = _taps(kind)
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            for tb in ((1, 2) if slab and local[0] >= 4 else (1,)):
                for bounds, fns in (
                    (None, (fd.apply_step_fused_dma, fd.apply_superstep_fused_dma)),
                    (partition_bounds(local[1], 3),
                     (fr.apply_step_fused_rdma, fr.apply_superstep_fused_rdma)),
                ):
                    state = fd.FusedState(mesh, tb, dtype, periodic, bounds)
                    for _ in range(5):
                        u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                        us = _split(u.to(cuda).to(dtype), mesh)
                        if tb == 2:
                            got = fns[1](us, taps, mesh, state, periodic, bcv)
                            want = fd.reference_fused_superstep(us, taps, mesh, periodic, bcv)
                            gh = wgh = []
                        elif bounds is None:
                            got, gh = fns[0](us, taps, mesh, state, periodic, bcv,
                                             return_ghosts=True)
                            want, wgh = fd.reference_fused_step(us, taps, mesh, periodic, bcv,
                                                                return_ghosts=True)
                            gh = [tuple(x.clone() for x in g) for g in gh]
                        else:
                            got = fns[0](us, taps, mesh, state, periodic, bcv)
                            want = fd.reference_fused_step(us, taps, mesh, periodic, bcv)
                            gh = wgh = []
                        torch.cuda.synchronize()
                        fd.raise_if_timed_out()
                        for g, w in zip(got, want):
                            assert torch.equal(g, w), (kind, periodic, tb, bounds)
                        for g, w in zip(gh, wgh):
                            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert fd.launch_counts()["apply_step_fused_dma"] > 0
    assert fr.launch_counts()["apply_step_fused_rdma"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("halo,mesh_shape,shape,parts", [
    (1, (8, 1, 1), (64, 40, 70), 1), (1, (4, 1, 1), (16, 20, 70), 3),
    (1, (2, 2, 2), (12, 20, 70), 1), (1, (2, 1, 1), (4, 77, 125), 2),
    (2, (8, 1, 1), (64, 40, 70), 1), (2, (4, 1, 1), (16, 20, 70), 3),
    (2, (2, 1, 1), (8, 77, 125), 2), (2, (2, 1, 1), (8, 77, 125), 3)])
def test_fused_compile_time_and_generic_instances_equal(cuda, halo, mesh_shape, shape, parts,
                                                        dtype):
    """The fused kernel's compile-time instance of ``halo`` updates (the one
    the 7pt and 27pt taps take) and its generic instance forced, both
    bitwise equal to the plain version: x-slabs with whole-face and
    partitioned send ranges, the 3D mesh (one update), and a ragged, odd
    ny*nz at nx = 2H a shard (bf16 planes, the landed ones too, start on
    either parity)."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    local = tuple(g // p for g, p in zip(shape, mesh_shape))
    mesh = _card_mesh(cuda, mesh_shape, local)
    u = torch.from_numpy(np.random.default_rng(14).standard_normal(shape).astype(np.float32))
    us = _split(u.to(cuda).to(dtype), mesh)
    bounds = None if parts == 1 else partition_bounds(local[1], parts)
    wrapper = fd.KERNELS[halo - 1]
    plain = fd.reference_fused_step if halo == 1 else fd.reference_fused_superstep
    for kind in ("7pt", "27pt"):
        taps = _taps(kind)
        inst = fd.fused_instance(halo, taps)
        assert inst != 0
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            state = fd.FusedState(mesh, halo, dtype, periodic, bounds)
            want = plain(us, taps, mesh, periodic, bcv)
            for instance in (inst, 0):
                before = fd.generic_launch_counts()[wrapper.__name__]
                got = fd.launch_instance(instance, us, taps, mesh, state, periodic, bcv)
                torch.cuda.synchronize()
                fd.raise_if_timed_out()
                took = fd.generic_launch_counts()[wrapper.__name__] - before
                assert took == (instance == 0)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (kind, periodic, instance)


@pytest.mark.parametrize("halo", [1, 2])
def test_fused_launches_in_a_row_see_fresh_landed_planes(cuda, halo):
    """50 compile-time fused launches of ``halo`` updates on one state, the
    input changed on the shard streams between them and no host sync: each
    launch's skin planes must read the ghosts its own pushes landed, not an
    earlier launch's (a stale read, through L1 or out of order, shows as a
    mismatch)."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    mesh = _card_mesh(cuda, (8, 1, 1), (8, 40, 70))
    taps = _taps("7pt")
    base = _split(torch.from_numpy(np.random.default_rng(15).standard_normal((64, 40, 70))
                                   .astype(np.float32)).to(cuda), mesh)
    state = fd.FusedState(mesh, halo, torch.float32, False, partition_bounds(40, 2))
    kern = fd.KERNELS[halo - 1]
    plain = fd.reference_fused_step if halo == 1 else fd.reference_fused_superstep
    snaps = []
    mesh.fork()
    for i in range(50):
        us = []
        for s, b in zip(mesh.shards, base):
            with mesh.on(s):
                us.append(b * (i + 1))
        outs = kern(us, taps, mesh, state, False, 0.3)
        snap = []
        for s, o in zip(mesh.shards, outs):
            with mesh.on(s):
                snap.append(o.clone())
        snaps.append(snap)
    mesh.join()
    torch.cuda.synchronize()
    fd.raise_if_timed_out()
    for i, snap in enumerate(snaps):
        want = plain([b * (i + 1) for b in base], taps, mesh, False, 0.3)
        for g, w in zip(snap, want):
            assert torch.equal(g, w), i


def test_fused_launch_checks(cuda):
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    mesh = _card_mesh(cuda, (2, 1, 1), (4, 8, 8))
    state = fd.FusedState(mesh, 1, torch.float32, False)
    us = [torch.rand((4, 8, 8), device=cuda) for _ in range(2)]
    taps = _taps("7pt")
    with pytest.raises(ValueError, match="overlaps"):
        fd.apply_step_fused_dma(us, taps, mesh, state, outs=[us[1], torch.empty_like(us[0])])
    with pytest.raises(ValueError, match="want"):
        fd.apply_step_fused_dma([u.double() for u in us], taps, mesh, state)
    with pytest.raises(ValueError, match="width"):
        fd.apply_superstep_fused_dma(us, taps, mesh, state)
    with pytest.raises(ValueError, match="FusedState"):
        fd.apply_step_fused_dma(us, taps, mesh)


@pytest.mark.parametrize("mesh_shape,kw", [
    ((4, 1, 1), dict(overlap=True, halo="dma")),
    ((4, 1, 1), dict(overlap=True, halo="dma", time_blocking=2)),
    ((2, 2, 2), dict(overlap=True, halo="dma")),
    ((4, 1, 1), dict(fused_rdma="on", halo_plan="partitioned")),
    ((4, 1, 1), dict(fused_rdma="on", halo_plan="partitioned", time_blocking=2)),
    ((2, 2, 2), dict(overlap=True, backend="pallas"))])
def test_overlap_routes_equal_single_shard_on_card(cuda, monkeypatch, mesh_shape, kw):
    from heat3d_tpu_torch.core.config import MeshConfig

    monkeypatch.setenv("HEAT3D_PLAN_PART_MIN_BYTES", "0")

    def solve(mesh, **knobs):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind="27pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), **knobs)
        solver = HeatSolver3D(cfg, device=cuda)
        return solver.gather(solver.run(solver.init_state("random"), 9))

    want = solve((1, 1, 1))
    if mesh_shape == (2, 2, 2) and "halo" not in kw:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")  # the overlap split
    assert solve(mesh_shape, **kw).tobytes() == want.tobytes()


def test_fused_state_built_mid_run_on_busy_streams(cuda):
    """1024^3 on (8,1,1), every shard on one card, ``dma`` + ``overlap``,
    tb=2, 11 steps: the tb=1 kernel's state of the remainder step is built
    while the supersteps still run. It is zeroed on the stream its kernel
    runs on, so no signal is lost; the result equals the (1,1,1) solve
    bitwise."""
    from heat3d_tpu_torch.core.config import MeshConfig
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd

    def solve(mesh, **knobs):
        cfg = SolverConfig(grid=GridConfig.cube(1024),
                           stencil=StencilConfig(kind="7pt", bc_value=0.3),
                           mesh=MeshConfig(shape=mesh), **knobs)
        solver = HeatSolver3D(cfg, device=cuda)
        return solver, solver.run(solver.init_state("hot-cube"), 11)

    _, want = solve((1, 1, 1))
    fd.reset_launch_counts()
    solver, got = solve((8, 1, 1), halo="dma", overlap=True, time_blocking=2)
    torch.cuda.synchronize()
    fd.raise_if_timed_out()
    assert fd.launch_counts() == {"apply_step_fused_dma": 1, "apply_superstep_fused_dma": 5}
    for s, shard in zip(solver.mesh.shards, got.shards):
        region = tuple(slice(o, o + n) for o, n in zip(s.origin, solver.mesh.local_shape))
        assert torch.equal(shard, want[region]), s.coords


# ---- bf16 compute ------------------------------------------------------------

BF16_KERNELS = ["direct1", "direct2", "direct1_mehrstellen", "direct2_mehrstellen",
                "stream1", "streamk2", "streamk3", "streamk4"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kernel", BF16_KERNELS)
def test_compute_bf16_instances_equal_plain_versions(cuda, monkeypatch, kernel, dtype):
    """Every stencil kernel's bf16-compute instance (``compute_dtype=
    torch.bfloat16``: the ``Bf16Math`` policy) against its plain version in
    bf16 compute, bitwise, 7pt and 27pt (the Mehrstellen instances 27pt
    under ``HEAT3D_MEHRSTELLEN=1``), Dirichlet bc 0 and 0.3 and periodic,
    at a ragged shape and with the generic instance forced on the same
    chain (the chains only); each launch counted as one bf16-compute
    launch."""
    bf = torch.bfloat16
    mehr = kernel.endswith("mehrstellen")
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1" if mehr else "0")
    shape = (37, 45, 131)
    u = torch.from_numpy(np.random.default_rng(12).standard_normal(shape)
                         .astype(np.float32)).to(cuda).to(dtype)
    for kind in (("27pt",) if mehr else ("7pt", "27pt")):
        taps = _taps(kind)
        for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
            bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
            if kernel.startswith("direct"):
                halo = int(kernel[6])
                plain = PAIRS[halo - 1][1](u, taps, periodic, bcv, bf)
                # the generic instance runs the chain, not the Mehrstellen route
                codes = (sd.direct_instance(taps),) + (() if mehr else (ss.GENERIC,))
                runs = [lambda c=c: sd.launch_instance(halo, c, u, taps, periodic, bcv,
                                                       compute_dtype=bf) for c in codes]
                counts = sd.compute_bf16_launch_counts
                name = PAIRS[halo - 1][0].__name__
            else:
                k = 1 if kernel == "stream1" else int(kernel[-1])
                up = exchange_halo(u, bc, bcv, k)
                if k == 1:
                    plain = apply_taps_padded(up, taps, mehrstellen=False, compute_dtype=bf)
                    runs = [lambda: ss.apply_taps_stream(up, taps, compute_dtype=bf)]
                    name = "apply_taps_stream"
                else:
                    plain = ss.apply_taps_streamk_ref(up, taps, k, periodic, bcv,
                                                      compute_dtype=bf)
                    runs = [lambda: ss.apply_taps_streamk(up, taps, k, periodic, bcv,
                                                          compute_dtype=bf)]
                    name = "apply_taps_streamk"
                counts = ss.compute_bf16_launch_counts
            for run in runs:
                before = counts()[name]
                got = run()
                torch.cuda.synchronize()
                assert torch.equal(got, plain), (kernel, kind, periodic, bcv)
                assert counts()[name] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mesh_shape,shape", [((8, 1, 1), (64, 40, 70)),
                                              ((4, 1, 1), (16, 20, 70))])
def test_fused_compute_bf16_instances_equal_plain_versions(cuda, mesh_shape, shape, dtype):
    """The four fused kernels' bf16-compute instances (compile-time and
    generic), every shard on one card in one launch, against their plain
    versions in bf16 compute, bitwise; the RDMA ones with three send
    ranges a face."""
    from heat3d_tpu_torch.ops import stencil_dma_fused as fd
    from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
    from heat3d_tpu_torch.parallel.plan import partition_bounds

    bf = torch.bfloat16
    local = tuple(g // p for g, p in zip(shape, mesh_shape))
    mesh = _card_mesh(cuda, mesh_shape, local)
    u = torch.from_numpy(np.random.default_rng(13).standard_normal(shape).astype(np.float32))
    us = _split(u.to(cuda).to(dtype), mesh)
    for kind in ("7pt", "27pt"):
        taps = _taps(kind)
        for periodic, bcv in ((False, 0.3), (True, 0.0)):
            for tb in (1, 2):
                want = (fd.reference_fused_step(us, taps, mesh, periodic, bcv, compute_dtype=bf)
                        if tb == 1 else
                        fd.reference_fused_superstep(us, taps, mesh, periodic, bcv,
                                                     compute_dtype=bf))
                for bounds, wrapper in ((None, (fd.apply_step_fused_dma,
                                                fd.apply_superstep_fused_dma)[tb - 1]),
                                        (partition_bounds(local[1], 3),
                                         (fr.apply_step_fused_rdma,
                                          fr.apply_superstep_fused_rdma)[tb - 1])):
                    state = fd.FusedState(mesh, tb, dtype, periodic, bounds)
                    for instance in (fd.fused_instance(tb, taps), ss.GENERIC):
                        before = wrapper.compute_bf16_launches
                        got = fd.launch_instance(instance, us, taps, mesh, state, periodic,
                                                 bcv, wrapper=wrapper, compute_dtype=bf)
                        torch.cuda.synchronize()
                        fd.raise_if_timed_out()
                        for g, w in zip(got, want):
                            assert torch.equal(g, w), (kind, periodic, tb, bounds, instance)
                        assert wrapper.compute_bf16_launches == before + 1
