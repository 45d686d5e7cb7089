"""The port's Mehrstellen route (``HEAT3D_MEHRSTELLEN``) against the JAX
package, on the CPU.

Under the knob, taps that decompose as ``a*delta + b*S + d*F`` (the 27pt
set) take the route in the plain update (``stencil_eager.apply_taps_padded``)
and in the direct kernels (the compile-time q-ring instance of
``csrc/stencil_direct.cu``; on the CPU the wrappers run its plain version).
These tests hold:

- the plain update to the JAX ``stencil_jnp.apply_taps_padded`` under the
  knob, and bitwise to a numpy float32 evaluation of the canonical op
  order (one rounded op per step), which pins the order itself;
- the direct wrappers to the JAX Pallas direct kernels in interpret mode
  under the knob (one budget of ``torch_port_checks``' tolerance at tb=1,
  two at tb=2), one case with several y-chunks on the JAX side;
- the instance choice, the sharded faces-direct solve against the
  (1,1,1) solve bitwise, the bench rows' route provenance and the build's
  table.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat3d_tpu.ops.stencil_pallas_direct as ref_direct
from heat3d_tpu.analysis.provenance import check_row
from heat3d_tpu.ops.stencil_jnp import apply_taps_padded as ref_apply_taps_padded
from heat3d_tpu_torch.bench.harness import throughput_row
from heat3d_tpu_torch.core import config
from heat3d_tpu_torch.core.stencils import MEHRSTELLEN_OPS, decompose_mehrstellen
from heat3d_tpu_torch.eqn import solver_taps
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.ops import _build
from heat3d_tpu_torch.ops import stencil_direct as sd
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded, pad_local
from torch_port_checks import BCS, DTYPES, _as_np, _field, _taps, assert_close_per_update

BC_IDS = ["dir0", "dir0.3", "periodic"]


def _bc(periodic):
    return (config.BoundaryCondition.PERIODIC if periodic
            else config.BoundaryCondition.DIRICHLET)


@pytest.fixture
def knob(monkeypatch):
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    return monkeypatch


# ---- (a) the plain update against stencil_jnp ------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("periodic,bcv", BCS, ids=BC_IDS)
@pytest.mark.parametrize("shape", [(6, 7, 9), (3, 16, 5)])
def test_plain_update_matches_stencil_jnp(knob, shape, periodic, bcv, dtype):
    storage, tdtype, jdtype = dtype
    taps = _taps("27pt", shape)
    ju, tu = _field(shape, 31, jdtype)
    up = pad_local(tu.to(tdtype), _bc(periodic), bcv)
    jup = jnp.asarray(_as_np(up)).astype(jdtype)  # the same padded block
    want = ref_apply_taps_padded(jup, taps, mehrstellen=True)
    got = apply_taps_padded(up, taps, mehrstellen=True)
    assert got.dtype == tdtype and tuple(got.shape) == shape
    assert torch.equal(got, apply_taps_padded(up, taps))  # None follows the knob
    assert_close_per_update(_as_np(got), np.asarray(want.astype(jnp.float32)), storage, 1,
                            err_msg=f"{shape} {storage} periodic={periodic} bc={bcv}")


def test_plain_update_route_argument(monkeypatch):
    """``mehrstellen``: None follows the knob, False forces the tap chain,
    True takes the route only for taps that decompose (7pt has b = 0)."""
    shape = (5, 6, 7)
    up = pad_local(torch.from_numpy(np.random.default_rng(2).standard_normal(shape)
                                    .astype(np.float32)), _bc(False), 0.1)
    taps27, taps7 = _taps("27pt", shape), _taps("7pt", shape)
    chain = apply_taps_padded(up, taps27, mehrstellen=False)
    mehr = apply_taps_padded(up, taps27, mehrstellen=True)
    assert not torch.equal(chain, mehr)
    monkeypatch.delenv("HEAT3D_MEHRSTELLEN", raising=False)
    assert torch.equal(apply_taps_padded(up, taps27), chain)
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    assert torch.equal(apply_taps_padded(up, taps27), mehr)
    assert torch.equal(apply_taps_padded(up, taps27, mehrstellen=False), chain)
    assert decompose_mehrstellen(taps7) is None
    assert torch.equal(apply_taps_padded(up, taps7, mehrstellen=True),
                       apply_taps_padded(up, taps7, mehrstellen=False))


# ---- (b) the canonical op order, bitwise -----------------------------------


def _numpy_canonical(up: np.ndarray, coeffs) -> np.ndarray:
    """The canonical Mehrstellen order in numpy float32, one rounded op a
    step (``stencil_jnp._apply_mehrstellen_padded``'s docstring)."""
    f = up.astype(np.float32)
    nx, ny, nz = (n - 2 for n in f.shape)
    a, b, d = (np.float32(c) for c in coeffs)
    three = np.float32(3.0)
    z131 = (f[:, :, 0:nz] + f[:, :, 2:nz + 2]) + three * f[:, :, 1:nz + 1]
    y131 = (z131[:, 0:ny] + z131[:, 2:ny + 2]) + three * z131[:, 1:ny + 1]
    s = (y131[0:nx] + y131[2:nx + 2]) + three * y131[1:nx + 1]
    c = f[1:nx + 1, 1:ny + 1, 1:nz + 1]
    px = f[0:nx, 1:ny + 1, 1:nz + 1] + f[2:nx + 2, 1:ny + 1, 1:nz + 1]
    py = f[1:nx + 1, 0:ny, 1:nz + 1] + f[1:nx + 1, 2:ny + 2, 1:nz + 1]
    pz = f[1:nx + 1, 1:ny + 1, 0:nz] + f[1:nx + 1, 1:ny + 1, 2:nz + 2]
    psum = (px + py) + pz
    return (a * c + b * s) + d * psum


@pytest.mark.parametrize("grid", [{}, {"alpha": 0.05, "dt": 0.2}], ids=["stable-dt", "small-dt"])
@pytest.mark.parametrize("shape", [(4, 5, 6), (9, 3, 17)])
def test_plain_update_is_the_canonical_order_bitwise(shape, grid):
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps

    g = config.GridConfig(shape=shape, **grid)
    taps = stencil_taps(STENCILS["27pt"], g.alpha, g.effective_dt(), g.spacing)
    coeffs = decompose_mehrstellen(taps)
    up = (np.random.default_rng(17).standard_normal(tuple(n + 2 for n in shape))
          .astype(np.float32))
    got = apply_taps_padded(torch.from_numpy(up), taps, mehrstellen=True).numpy()
    want = _numpy_canonical(up, coeffs)
    assert got.tobytes() == want.tobytes()


# ---- (c) the direct wrappers against the Pallas kernels ---------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 9, 13),
                                   # the two-update instance's 28 x 28 tile and
                                   # its runs of four rows: one tile and one
                                   # more, one run, a run short of the frame
                                   (3, 28, 28), (4, 29, 29), (5, 4, 31), (2, 31, 30)])
@pytest.mark.parametrize("tb", [1, 2])
def test_direct_matches_pallas_interpret_under_knob(knob, tb, shape, dtype):
    storage, tdtype, jdtype = dtype
    taps = _taps("27pt", shape)
    ju, tu = _field(shape, 40 + tb, jdtype)
    kern = sd.apply_taps_direct if tb == 1 else sd.apply_taps_direct2
    ref = ref_direct.apply_taps_direct if tb == 1 else ref_direct.apply_taps_direct2
    for periodic, bcv in BCS:
        want = ref(ju, taps, periodic=periodic, bc_value=bcv, interpret=True)
        got = kern(tu.to(tdtype), taps, periodic, bcv)
        assert got.dtype == tdtype and tuple(got.shape) == shape
        assert_close_per_update(_as_np(got), np.asarray(want.astype(jnp.float32)), storage,
                                tb, err_msg=f"tb={tb} {storage} periodic={periodic} bc={bcv}")


@pytest.mark.parametrize("tb,budget", [(1, 120 * 1024), (2, 150 * 1024)])
def test_direct_matches_pallas_interpret_multichunk(knob, tb, budget):
    """The JAX kernels in chunked-column mode (several y-chunks, the ghost
    rows of each chunk real neighbours), as tests/test_pallas_direct.py
    forces it."""
    shape = (6, 32, 16)
    taps = _taps("27pt", shape)
    knob.setattr(ref_direct, "_VMEM_BUDGET", budget)
    by = ref_direct.choose_chunk(shape, tb, 4, 4, n_taps=15, q_ring=True)
    assert by is not None and by < shape[1], by
    ju, tu = _field(shape, 50 + tb, jnp.float32)
    kern = sd.apply_taps_direct if tb == 1 else sd.apply_taps_direct2
    ref = ref_direct.apply_taps_direct if tb == 1 else ref_direct.apply_taps_direct2
    for periodic, bcv in BCS:
        want = ref(ju, taps, periodic=periodic, bc_value=bcv, interpret=True)
        got = kern(tu, taps, periodic, bcv)
        assert_close_per_update(_as_np(got), np.asarray(want), "float32", tb,
                                err_msg=f"tb={tb} periodic={periodic} bc={bcv}")


# ---- (d) the instance choice ------------------------------------------------


@pytest.mark.parametrize("kind,knob_on,want", [
    ("27pt", True, sd.MEHRSTELLEN), ("27pt", False, 2), ("7pt", True, 1), ("7pt", False, 1)])
def test_direct_instance(monkeypatch, kind, knob_on, want):
    if knob_on:
        monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    else:
        monkeypatch.delenv("HEAT3D_MEHRSTELLEN", raising=False)
    taps = _taps(kind, (8, 8, 8))
    assert sd.direct_instance(taps) == want
    assert sd.mehrstellen_route(taps) == (want == sd.MEHRSTELLEN)
    # the exchange-path and fused kernels keep the chain's instance
    assert ss.stream_instance(taps) == (2 if kind == "27pt" else 1)


def test_mehrstellen_program_carries_the_coefficients(knob):
    taps = _taps("27pt", (8, 8, 8))
    prog = sd.mehrstellen_program(taps)
    assert prog.n == 3
    assert [prog.t[i].w for i in range(3)] == [
        float(np.float32(c)) for c in decompose_mehrstellen(taps)]
    with pytest.raises(ValueError, match="a\\*delta"):
        sd.mehrstellen_program(_taps("7pt", (8, 8, 8)))


def test_cpu_path_counts_no_mehrstellen_launch(knob):
    sd.reset_launch_counts()
    u = torch.zeros((4, 5, 6))
    taps = _taps("27pt", (4, 5, 6))
    sd.apply_taps_direct2(sd.apply_taps_direct(u, taps), taps)
    zero = {"apply_taps_direct": 0, "apply_taps_direct2": 0}
    assert sd.mehrstellen_launch_counts() == sd.launch_counts() == zero


# ---- (e) the sharded solve against the (1,1,1) solve ------------------------


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("periodic", [False, True], ids=["dir0.3", "periodic"])
@pytest.mark.parametrize("tb", [1, 2])
def test_faces_direct_equals_single_shard_bitwise(knob, tb, periodic, storage):
    """The bulk takes the Mehrstellen instance's plain version and the
    shells the Mehrstellen plain update: the (2,2,2) faces-direct solve
    equals the (1,1,1) direct solve bitwise."""
    from heat3d_tpu_torch.parallel.step import step_route, superstep_route

    def solve(mesh):
        cfg = config.SolverConfig(
            grid=config.GridConfig(shape=(16, 16, 16)),
            stencil=config.StencilConfig(kind="27pt", bc=_bc(periodic),
                                         bc_value=0.0 if periodic else 0.3),
            mesh=config.MeshConfig(shape=mesh), time_blocking=tb,
            precision=config.Precision(storage=storage))
        route = superstep_route(cfg) if tb > 1 else step_route(cfg)
        s = HeatSolver3D(cfg, device="cpu")
        return route, s.gather(s.run(s.init_state("random"), 5))

    r1, want = solve((1, 1, 1))
    r8, got = solve((2, 2, 2))
    assert (r1, r8) == (("direct", "faces-direct") if tb == 1 else ("direct2", "faces-direct2"))
    assert got.tobytes() == want.tobytes()
    knob.delenv("HEAT3D_MEHRSTELLEN")
    assert solve((1, 1, 1))[1].tobytes() != want.tobytes()  # the route did change


# ---- (f) the bench rows ------------------------------------------------------

ROWS = [
    # id, SolverConfig keywords, route, Mehrstellen route
    ("direct-tb1", {}, "direct", True),
    ("direct-tb2", {"time_blocking": 2}, "direct2", True),
    ("faces-direct-tb2", {"mesh": config.MeshConfig(shape=(2, 2, 2)), "time_blocking": 2},
     "faces-direct2", True),
    ("exchange-tb4", {"time_blocking": 4}, "streamk", False),
    ("fused-dma2", {"mesh": config.MeshConfig(shape=(4, 1, 1)), "halo": "dma",
                    "overlap": True, "time_blocking": 2}, "fused-dma2", False),
    ("jnp-tb4", {"backend": "jnp", "time_blocking": 4}, "stepk", True),
    ("conv-tb1", {"backend": "conv"}, "exchange", False),
]


@pytest.mark.parametrize("kw,route,q_ring", [r[1:] for r in ROWS], ids=[r[0] for r in ROWS])
def test_bench_row_route_provenance(knob, kw, route, q_ring):
    from heat3d_tpu_torch.bench.harness import mehrstellen_route
    from heat3d_tpu_torch.parallel.step import step_route, superstep_route

    cfg = config.SolverConfig(grid=config.GridConfig.cube(32),
                              stencil=config.StencilConfig(kind="27pt"), **kw)
    shards = int(np.prod(cfg.mesh.shape))
    row = throughput_row(cfg, steps=8, steps_requested=8, times=[0.02, 0.01],
                         devices=[torch.device("cpu")], shards=shards, sync_rtt_s=2e-5,
                         kernel_launches={})
    assert check_row(row) == []
    assert (superstep_route(cfg) if cfg.time_blocking > 1 else step_route(cfg)) == route
    assert row["mehrstellen_route"] is q_ring is mehrstellen_route(cfg)
    if cfg.backend == "conv":
        assert row["chain_ops"] is None
    else:
        want = MEHRSTELLEN_OPS if q_ring else sd.chain_ops(solver_taps(cfg))
        assert row["chain_ops"] == want
    knob.delenv("HEAT3D_MEHRSTELLEN")
    assert mehrstellen_route(cfg) is False


# ---- (g) the build ----------------------------------------------------------


def test_kernel_spec_code_and_build_table():
    """The kernel's SPEC_MEHR is the wrapper's MEHRSTELLEN and no chain
    code; the route adds no -D table, so the direct source's flags are
    still the chain table's, with no comma (nvcc splits -D values there)."""
    src = (_build.CSRC_DIR / "stencil_chain.cuh").read_text()
    assert int(re.search(r"constexpr int SPEC_MEHR = (\d+);", src).group(1)) == sd.MEHRSTELLEN
    assert sd.MEHRSTELLEN not in ss.CHAINS and sd.MEHRSTELLEN != ss.GENERIC
    flags = _build.source_flags("stencil_direct")
    assert flags == ss.nvcc_defines() and all("," not in f for f in flags)
