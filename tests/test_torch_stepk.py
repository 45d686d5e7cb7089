"""Deep temporal blocking and the exchange path of the port's solver, on the
CPU: the streamk contract (``apply_taps_streamk``, k = 2..4) against the
JAX ``apply_taps_pallas_streamk`` in interpret mode inside ``shard_map``;
``HeatSolver3D(cfg, device="cpu")`` at tb 3 and 4, and on the exchange path
(``HEAT3D_NO_DIRECT``) at tb 1 and 2, against the JAX solver (its Pallas
kernels in interpret mode, HEAT3D_DIRECT_INTERPRET=1) and the fp64 golden
oracle; and the route each (tb, backend, HEAT3D_NO_DIRECT) combination
takes.

Tolerances: the kernel contract as stated in tests/torch_port_checks.py (k
updates); the solvers as in tests/test_torch_solver.py, ``rtol=1e-5,
atol=1e-6`` against each other and the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat3d_tpu.ops.stencil_pallas import apply_taps_pallas_streamk
from heat3d_tpu.parallel.step import exchange as ref_exchange
from heat3d_tpu.parallel.step import redundant_flops_frac as ref_frac
from heat3d_tpu_torch.core import config
from heat3d_tpu_torch.models.heat3d import HeatSolver3D, resolved_backend_name
from heat3d_tpu_torch.ops import launch_counts
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.parallel import step
from heat3d_tpu_torch.parallel.halo import exchange_halo
from test_torch_solver import SHAPE, _configs, _golden, _pair
from torch_port_checks import (
    BCS,
    DTYPES,
    _as_np,
    _field,
    _taps,
    assert_close_per_update,
    on_mesh,
    ref_config,
)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_streamk_matches_pallas_interpret(k, kind, dtype):
    storage, tdtype, jdtype = dtype
    shape = (6, 7, 9)
    taps = _taps(kind, shape)
    ju, tu = _field(shape, 30 + k, jdtype)
    for periodic, bcv in BCS:
        cfg = ref_config(shape, kind, periodic, bcv, tb=k)
        want = on_mesh(
            lambda x: apply_taps_pallas_streamk(
                ref_exchange(x, cfg, width=k), taps, k, cfg.mesh.axis_names,
                periodic=periodic, bc_value=bcv, interpret=True),
            cfg, ju)
        bc = (config.BoundaryCondition.PERIODIC if periodic
              else config.BoundaryCondition.DIRICHLET)
        got = ss.apply_taps_streamk(exchange_halo(tu.to(tdtype), bc, bcv, k),
                                    taps, k, periodic, bcv)
        assert got.dtype == tdtype and tuple(got.shape) == shape
        assert_close_per_update(
            _as_np(got), np.asarray(want.astype(jnp.float32)), storage, k,
            err_msg=f"k={k} {kind} {storage} periodic={periodic} bc={bcv}")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("HEAT3D_DIRECT_INTERPRET", "1")


@pytest.mark.parametrize(
    "kind,periodic,bc_value,tb,no_direct",
    [
        ("7pt", False, 0.3, 3, False),
        ("27pt", True, 0.0, 3, False),
        ("7pt", True, 0.0, 4, False),
        ("27pt", False, 0.0, 4, False),
        ("7pt", False, 0.3, 1, True),
        ("27pt", True, 0.0, 1, True),
        ("7pt", True, 0.0, 2, True),
        ("27pt", False, 0.3, 2, True),
    ],
)
def test_solver_matches_reference_and_golden(interpret, monkeypatch, kind, periodic,
                                             bc_value, tb, no_direct):
    """2k+1 steps: supersteps plus a remainder step, each route against the
    JAX solver on the same route and against the fp64 oracle."""
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    steps = 2 * tb + 1
    mine_cfg, ref_cfg = _configs(kind, periodic, bc_value, tb)
    ref, u_ref, mine, u = _pair(mine_cfg, ref_cfg)
    before = launch_counts()
    want = ref.gather(ref.run(u_ref, steps))
    got = mine.gather(mine.run(u, steps))
    assert launch_counts() == before  # the CPU path launches no kernel
    assert got.shape == SHAPE and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    g = _golden(ref_cfg, "random", steps)
    np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want, g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend,tb", [("jnp", 3), ("conv", 1), ("conv", 4)])
def test_backend_arms_match_reference(backend, tb):
    """The jnp and conv arms (exchange path, no kernel) against the JAX
    solver's same arm."""
    import dataclasses

    mine_cfg, ref_cfg = _configs("27pt", False, 0.3, tb)
    mine_cfg = dataclasses.replace(mine_cfg, backend=backend)
    ref_cfg = dataclasses.replace(ref_cfg, backend=backend)
    ref, u_ref, mine, u = _pair(mine_cfg, ref_cfg)
    steps = 2 * tb + 1
    want = ref.gather(ref.run(u_ref, steps))
    got = mine.gather(mine.run(u, steps))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_converge_on_streamk_route_matches_reference(interpret):
    mine_cfg, ref_cfg = _configs("7pt", False, 0.0, 3, residual_every=4)
    ref, u_ref, mine, u = _pair(mine_cfg, ref_cfg, init="gaussian")
    want = ref.run_to_convergence(u_ref, tol=2e-2, max_steps=60)
    got = mine.run_to_convergence(u, tol=2e-2, max_steps=60)
    assert 1 < got.steps < 60 and got.steps == want.steps
    assert got.residual == pytest.approx(want.residual, rel=1e-5)
    np.testing.assert_allclose(mine.gather(got.u), ref.gather(want.u), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "tb,backend,no_direct,want",
    [
        (1, "auto", False, ("direct", None)),
        (1, "pallas", True, ("exchange", None)),
        (1, "jnp", False, ("exchange", None)),
        (1, "conv", False, ("exchange", None)),
        (2, "auto", False, ("direct", "direct2")),
        (2, "auto", True, ("exchange", "streamk")),
        (2, "jnp", False, ("exchange", "stepk")),
        (3, "auto", False, ("direct", "streamk")),
        (4, "pallas", True, ("exchange", "streamk")),
        (4, "conv", False, ("exchange", "stepk")),
        (5, "auto", False, ("direct", "stepk")),
        (6, "auto", True, ("exchange", "stepk")),
    ],
)
def test_dispatch(monkeypatch, tb, backend, no_direct, want):
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    else:
        monkeypatch.delenv("HEAT3D_NO_DIRECT", raising=False)
    cfg = config.SolverConfig(grid=config.GridConfig.cube(8), time_blocking=tb,
                              backend=backend)
    got = (step.step_route(cfg), step.superstep_route(cfg) if tb > 1 else None)
    assert got == want
    assert resolved_backend_name(cfg) == ("pallas" if backend == "auto" else backend)


def test_stepk_k5_runs_the_stream_compute_k_times():
    """k >= 5 has no fused kernel: _local_stepk calls the stream compute k
    times (with pins between), then the remainder through the direct step."""
    cfg = config.SolverConfig(grid=config.GridConfig(shape=(6, 7, 8)), time_blocking=5)
    calls = []

    def counting(up, taps, out=None):
        calls.append(tuple(up.shape))
        return ss.apply_taps_stream(up, taps, out=out)

    solver = HeatSolver3D(cfg, device="cpu")
    run = step.make_multistep_fn(cfg, solver.taps, compute_padded=counting)
    u = solver.init_state("random")
    ref = solver.run(u.clone(), 11)
    got = run(u, 11)
    assert calls == [(16, 17, 18), (14, 15, 16), (12, 13, 14), (10, 11, 12), (8, 9, 10)] * 2
    assert torch.equal(got, ref)


def test_superstep_extent_floor():
    cfg = config.SolverConfig(grid=config.GridConfig(shape=(8, 3, 8)), time_blocking=4)
    solver = HeatSolver3D(cfg, device="cpu")
    with pytest.raises(ValueError, match="local extents >= 4"):
        solver.run(solver.init_state("hot-cube"), 4)
    # the floor belongs to the fixed-step loop: single steps still run
    solver.step(solver.init_state("hot-cube"))


@pytest.mark.parametrize("shape,tb", [((16, 16, 16), 3), ((10, 12, 14), 4), ((8, 8, 8), 1)])
def test_redundant_flops_frac_matches_reference(shape, tb):
    mine = config.SolverConfig(grid=config.GridConfig(shape=shape), time_blocking=tb)
    ref = ref_config(shape, tb=tb)
    assert step.redundant_flops_frac(mine) == ref_frac(ref)
    raw, eff = step.superstep_cell_updates(mine)
    assert eff == tb * int(np.prod(shape)) and raw >= eff


def test_exchange_path_reuses_its_padded_buffer(monkeypatch):
    monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    cfg = config.SolverConfig(grid=config.GridConfig.cube(8), time_blocking=3)
    pads = step.PadBuffers()
    run = step.make_multistep_fn(cfg, pads=pads)
    u = torch.rand((8, 8, 8))
    u = run(u, 7)  # two supersteps (width 3) and a single step (width 1)
    first = {w: b.data_ptr() for w, b in pads._bufs.items()}
    run(u, 7)
    assert set(first) == {1, 3}
    assert {w: b.data_ptr() for w, b in pads._bufs.items()} == first
