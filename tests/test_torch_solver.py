"""The port's single-device solver (heat3d_tpu_torch.HeatSolver3D on the CPU,
where its kernels' plain versions run) against the JAX package's solver on
the same field and taps, with the JAX direct kernels in interpret mode
(HEAT3D_DIRECT_INTERPRET=1, as tests/test_pallas_direct.py runs them), and
both against the fp64 golden oracle.

Tolerances: port vs JAX and each vs the golden oracle, ``rtol=1e-5,
atol=1e-6`` for float32 storage (the tests/test_solver.py tier: a few
float32 ulps per update over a handful of updates); run_to_convergence
takes the same number of steps and its residual agrees to ``rtol=1e-5``.
"""

import numpy as np
import pytest
import torch

import heat3d_tpu.core.config as ref_config
from heat3d_tpu import eqn as ref_eqn
from heat3d_tpu.core import golden as ref_golden
from heat3d_tpu.models.heat3d import HeatSolver3D as RefSolver
from heat3d_tpu_torch import carry
from heat3d_tpu_torch.core import config
from heat3d_tpu_torch.models.heat3d import HeatSolver3D

SHAPE = (10, 12, 14)


def _configs(kind="7pt", periodic=False, bc_value=0.0, tb=1, storage="float32",
             residual_every=0):
    def build(m):
        bc = m.BoundaryCondition.PERIODIC if periodic else m.BoundaryCondition.DIRICHLET
        return m.SolverConfig(
            grid=m.GridConfig(shape=SHAPE),
            stencil=m.StencilConfig(kind=kind, bc=bc, bc_value=bc_value),
            mesh=m.MeshConfig(shape=(1, 1, 1)),
            precision=m.Precision(storage=storage),
            run=m.RunConfig(residual_every=residual_every, seed=2),
            backend="auto",
            time_blocking=tb,
        )

    return build(config), build(ref_config)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("HEAT3D_DIRECT_INTERPRET", "1")


def _pair(mine_cfg, ref_cfg, init="random"):
    """Both solvers, and the JAX solver's initial field and taps carried
    over to the port."""
    ref = RefSolver(ref_cfg)
    u_ref = ref.init_state(init)
    taps = carry.taps_from_reference(ref_eqn.solver_taps(ref_cfg))
    mine = HeatSolver3D(mine_cfg, device="cpu", taps=taps)
    u = carry.state_from_reference(ref.gather(u_ref), mine_cfg, "cpu")
    return ref, u_ref, mine, u


def _golden(ref_cfg, init, steps):
    u0 = ref_golden.make_init(init, SHAPE, seed=ref_cfg.run.seed)
    return ref_golden.run(u0, ref_cfg.grid, ref_cfg.stencil, steps, impl="numpy",
                          taps=ref_eqn.solver_taps(ref_cfg))


@pytest.mark.parametrize(
    "kind,periodic,bc_value,tb,steps",
    [
        ("7pt", False, 0.0, 1, 5),
        ("7pt", False, 0.3, 2, 5),
        ("7pt", True, 0.0, 2, 7),
        ("27pt", False, 0.3, 1, 3),
        ("27pt", True, 0.0, 2, 5),
        ("27pt", False, 0.0, 2, 6),
    ],
)
def test_run_matches_reference_and_golden(interpret, kind, periodic, bc_value, tb, steps):
    mine_cfg, ref_cfg = _configs(kind, periodic, bc_value, tb)
    ref, u_ref, mine, u = _pair(mine_cfg, ref_cfg)
    want = ref.gather(ref.run(u_ref, steps))
    got = mine.gather(mine.run(u, steps))
    assert got.shape == SHAPE and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    g = _golden(ref_cfg, "random", steps)
    np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want, g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("every", [1, 3])
def test_run_to_convergence_matches_reference(interpret, every):
    mine_cfg, ref_cfg = _configs("7pt", False, 0.0, 2, residual_every=every)
    ref, u_ref, mine, u = _pair(mine_cfg, ref_cfg, init="gaussian")
    tol, max_steps = 2e-2, 60
    want = ref.run_to_convergence(u_ref, tol=tol, max_steps=max_steps)
    got = mine.run_to_convergence(u, tol=tol, max_steps=max_steps)
    assert 1 < got.steps < max_steps
    assert got.steps == want.steps
    assert got.residual == pytest.approx(want.residual, rel=1e-5)
    np.testing.assert_allclose(mine.gather(got.u), ref.gather(want.u), rtol=1e-5, atol=1e-6)


def test_step_with_residual_and_hot_cube(interpret):
    mine_cfg, ref_cfg = _configs("27pt", False, 0.0, 1)
    ref = RefSolver(ref_cfg)
    mine = HeatSolver3D(mine_cfg, device="cpu")
    u_ref, u = ref.init_state("hot-cube"), mine.init_state("hot-cube")
    # the port builds hot-cube on the device: byte-equal to the reference's
    assert mine.gather(u).tobytes() == ref.gather(u_ref).tobytes()
    w_ref, r2_ref = ref.step_with_residual(u_ref)
    w, r2 = mine.step_with_residual(u)
    assert r2.dtype == torch.float32
    assert float(r2) == pytest.approx(float(r2_ref), rel=1e-5)
    np.testing.assert_allclose(mine.gather(w), ref.gather(w_ref), rtol=1e-5, atol=1e-6)


def test_bf16_storage_matches_reference(interpret):
    mine_cfg, ref_cfg = _configs("7pt", False, 0.3, 2, storage="bfloat16")
    ref, u_ref, mine, u = _pair(mine_cfg, ref_cfg)
    assert u.dtype == torch.bfloat16
    steps = 3
    want = np.asarray(ref.gather(ref.run(u_ref, steps)), dtype=np.float32)
    got = mine.gather(mine.run(u, steps))
    # a float32 ulp can flip a bf16 rounding, and a flipped cell feeds its
    # neighbours through taps summing to one: one bf16 ulp of the field's
    # largest value per update
    bound = steps * 2.0**-7 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound


def test_pingpong_reuses_buffers():
    mine_cfg, _ = _configs("7pt", False, 0.0, 2)
    mine = HeatSolver3D(mine_cfg, device="cpu")
    u = mine.init_state("random")
    ptrs = {u.data_ptr()}
    for steps in (4, 5, 1, 2, 3):
        u = mine.run(u, steps)
        ptrs.add(u.data_ptr())
    # the loops alternate between the input and one spare buffer
    assert len(ptrs) == 2
    assert mine.run(u, 0) is u
    arr = np.ones(SHAPE, np.float32)
    mine.run(mine.init_state(arr), 3)
    assert (arr == 1).all()  # the caller's array is not consumed


def test_superstep_extent_check():
    cfg = config.SolverConfig(grid=config.GridConfig(shape=(2, 8, 8)), time_blocking=2)
    solver = HeatSolver3D(cfg, device="cpu")
    with pytest.raises(ValueError, match="local extents >= 3"):
        solver.run(solver.init_state("hot-cube"), 2)


def test_carry_rejects_wrong_shapes():
    mine_cfg, _ = _configs()
    with pytest.raises(ValueError):
        carry.taps_from_reference(np.zeros((3, 3)))
    with pytest.raises(ValueError):
        carry.state_from_reference(np.zeros((4, 4, 4), np.float32), mine_cfg, "cpu")


def test_cli_golden_check_on_cpu(capsys):
    import json

    from heat3d_tpu_torch import cli

    rc = cli.main(["--grid", "12", "--steps", "5", "--stencil", "27pt",
                   "--time-blocking", "2", "--golden-check", "--device", "cpu",
                   "--residual-every", "2"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["golden_pass"] and summary["steps"] == 5
    assert summary["platform"] == "cpu" and summary["residual_l2"] > 0
    assert summary["gcell_updates_per_sec"] is None  # no device rate from a CPU run
