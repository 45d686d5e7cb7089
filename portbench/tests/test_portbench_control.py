"""The comparison fails the control (the program on its bfloat16-compute
path) and each fault a cell can have, with the timed path
broken underneath a whole run; the program itself passes. On the CPU at a
size a test run holds, and on the card where there is one."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import cells, run

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
GRID = (16, 16, 16)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels run only on the GPU)")
    return request.param


class Broken:
    """The program's solver with its answers broken as ``fault`` says."""

    def __init__(self, solver, fault):
        self.solver, self.fault = solver, fault

    def _break(self, u_in, u, n):
        if self.fault == "unchanged":
            return u_in
        if self.fault == "altered":
            u.view(-1)[u.numel() // 3] += 0.01 * float(u.abs().max())
        return u

    def run(self, u, n):
        u_in = u.clone()
        steps = n - 1 if self.fault == "short" else n
        return self._break(u_in, self.solver.run(u, steps), n)

    def run_to_convergence(self, u, tol, n):
        u_in = u.clone()
        steps = n - 1 if self.fault == "short" else n
        res = self.solver.run_to_convergence(u, tol, steps)
        r = 0.0 if self.fault == "unchanged" else res.residual
        return SimpleNamespace(u=self._break(u_in, res.u, n), steps=n, residual=r)


def _system(cell):
    return cells.system(cells.config(BENCH, cells.workload(BENCH, cell)["config"]))


def _measure(cell, device, make_solver=None, seed=2**31 + 7):
    w = cells.workload(BENCH, cell)
    return run.measure(BENCH, w, seed, 0.2, False, device, time.perf_counter(),
                       make_solver=make_solver, grid=GRID)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell, device):
    res = _measure(cell, device)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, device, seed):
    res = _measure(cell, device, _system(cell).control, seed)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered", "short", "faces"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, device, fault):
    solver = _system(cell).solver

    def make(c, r, d, g):
        if fault == "faces":  # the Dirichlet ghosts held at another value
            return solver(dict(c, bc_value=0.01), r, d, g)
        return Broken(solver(c, r, d, g), fault)

    res = _measure(cell, device, make)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def test_residual_gap_is_relative_to_the_residual():
    """The residual read back is held against the reference's residual,
    not against the field: an error of 1% in it fails whatever the field's
    norm."""
    from portbench import check

    want = torch.ones(4, 4, 4)
    numbers = check._numbers(want, want, 1.01 * 0.5, 0.5)
    assert numbers["residual_gap"] == pytest.approx(0.01)
    assert check._numbers(want, want, None, 0.5)["residual_gap"] != 0.0
