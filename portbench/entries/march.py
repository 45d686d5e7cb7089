"""Fixed updates, no residual: ``HeatSolver3D.run(u, n)``, the command
line's ``--steps N``."""

PARAMS = set()
RESIDUAL = False


def chunk(solver, u, n, params):
    return solver.run(u, n), n, None
