"""The loop to a tolerance: ``HeatSolver3D.run_to_convergence(u, tol, n)``,
the command line's ``--tol``, which reads the residual back as the mix's
``run.residual_every`` says (1, its default, after every update). With
``tol`` 0 it never converges: a chunk samples the steady phase of a long
solve."""

PARAMS = {"tol"}
RESIDUAL = True


def chunk(solver, u, n, params):
    res = solver.run_to_convergence(u, float(params["tol"]), n)
    return res.u, res.steps, res.residual
