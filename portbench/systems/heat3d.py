"""The heat solver of heat3d_tpu_torch, ``HeatSolver3D``, on one GPU's
block: explicit-Euler diffusion with Dirichlet faces.

Every key of a configuration file is either the benchmark's own
(``META``) or consumed here; any other key is refused, so a configuration
meant for another equation, integrator or placement never runs this one
quietly.
"""

from __future__ import annotations

from portbench.reference.heat import Reference

# the benchmark's own keys of a configuration file
META = {"name", "source", "deployment", "source_values", "reduced", "assumed", "system"}
# the keys this module builds the program's SolverConfig from
KEYS = {"grid", "spacing", "alpha", "dt", "stencil", "bc", "bc_value", "mesh", "storage",
        "compute", "residual", "backend", "time_blocking"}


def _check_keys(config: dict) -> None:
    extra = sorted(set(config) - META - KEYS)
    if extra:
        raise ValueError(f"configuration {config.get('name')!r}: keys {extra} are not "
                         f"consumed by portbench/systems/heat3d.py")
    missing = sorted(KEYS - set(config))
    if missing:
        raise ValueError(f"configuration {config.get('name')!r} lacks {missing}")
    if tuple(config["mesh"]) != (1, 1, 1):
        raise ValueError("portbench/systems/heat3d.py runs one GPU's block, mesh (1,1,1); "
                         f"got {config['mesh']}")


def solver_config(config: dict, run: dict, grid=None):
    """The program's ``SolverConfig``: every key of ``config`` outside
    ``META``, and ``run`` as its ``RunConfig``."""
    from heat3d_tpu_torch.core.config import (
        BoundaryCondition, GridConfig, MeshConfig, Precision, RunConfig, SolverConfig,
        StencilConfig)

    _check_keys(config)
    return SolverConfig(
        grid=GridConfig(shape=tuple(grid or config["grid"]), spacing=tuple(config["spacing"]),
                        alpha=config["alpha"], dt=config["dt"]),
        stencil=StencilConfig(kind=config["stencil"], bc=BoundaryCondition(config["bc"]),
                              bc_value=config["bc_value"]),
        mesh=MeshConfig(shape=tuple(config["mesh"])),
        precision=Precision(storage=config["storage"], compute=config["compute"],
                            residual=config["residual"]),
        run=RunConfig(**run),
        backend=config["backend"],
        time_blocking=int(config["time_blocking"]),
    )


def solver(config: dict, run: dict, device: str, grid=None):
    """``HeatSolver3D`` on the default placement (shard 0 on ``cuda:0``),
    or on ``device`` where it is not CUDA (the tests drive the plain
    versions on the CPU)."""
    from heat3d_tpu_torch.models.heat3d import HeatSolver3D

    return HeatSolver3D(solver_config(config, run, grid),
                        device=None if device == "cuda" else device)


def control(config: dict, run: dict, device: str, grid=None):
    """The program on its own bfloat16-compute path (``Precision.compute``,
    the command line's ``--compute-dtype bf16``), one precision below the
    configurations' float32, with the field still stored as they state."""
    return solver(dict(config, compute="bfloat16"), run, device, grid)


def reference(config: dict, device, shape):
    _check_keys(dict(config, grid=list(shape)))
    return Reference(config, device, shape=shape)


def state(solver, u):
    """One block: the field is the program's state."""
    return u


def field(solver, u):
    return u
