"""The port's copied core (heat3d_tpu_torch.core / .eqn) against the JAX
package's: byte-equal taps, byte-equal initial fields, the same fp64 golden
step, and the config scope check of the port."""

import dataclasses

import numpy as np
import pytest

from heat3d_tpu import eqn as ref_eqn
from heat3d_tpu.core import config as ref_config
from heat3d_tpu.core import decomposition as ref_decomp
from heat3d_tpu.core import golden as ref_golden
from heat3d_tpu_torch import eqn
from heat3d_tpu_torch.core import config, decomposition, golden
from heat3d_tpu_torch.core.stencils import effective_num_taps


def _cfg_pair(kind, alpha, dt, spacing, shape=(8, 8, 8)):
    def build(m):
        return m.SolverConfig(
            grid=m.GridConfig(shape=shape, spacing=spacing, alpha=alpha, dt=dt),
            stencil=m.StencilConfig(kind=kind),
        )

    return build(config), build(ref_config)


@pytest.mark.parametrize(
    "kind,alpha,dt,spacing",
    [
        ("7pt", 1.0, None, (1.0, 1.0, 1.0)),
        ("7pt", 0.37, 0.011, (0.5, 1.0, 2.0)),
        ("7pt", 2.5, None, (0.1, 0.2, 0.3)),
        ("27pt", 1.0, None, (1.0, 1.0, 1.0)),
        ("27pt", 0.8, 0.03, (0.7, 0.7, 0.7)),
        ("27pt", 3.0, None, (0.25, 0.25, 0.25)),
    ],
)
def test_solver_taps_byte_equal(kind, alpha, dt, spacing):
    mine, ref = _cfg_pair(kind, alpha, dt, spacing)
    a = eqn.solver_taps(mine)
    b = ref_eqn.solver_taps(ref)
    assert a.dtype == b.dtype == np.float64
    assert a.tobytes() == b.tobytes()
    assert effective_num_taps(a) in (7, 15)


@pytest.mark.parametrize("name", ["hot-cube", "gaussian", "random"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 9, 13)])
def test_make_init_block_byte_equal(name, shape):
    full = tuple(slice(0, n) for n in shape)
    part = (slice(1, 4), slice(2, shape[1]), slice(0, 3))
    for index in (full, part):
        a = golden.make_init_block(name, shape, index, seed=3)
        b = ref_golden.make_init_block(name, shape, index, seed=3)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_golden_step_and_run_equal():
    u = np.random.default_rng(5).standard_normal((6, 7, 8))
    for kind in ("7pt", "27pt"):
        mine, ref = _cfg_pair(kind, 1.0, None, (1.0, 1.0, 1.0), (6, 7, 8))
        taps = eqn.solver_taps(mine)
        for bc in config.BoundaryCondition:
            st = config.StencilConfig(kind=kind, bc=bc, bc_value=0.4)
            rst = ref_config.StencilConfig(
                kind=kind, bc=ref_config.BoundaryCondition(bc.value), bc_value=0.4
            )
            a = golden.run(u, mine.grid, st, 3, taps=taps)
            b = ref_golden.run(u, ref.grid, rst, 3, impl="numpy", taps=taps)
            assert a.tobytes() == b.tobytes()


def test_decomposition_equal():
    for shape, mesh in (((10, 7, 9), (3, 2, 2)), ((16, 16, 16), (2, 2, 2))):
        a = decomposition.all_subdomains(shape, mesh)
        b = ref_decomp.all_subdomains(shape, mesh)
        assert [dataclasses.astuple(s) for s in a] == [
            dataclasses.astuple(s) for s in b
        ]


@pytest.mark.parametrize(
    "kw,needle",
    [
        (dict(halo="auto"), "halo='auto'"),
        (dict(halo="dma", overlap=True, mesh=config.MeshConfig(shape=(2, 1, 1)),
              time_blocking=0), "time_blocking=0 (auto)"),
        (dict(overlap=True, halo_order="pairwise"), "halo_order='pairwise'"),
        (dict(fused_rdma="auto"), "fused_rdma='auto'"),
        (dict(halo_plan="auto"), "halo_plan='auto'"),
        (dict(halo_order="pairwise"), "halo_order='pairwise'"),
        (dict(time_blocking=0), "time_blocking=0 (auto)"),
        (dict(integrator="implicit-cg"), "integrator='implicit-cg'"),
        (dict(integrator="leapfrog", equation="wave"), "integrator='leapfrog'"),
        (dict(precision=config.Precision(compute="float16")), "compute dtype"),
    ],
)
def test_config_rejects_unported(kw, needle):
    with pytest.raises(ValueError) as ei:
        config.SolverConfig(grid=config.GridConfig.cube(8), **kw)
    msg = str(ei.value)
    assert "not ported yet" in msg and needle in msg


def test_config_accepts_slice_scope():
    for tb in (1, 2, 3, 4, 5):
        for storage in ("float32", "bfloat16"):
            for compute in ("float32", "bfloat16"):
                for kind in ("7pt", "27pt"):
                    for backend in ("auto", "pallas", "jnp", "conv"):
                        config.SolverConfig(
                            grid=config.GridConfig.cube(8),
                            stencil=config.StencilConfig(kind=kind),
                            precision=config.Precision(storage=storage, compute=compute),
                            time_blocking=tb,
                            backend=backend,
                        )
    # any mesh, both transports, and uneven Dirichlet grids (bc-padded)
    for mesh in ((2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2), (3, 1, 4)):
        for halo in ("ppermute", "dma"):
            for shape in ((12, 12, 12), (13, 10, 9)):
                for compute in ("float32", "bfloat16"):
                    cfg = config.SolverConfig(
                        grid=config.GridConfig(shape=shape),
                        mesh=config.MeshConfig(shape=mesh), halo=halo,
                        precision=config.Precision(compute=compute),
                    )
                    assert cfg.is_padded == any(g % p for g, p in zip(shape, mesh))
    # the overlap routes' knobs
    for kw in (dict(overlap=True), dict(overlap=True, halo="dma"),
               dict(fused_rdma="on"), dict(fused_rdma="on", halo_plan="partitioned"),
               dict(halo_plan="partitioned")):
        for storage in ("float32", "bfloat16"):
            for compute in ("float32", "bfloat16"):
                config.SolverConfig(grid=config.GridConfig.cube(8),
                                    mesh=config.MeshConfig(shape=(2, 1, 1)),
                                    precision=config.Precision(storage=storage,
                                                               compute=compute), **kw)
    with pytest.raises(ValueError, match="not divisible"):
        config.SolverConfig(
            grid=config.GridConfig(shape=(13, 12, 12)),
            stencil=config.StencilConfig(bc=config.BoundaryCondition.PERIODIC),
            mesh=config.MeshConfig(shape=(2, 1, 1)),
        )
