"""Shared helpers of the port's stencil tests (tests/test_torch_stencil*.py,
tests/test_torch_stream.py, tests/test_torch_stepk.py): the same inputs for
both packages, the JAX package's (1,1,1)-mesh config and shard_map, and the
stated tolerance.

Tolerance: not bitwise. XLA's CPU backend contracts some multiply-adds of
the chain into FMAs, eager PyTorch rounds each operation, so the two differ
by an ulp or two of float32. Per update: float32 storage within
``rtol=1e-6, atol=1e-7`` (the tests/test_solver.py tier); bf16 storage
within one bf16 ulp of the value (a float32 ulp can flip the final
rounding) plus the float32 ``atol``. A kernel of k fused updates (direct2,
streamk) gets k times that budget, and under bf16 k-1 bf16 ulps of the
field's largest value more: an intermediate cell rounded the other way
reaches its neighbours through taps whose weights sum to one. The byte
movers (the halo exchange) are held byte-equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from heat3d_tpu.core.config import GridConfig
from heat3d_tpu.core.stencils import STENCILS, stencil_taps

BCS = [(False, 0.0), (False, 0.3), (True, 0.0)]
DTYPES = [("float32", torch.float32, jnp.float32), ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def _taps(kind, shape):
    g = GridConfig(shape=shape)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


def _field(shape, seed, jdtype):
    """The same values for both packages: float32 from numpy, rounded to
    the storage dtype by JAX, then handed to torch as float32 (exact)."""
    base = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ju = jnp.asarray(base).astype(jdtype)
    tu = torch.from_numpy(np.array(ju.astype(jnp.float32)))
    return ju, tu


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def assert_close_per_update(got: np.ndarray, want: np.ndarray, storage: str,
                            updates: int, err_msg: str = "") -> None:
    """The module's tolerance (see the module docstring)."""
    if storage == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6 * updates,
                                   atol=1e-7 * updates, err_msg=err_msg)
        return

    def bf16_ulp(x):
        return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)

    tol = (updates * (bf16_ulp(want) + 1e-7)
           + (updates - 1) * bf16_ulp(np.abs(want).max()))
    excess = np.abs(got - want) - tol
    assert excess.max() <= 0, f"{err_msg}: {excess.max()} beyond tolerance"


def ref_config(shape, kind="7pt", periodic=False, bc_value=0.0, tb=1):
    """A JAX-package SolverConfig of one (1,1,1)-mesh block."""
    from heat3d_tpu.core import config as rc

    bc = rc.BoundaryCondition.PERIODIC if periodic else rc.BoundaryCondition.DIRICHLET
    return rc.SolverConfig(
        grid=rc.GridConfig(shape=shape),
        stencil=rc.StencilConfig(kind=kind, bc=bc, bc_value=bc_value),
        mesh=rc.MeshConfig(shape=(1, 1, 1)),
        backend="jnp",
        time_blocking=tb,
    )


def on_mesh(fn, cfg, *args):
    """``fn(*args)`` inside ``shard_map`` over the (1,1,1) mesh of ``cfg``:
    the JAX exchange and the streamk kernels read the mesh axes."""
    from jax.sharding import PartitionSpec as P

    from heat3d_tpu.parallel.topology import build_mesh
    from heat3d_tpu.utils.compat import shard_map

    spec = P(*cfg.mesh.axis_names)
    return shard_map(fn, mesh=build_mesh(cfg.mesh), in_specs=spec,
                     out_specs=spec, check_vma=False)(*args)


def _check_pair(kernel, ref_kernel, shape, kind, dtype, seed, updates):
    storage, tdtype, jdtype = dtype
    taps = _taps(kind, shape)
    ju, tu = _field(shape, seed, jdtype)
    tu = tu.to(tdtype)
    for periodic, bcv in BCS:
        want = ref_kernel(ju, taps, periodic=periodic, bc_value=bcv, interpret=True)
        got = kernel(tu, taps, periodic, bcv)
        assert got.dtype == tdtype and tuple(got.shape) == shape
        assert_close_per_update(
            _as_np(got), np.asarray(want.astype(jnp.float32)), storage, updates,
            err_msg=f"{shape} {kind} {storage} periodic={periodic} bc={bcv}",
        )
