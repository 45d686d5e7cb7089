"""Shared helpers of the port's direct-stencil tests
(tests/test_torch_stencil*.py): the same inputs for both packages and the
stated tolerance.

Tolerance: not bitwise. XLA's CPU backend contracts some multiply-adds of
the chain into FMAs, eager PyTorch rounds each operation, so the two differ
by an ulp or two of float32. Per update: float32 storage within
``rtol=1e-6, atol=1e-7`` (the tests/test_solver.py tier); bf16 storage
within one bf16 ulp of the value (a float32 ulp can flip the final
rounding) plus the float32 ``atol``. The tb=2 kernel applies two updates,
so its budget is twice that, and under bf16 one bf16 ulp of the field's
largest value more: an intermediate cell rounded the other way reaches its
neighbours through taps whose weights sum to one.
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
