"""The port's OpenMP fp64 stepper (``heat3d_tpu_torch.native``) against the
JAX package's (tier-1, CPU): the same source built twice, so the two
oracles agree bitwise; both agree with NumPy at rounding-order scale."""

import os

import numpy as np
import pytest

from heat3d_tpu import native as ref_native
from heat3d_tpu.core import golden as ref_golden
from heat3d_tpu.core import config as ref_config
from heat3d_tpu_torch import native
from heat3d_tpu_torch.core import golden
from heat3d_tpu_torch.core.config import BoundaryCondition, GridConfig, StencilConfig

SHAPE = (9, 11, 13)
CASES = [
    (kind, bc, bcv)
    for kind in ("7pt", "27pt")
    for bc, bcv in (("dirichlet", 0.0), ("dirichlet", 2.5), ("periodic", 0.0))
]


def _pair(kind, bc, bcv, shape=SHAPE, spacing=(1.0, 1.0, 1.0)):
    mine = (GridConfig(shape=shape, spacing=spacing),
            StencilConfig(kind=kind, bc=BoundaryCondition(bc), bc_value=bcv))
    ref = (ref_config.GridConfig(shape=shape, spacing=spacing),
           ref_config.StencilConfig(kind=kind, bc=ref_config.BoundaryCondition(bc),
                                    bc_value=bcv))
    return mine, ref


def test_native_builds_into_the_build_directory():
    assert native.available(), native.build_error()
    so = native.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "heat3d_tpu_torch"
    assert not (so.parent.parent / "native" / "_heat3d_native.so").exists()
    with open(native._SRC) as a, open(os.path.join(os.path.dirname(ref_native.__file__),
                                                   "heat3d_native.cpp")) as b:
        # the same loop as the reference's, comment header aside
        assert a.read().split("#include", 1)[1] == b.read().split("#include", 1)[1]


@pytest.mark.parametrize("kind,bc,bcv", CASES, ids=lambda v: str(v))
def test_native_bitwise_to_jax_native(kind, bc, bcv):
    assert ref_native.available(), ref_native.build_error()
    (g, s), (rg, rs) = _pair(kind, bc, bcv)
    u0 = golden.random_init(SHAPE, seed=5).astype(np.float64)
    mine = golden.run(u0, g, s, 4, impl="native")
    ref = ref_golden.run(u0, rg, rs, 4, impl="native")
    assert mine.tobytes() == ref.tobytes()
    num = golden.run(u0, g, s, 4, impl="numpy")
    np.testing.assert_allclose(mine, num, rtol=1e-13, atol=1e-13)


def test_native_anisotropic_spacing_bitwise_to_jax():
    (g, s), (rg, rs) = _pair("7pt", "dirichlet", 0.0, (8, 8, 8), (1.0, 0.5, 2.0))
    u0 = golden.gaussian_init((8, 8, 8)).astype(np.float64)
    mine = golden.run(u0, g, s, 3, impl="native")
    assert mine.tobytes() == ref_golden.run(u0, rg, rs, 3, impl="native").tobytes()
    np.testing.assert_allclose(mine, golden.run(u0, g, s, 3, impl="numpy"),
                               rtol=1e-13, atol=1e-13)


def test_native_zero_steps_identity():
    u0 = golden.random_init((4, 4, 4), seed=1).astype(np.float64)
    out = golden.run(u0, GridConfig(shape=(4, 4, 4)), StencilConfig(), 0, impl="native")
    np.testing.assert_array_equal(out, u0)


def test_diff_sumsq_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((32, 32, 32))
    b = rng.standard_normal((32, 32, 32))
    want = float(np.sum((a - b) ** 2))
    got = native.diff_sumsq(a, b)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(ref_native.diff_sumsq(a, b), rel=1e-12)
    with pytest.raises(ValueError):
        native.diff_sumsq(a, b[:1])


def test_auto_takes_native():
    (g, s), _ = _pair("27pt", "periodic", 0.0, (8, 8, 8))
    u0 = golden.hot_cube_init((8, 8, 8)).astype(np.float64)
    auto = golden.run(u0, g, s, 5, impl="auto")
    assert auto.tobytes() == golden.run(u0, g, s, 5, impl="native").tobytes()
    np.testing.assert_allclose(auto, golden.run(u0, g, s, 5, impl="numpy"),
                               rtol=1e-13, atol=1e-13)


def test_native_raises_without_a_compiler(tmp_path, monkeypatch):
    """With g++ hidden from PATH and nothing built, ``impl='native'``
    raises with the launcher's error and ``impl='auto'`` is NumPy."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    assert "g++" in native.build_error()
    (g, s), _ = _pair("7pt", "dirichlet", 0.0, (6, 6, 6))
    u0 = golden.random_init((6, 6, 6), seed=2).astype(np.float64)
    with pytest.raises(RuntimeError, match="native stepper unavailable"):
        golden.run(u0, g, s, 2, impl="native")
    auto = golden.run(u0, g, s, 2, impl="auto")
    assert auto.tobytes() == golden.run(u0, g, s, 2, impl="numpy").tobytes()
    with pytest.raises(ValueError):
        golden.run(u0, g, s, 2, impl="fortran")
