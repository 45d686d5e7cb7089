"""The port's direct-stencil contract (heat3d_tpu_torch.ops.stencil_direct)
against the JAX package's Pallas direct kernels run in interpret mode.

On the CPU the wrappers run their kernels' plain versions (ghost pad + the
``accumulate_taps`` chain, once or twice), so these tests hold the
arithmetic the CUDA kernels must reproduce (bitwise, on the card:
tests/test_torch_kernels.py) to the TPU kernels' own semantics: ghost
synthesis, bc_value rounded to the storage dtype, the tb=2 intermediate
rounded to storage and pinned to bc outside the domain.

The tolerance is stated in tests/torch_port_checks.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat3d_tpu.ops.stencil_pallas_direct as ref_direct
from heat3d_tpu_torch.core.config import BoundaryCondition
from heat3d_tpu_torch.ops import stencil_direct as sd
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded, pad_local, residual_sumsq
from torch_port_checks import BCS, DTYPES, GENERIC_KINDS, _check_pair, _taps, generic_chain


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind", ["7pt", "27pt", *GENERIC_KINDS])
@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 16, 24), (5, 8, 130)])
def test_direct_matches_pallas_interpret(shape, kind, dtype, monkeypatch):
    """The 7pt and 27pt chains through apply_taps_direct; each program of
    ``GENERIC_KINDS`` (the card's generic instance: the direct wrapper
    picks it for them) through both apply_taps_direct and
    apply_taps_direct2, against the JAX kernels, which trace the chain of
    the same taps under the same knobs."""
    if kind in ("7pt", "27pt"):
        _check_pair(sd.apply_taps_direct, ref_direct.apply_taps_direct, shape, kind, dtype, 1, 1)
        return
    knobs, taps = generic_chain(kind, shape)
    for key, value in knobs.items():
        monkeypatch.setenv(key, value)
    assert sd.direct_instance(taps) == ss.GENERIC
    for kernel, ref_kernel, updates in ((sd.apply_taps_direct, ref_direct.apply_taps_direct, 1),
                                        (sd.apply_taps_direct2, ref_direct.apply_taps_direct2, 2)):
        _check_pair(kernel, ref_kernel, shape, kind, dtype, 1, updates, taps=taps)


def test_out_buffer_and_plain_versions():
    shape = (5, 6, 7)
    taps = _taps("27pt", shape)
    u = torch.from_numpy(np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    out = torch.empty_like(u)
    got = sd.apply_taps_direct(u, taps, False, 0.25, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, sd.apply_taps_direct_ref(u, taps, False, 0.25))
    got2 = sd.apply_taps_direct2(u, taps, True, 0.0, out=torch.empty_like(u))
    once = sd.apply_taps_direct(u, taps, True, 0.0)
    assert torch.equal(got2, sd.apply_taps_direct(once, taps, True, 0.0))


def test_cpu_path_does_not_count_launches():
    shape = (4, 4, 4)
    taps = _taps("7pt", shape)
    before = sd.launch_counts()
    sd.apply_taps_direct2(sd.apply_taps_direct(torch.zeros(shape), taps), taps)
    assert sd.launch_counts() == before


def test_mehrstellen_route_raises(monkeypatch):
    """The Mehrstellen route, which the port refused before its kernel
    instance existed, now runs: under ``HEAT3D_MEHRSTELLEN`` the direct
    wrappers equal their plain versions, which take the Mehrstellen update
    (``apply_taps_padded(mehrstellen=True)``, once or twice with the
    storage round trip and the pin between), not the tap chain; Dirichlet
    bc 0 and 0.3 and periodic."""
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    shape = (6, 9, 11)
    taps = _taps("27pt", shape)
    u = torch.from_numpy(np.random.default_rng(5).standard_normal(shape).astype(np.float32))
    for periodic, bcv in BCS:
        bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
        once = apply_taps_padded(pad_local(u, bc, bcv), taps, mehrstellen=True)
        got = sd.apply_taps_direct(u, taps, periodic, bcv)
        assert torch.equal(got, once), (periodic, bcv)
        assert torch.equal(got, sd.apply_taps_direct_ref(u, taps, periodic, bcv))
        assert not torch.equal(once, apply_taps_padded(pad_local(u, bc, bcv), taps,
                                                       mehrstellen=False))
        twice = sd.apply_taps_direct(once, taps, periodic, bcv)
        assert torch.equal(sd.apply_taps_direct2(u, taps, periodic, bcv), twice)
        assert torch.equal(sd.apply_taps_direct2_ref(u, taps, periodic, bcv), twice)


def test_emission_program_follows_factoring_knobs(monkeypatch):
    taps = _taps("27pt", (8, 8, 8))
    factored = sd.emission_program(taps)
    assert len(factored) == 12 and factored[0][0] == 3
    monkeypatch.setenv("HEAT3D_FACTOR_Y", "0")
    assert len(sd.emission_program(taps)) == 18
    monkeypatch.delenv("HEAT3D_FACTOR_Y")
    taps7 = _taps("7pt", (8, 8, 8))
    assert {s for s, _, _, _ in sd.emission_program(taps7)} == {0, 1, 2}
    monkeypatch.setenv("HEAT3D_FACTOR_7PT", "1")
    assert 3 in {s for s, _, _, _ in sd.emission_program(taps7)}


def test_residual_sumsq_matches_reference():
    from heat3d_tpu.ops.stencil_jnp import residual_sumsq as ref_residual

    rng = np.random.default_rng(11)
    a, b = (rng.standard_normal((6, 7, 8)).astype(np.float32) for _ in range(2))
    want = float(ref_residual(jnp.asarray(a), jnp.asarray(b)))
    got = float(residual_sumsq(torch.from_numpy(a), torch.from_numpy(b)))
    # different summation order: fp32 rounding of a 336-term sum
    assert got == pytest.approx(want, rel=1e-5)
