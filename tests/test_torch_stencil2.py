"""The port's fused two-update contract (``apply_taps_direct2``) against the
JAX package's Pallas kernel in interpret mode, and both kernels against the
JAX kernels forced to several y-chunks. The tolerance is stated in
tests/torch_port_checks.py."""

import pytest

import heat3d_tpu.ops.stencil_pallas_direct as ref_direct
from heat3d_tpu_torch.ops import stencil_direct as sd
from torch_port_checks import DTYPES, _check_pair


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 16, 24), (5, 8, 130)])
def test_direct2_matches_pallas_interpret(shape, kind, dtype):
    _check_pair(sd.apply_taps_direct2, ref_direct.apply_taps_direct2, shape, kind, dtype, 2, 2)


@pytest.mark.parametrize("kind", ["7pt", "27pt"])
def test_multichunk_matches_pallas_interpret(kind, monkeypatch):
    """The JAX kernels forced to two y-chunks (ny=16, by=8), so their
    ghost-row blocks and the tb=2 edge-chunk pinning are what the port is
    held to."""
    monkeypatch.setattr(ref_direct, "choose_chunk", lambda *a, **k: 8)
    for kernel, ref_kernel, updates in (
        (sd.apply_taps_direct, ref_direct.apply_taps_direct, 1),
        (sd.apply_taps_direct2, ref_direct.apply_taps_direct2, 2),
    ):
        _check_pair(kernel, ref_kernel, (6, 16, 32), kind, DTYPES[0], 9, updates)
