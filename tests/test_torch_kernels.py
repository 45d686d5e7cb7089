"""The port's CUDA kernels against their plain PyTorch versions on the card,
bitwise. Marked ``cuda``: they skip on a host without a CUDA device and run
on the GPU with ``python -m pytest tests/test_torch_kernels.py -m cuda``.

Bitwise holds because the kernels evaluate the same tap chain, operation by
operation, with ``__fmul_rn``/``__fadd_rn`` (built with ``--fmad=false``),
and round to bf16 with the same round-to-nearest-even as ``Tensor.to``.
"""

import numpy as np
import pytest
import torch

from heat3d_tpu_torch.core.config import (
    BoundaryCondition, GridConfig, SolverConfig, StencilConfig,
)
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.ops import stencil_direct as sd
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded
from heat3d_tpu_torch.parallel.halo import exchange_halo

pytestmark = pytest.mark.cuda

PAIRS = [
    (sd.apply_taps_direct, sd.apply_taps_direct_ref),
    (sd.apply_taps_direct2, sd.apply_taps_direct2_ref),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


def _taps(kind):
    g = GridConfig.cube(8)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(3, 3, 3), (33, 17, 129), (40, 70, 65)])
def test_kernel_equals_plain_version(cuda, shape, kind, dtype):
    base = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    taps = _taps(kind)
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        for kernel, plain in PAIRS:
            got = kernel(u, taps, periodic, bcv)
            want = plain(u, taps, periodic, bcv)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel.__name__, periodic, bcv)


def test_launch_counts_and_out_checks(cuda):
    u = torch.rand((8, 8, 8), device=cuda)
    taps = _taps("7pt")
    sd.reset_launch_counts()
    out = torch.empty_like(u)
    assert sd.apply_taps_direct(u, taps, out=out).data_ptr() == out.data_ptr()
    sd.apply_taps_direct2(u, taps)
    assert sd.launch_counts() == {"apply_taps_direct": 1, "apply_taps_direct2": 1}
    with pytest.raises(ValueError, match="overlaps"):
        sd.apply_taps_direct(u, taps, out=u)
    with pytest.raises(ValueError, match="contiguous"):
        sd.apply_taps_direct(u.transpose(0, 2), taps)
    with pytest.raises(ValueError, match="dtype"):
        sd.apply_taps_direct(u.half(), taps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(3, 9, 67), (4, 4, 4), (33, 17, 129), (40, 70, 65)])
def test_stream_kernels_equal_plain_versions(cuda, shape, kind, dtype):
    """Includes extents of exactly max(3, k) and x-chunks cut inside the
    ghost rings (33 and 40 planes run as two chunks)."""
    base = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    u = torch.from_numpy(base).to(cuda).to(dtype)
    taps = _taps(kind)
    for periodic, bcv in ((False, 0.0), (False, 0.3), (True, 0.0)):
        bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
        up = exchange_halo(u, bc, bcv, 1)
        assert torch.equal(ss.apply_taps_stream(up, taps), apply_taps_padded(up, taps))
        for k in (k for k in ss.STREAMK_DEPTHS if k <= min(shape)):
            upk = exchange_halo(u, bc, bcv, k)
            got = ss.apply_taps_streamk(upk, taps, k, periodic, bcv)
            want = ss.apply_taps_streamk_ref(upk, taps, k, periodic, bcv)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, periodic, bcv)


@pytest.mark.parametrize("tb", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
def test_exchange_path_solve_equals_direct_solve(cuda, monkeypatch, tb, kind):
    """k steps on the exchange path (stream kernel at tb=1, streamk at
    tb=2..4) equal k direct-kernel steps bitwise."""
    def solve(time_blocking):
        cfg = SolverConfig(grid=GridConfig(shape=(24, 20, 70)),
                           stencil=StencilConfig(kind=kind, bc_value=0.3),
                           time_blocking=time_blocking)
        solver = HeatSolver3D(cfg)
        return solver.run(solver.init_state("random"), tb)

    want = solve(1)
    monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    ss.reset_launch_counts()
    got = solve(tb)
    assert ss.launch_counts()["apply_taps_stream" if tb == 1 else "apply_taps_streamk"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_stream_launch_counts_and_out_checks(cuda):
    taps = _taps("7pt")
    up = torch.rand((10, 10, 10), device=cuda)
    ss.reset_launch_counts()
    out = torch.empty((8, 8, 8), device=cuda)
    assert ss.apply_taps_stream(up, taps, out=out).data_ptr() == out.data_ptr()
    ss.apply_taps_stream2(up[:8, :8, :8].contiguous(), taps)
    ss.apply_taps_streamk(up, taps, 3)
    assert ss.launch_counts() == {"apply_taps_stream": 1, "apply_taps_streamk": 2}
    with pytest.raises(ValueError, match="out must match"):
        ss.apply_taps_stream(up, taps, out=torch.empty_like(up))
    with pytest.raises(ValueError, match="overlaps"):
        ss.apply_taps_stream(up, taps, out=up.view(-1)[: 8**3].view(8, 8, 8))
