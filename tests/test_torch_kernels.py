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

from heat3d_tpu_torch.core.config import GridConfig
from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps
from heat3d_tpu_torch.ops import stencil_direct as sd

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
