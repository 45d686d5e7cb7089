"""The port's exchange path against the JAX package's, on the CPU: the halo
exchange (``heat3d_tpu_torch.parallel.halo``) byte-equal to the JAX
``exchange`` under ``shard_map`` on a (1,1,1) mesh; the stream kernel's
contract (``apply_taps_stream``) and the two-update form of streamk
(``apply_taps_stream2``) against the JAX Pallas kernels in interpret mode;
the streamk plain version bitwise against k direct plain updates; and the
``conv`` arm against the JAX conv arm.

On the CPU the wrappers run their kernels' plain versions, so these tests
hold the arithmetic the CUDA kernels must reproduce (bitwise, on the card:
tests/test_torch_kernels.py). The tolerance is stated in
tests/torch_port_checks.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heat3d_tpu.ops import stencil_pallas as ref_pallas
from heat3d_tpu.ops.stencil_jnp import apply_taps_conv_padded as ref_conv
from heat3d_tpu.parallel.step import exchange as ref_exchange
from heat3d_tpu_torch.core.config import BoundaryCondition
from heat3d_tpu_torch.ops import stencil_direct as sd
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_conv_padded
from heat3d_tpu_torch.parallel.halo import exchange_halo
from torch_port_checks import (
    BCS,
    DTYPES,
    _as_np,
    _field,
    _taps,
    assert_close_per_update,
    on_mesh,
    ref_config,
)


def _bc(periodic):
    return BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET


def _bytes(a) -> bytes:
    """Raw storage bytes of a JAX array or torch tensor (bf16 included)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().tobytes()
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("periodic,bcv", BCS, ids=["dir0", "dir0.3", "periodic"])
@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_exchange_byte_equal_to_jax(width, periodic, bcv, dtype):
    storage, tdtype, jdtype = dtype
    shape = (4, 5, 7)
    ju, tu = _field(shape, 21 + width, jdtype)
    cfg = ref_config(shape, periodic=periodic, bc_value=bcv, tb=max(1, width))
    want = on_mesh(lambda x: ref_exchange(x, cfg, width=width), cfg, ju)
    got = exchange_halo(tu.to(tdtype), _bc(periodic), bcv, width)
    assert tuple(got.shape) == tuple(want.shape) == tuple(n + 2 * width for n in shape)
    assert got.dtype == tdtype
    assert _bytes(got) == _bytes(want)


def test_exchange_into_buffer_and_checks():
    u = torch.arange(60, dtype=torch.float32).reshape(3, 4, 5)
    buf = torch.full((7, 8, 9), float("nan"))
    got = exchange_halo(u, BoundaryCondition.PERIODIC, 0.0, 2, out=buf)
    assert got.data_ptr() == buf.data_ptr() and not torch.isnan(buf).any()
    # a periodic exchange is the global wrap pad
    idx = [torch.arange(-2, n + 2) % n for n in u.shape]
    assert torch.equal(got, u[idx[0]][:, idx[1]][:, :, idx[2]])
    with pytest.raises(ValueError, match="exceeds local extent 3 on axis 0"):
        exchange_halo(u, BoundaryCondition.DIRICHLET, 0.0, 4)
    with pytest.raises(ValueError, match="padded buffer"):
        exchange_halo(u, BoundaryCondition.DIRICHLET, 0.0, 1, out=buf)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 9, 13)])
def test_stream_matches_pallas_interpret(shape, kind, dtype):
    storage, tdtype, jdtype = dtype
    taps = _taps(kind, shape)
    jup, tup = _field(tuple(n + 2 for n in shape), 5, jdtype)
    want = ref_pallas.apply_taps_pallas(jup, taps, compute_dtype=jnp.float32,
                                        out_dtype=jdtype, interpret=True)
    got = ss.apply_taps_stream(tup.to(tdtype), taps)
    assert got.dtype == tdtype and tuple(got.shape) == shape
    assert_close_per_update(_as_np(got), np.asarray(want.astype(jnp.float32)),
                            storage, 1, err_msg=f"{shape} {kind} {storage}")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
def test_stream2_matches_pallas_interpret(kind, dtype):
    storage, tdtype, jdtype = dtype
    shape = (6, 7, 9)
    taps = _taps(kind, shape)
    ju, tu = _field(shape, 8, jdtype)
    for periodic, bcv in BCS:
        cfg = ref_config(shape, kind, periodic, bcv, tb=2)
        want = on_mesh(
            lambda x: ref_pallas.apply_taps_pallas_stream2(
                ref_exchange(x, cfg, width=2), taps, cfg.mesh.axis_names,
                periodic=periodic, bc_value=bcv, interpret=True),
            cfg, ju)
        up2 = exchange_halo(tu.to(tdtype), _bc(periodic), bcv, 2)
        got = ss.apply_taps_stream2(up2, taps, periodic, bcv)
        assert got.dtype == tdtype
        assert_close_per_update(
            _as_np(got), np.asarray(want.astype(jnp.float32)), storage, 2,
            err_msg=f"{kind} {storage} periodic={periodic} bc={bcv}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_streamk_plain_equals_k_direct_updates_bitwise(k, kind, dtype):
    """The streamk plain version over a width-k exchange is k plain direct
    updates, bitwise: ring cells hold what the unfused sequence sees.
    Shapes include an extent of exactly max(3, k)."""
    for shape in ((max(3, k), 6, 9), (7, max(3, k), 5)):
        taps = _taps(kind, shape)
        u = torch.from_numpy(
            np.random.default_rng(k).standard_normal(shape).astype(np.float32)
        ).to(dtype)
        for periodic, bcv in BCS:
            want = u
            for _ in range(k):
                want = sd.apply_taps_direct_ref(want, taps, periodic, bcv)
            upk = exchange_halo(u, _bc(periodic), bcv, k)
            got = ss.apply_taps_streamk(upk, taps, k, periodic, bcv)
            assert torch.equal(got, want), (shape, periodic, bcv)


def test_streamk_wrapper_checks_and_cpu_counts():
    taps = _taps("7pt", (4, 4, 4))
    up = torch.zeros((8, 8, 8))
    before = ss.launch_counts()
    out = torch.empty((4, 4, 4))
    assert ss.apply_taps_streamk(up, taps, 2, out=out).data_ptr() == out.data_ptr()
    assert tuple(ss.apply_taps_stream(up, taps).shape) == (6, 6, 6)
    assert ss.launch_counts() == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="wants k in"):
        ss.apply_taps_streamk(up, taps, 5)
    with pytest.raises(ValueError, match="no interior"):
        ss.apply_taps_streamk(torch.zeros((8, 8, 7)), taps, 4)


def test_mehrstellen_route_raises(monkeypatch):
    """Under ``HEAT3D_MEHRSTELLEN`` the stream and streamk wrappers, which
    refused the knob before, run the tap chain, as the JAX windowed
    stream/streamk kernels do (they have no Mehrstellen form): equal to
    the JAX kernels in interpret mode under the knob, and bitwise to the
    wrappers with the knob off; fp32 and bf16 storage."""
    shape = (6, 7, 9)
    taps = _taps("27pt", shape)
    for storage, tdtype, jdtype in DTYPES:
        jup, tup = _field(tuple(n + 2 for n in shape), 6, jdtype)
        ju, tu = _field(shape, 7, jdtype)
        up2 = {bc: exchange_halo(tu.to(tdtype), _bc(bc[0]), bc[1], 2) for bc in BCS}
        monkeypatch.delenv("HEAT3D_MEHRSTELLEN", raising=False)
        off = [ss.apply_taps_stream(tup.to(tdtype), taps)]
        off += [ss.apply_taps_streamk(up2[bc], taps, 2, *bc) for bc in BCS]
        monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
        want = ref_pallas.apply_taps_pallas(jup, taps, compute_dtype=jnp.float32,
                                            out_dtype=jdtype, interpret=True)
        got = ss.apply_taps_stream(tup.to(tdtype), taps)
        assert torch.equal(got, off[0])
        assert_close_per_update(_as_np(got), np.asarray(want.astype(jnp.float32)),
                                storage, 1, err_msg=f"stream {storage}")
        for (periodic, bcv), got_off in zip(BCS, off[1:]):
            cfg = ref_config(shape, "27pt", periodic, bcv, tb=2)
            want = on_mesh(
                lambda x: ref_pallas.apply_taps_pallas_stream2(
                    ref_exchange(x, cfg, width=2), taps, cfg.mesh.axis_names,
                    periodic=periodic, bc_value=bcv, interpret=True),
                cfg, ju)
            got = ss.apply_taps_streamk(up2[(periodic, bcv)], taps, 2, periodic, bcv)
            assert torch.equal(got, got_off)
            assert_close_per_update(
                _as_np(got), np.asarray(want.astype(jnp.float32)), storage, 2,
                err_msg=f"streamk {storage} periodic={periodic} bc={bcv}")


@pytest.mark.parametrize("kind", ["7pt", "27pt"])
def test_conv_arm_matches_reference_conv(kind):
    """``backend='conv'``: both packages convolve in their library's own
    summation order, so they agree to fp32 rounding of a <= 27-term sum:
    within 28 * 2^-24 * sum|w| * max|u| of each other twice over."""
    shape = (6, 7, 9)
    taps = _taps(kind, shape)
    jup, tup = _field(tuple(n + 2 for n in shape), 13, jnp.float32)
    want = np.asarray(ref_conv(jup, taps))
    got = apply_taps_conv_padded(tup, taps)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    tol = 2 * 28 * 2.0**-24 * np.abs(taps).sum() * float(np.abs(np.asarray(jup)).max())
    assert np.abs(got.numpy() - want).max() <= tol
    # and the same function as the tap chain
    assert np.abs(got.numpy() - ss.apply_taps_stream(tup, taps).numpy()).max() <= tol
