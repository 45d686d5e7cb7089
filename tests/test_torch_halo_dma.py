"""The port's DMA halo exchange (heat3d_tpu_torch.ops.halo_dma) against the
JAX package's DMA exchange (``heat3d_tpu.ops.halo_pallas.exchange_axis_dma``
in Pallas interpret mode), byte-equal.

The JAX side runs once per worker in a subprocess on a 4-device CPU mesh
(this file run as a script, with the environment of
tests/test_multidevice.py), and writes every case into one ``.npz``. JAX's
interpret mode runs remote DMA on 1-D meshes only, so each array axis is
driven on its own ring of 4 shards, as tests/multidevice_checks.py
``check_dma_halo_ring_interpret`` does: widths 1-4, periodic and Dirichlet
(bc 0 and 0.3), float32 and bf16 storage.

Two port sides are held to each case:
- the kernels' plain version (``exchange_axis_dma`` on CPU blocks runs
  ``exchange_axis_dma_ref``);
- the kernels' launch table (``launch_table``: per device the push items'
  blocks, slab origins, fills and flag words, the waits' flag words and
  error codes, the slab extents), executed by a Python model of
  ``halo_push_kernel``/``halo_wait_kernel``, which also checks that the
  table gives each shard's two sides exactly once, that no push writes a
  cell another push of the axis reads or writes, and that every wait finds
  its flags at the epoch.
The same model holds whole exchanges (``ExchangePlan`` with the ``dma``
transport) to the ``ppermute`` transport on 3-D meshes the JAX interpreter
cannot run, with the shards spread over one or several modelled devices.
The kernels themselves run on the card (tests/test_torch_kernels.py,
marked ``cuda``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat3d_tpu_torch.core.config import BoundaryCondition
from heat3d_tpu_torch.ops import halo_dma
from heat3d_tpu_torch.parallel.halo import interior
from heat3d_tpu_torch.parallel.plan import ExchangePlan
from heat3d_tpu_torch.parallel.topology import ShardMesh

HERE = os.path.dirname(os.path.abspath(__file__))
GRID = (16, 16, 16)
RING = 4
WIDTHS = (1, 2, 3, 4)
BCS = ((True, 0.0), (False, 0.0), (False, 0.3))
STORAGE = ("float32", "bfloat16")


def _base(seed=3):
    return np.random.default_rng(seed).standard_normal(GRID).astype(np.float32)


def _key(axis, width, periodic, bcv, storage):
    return f"a{axis}_w{width}_p{int(periodic)}_b{bcv}_{storage}"


def _reference(path: str) -> None:
    """The JAX DMA exchange of every case (needs 4 JAX devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from heat3d_tpu.ops.halo_pallas import exchange_axis_dma
    from heat3d_tpu.utils.compat import shard_map

    mesh = Mesh(np.array(jax.devices()[:RING]).reshape(RING), ("x",))
    out = {}
    for storage in STORAGE:
        u_host = jnp.asarray(_base()).astype(getattr(jnp, storage))
        for axis in range(3):
            spec = P(*["x" if a == axis else None for a in range(3)])
            u = jax.device_put(u_host, NamedSharding(mesh, spec))
            for periodic, bcv in BCS:
                for width in WIDTHS:
                    got = jax.jit(shard_map(
                        lambda x: exchange_axis_dma(
                            x, axis, "x", RING, ("x",), periodic, bcv,
                            width=width, interpret=True),
                        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False,
                    ))(u)
                    out[_key(axis, width, periodic, bcv, storage)] = np.asarray(
                        got.astype(jnp.float32))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    from test_multidevice import _cpu_mesh_env

    path = str(tmp_path_factory.mktemp("dma_ref") / "ref.npz")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), path],
        env=_cpu_mesh_env(RING), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, f"JAX reference failed:\n{proc.stderr[-4000:]}"
    return np.load(path)


# ---- a Python model of the two kernels -------------------------------------


def _bits_value(bits: int, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        raw = np.array([bits], np.uint16).view(np.int16)
        return torch.from_numpy(raw).view(torch.bfloat16)[0]
    return torch.from_numpy(np.array([bits], np.uint32).view(np.float32))[0]


def _region(off, ext):
    return tuple(slice(o, o + e) for o, e in zip(off, ext))


def run_modelled(pads, mesh, axis, width, periodic, bcv, state):
    """One axis of the DMA exchange at ``state.epoch`` from the state's
    launch tables (``halo_dma.launch_table``), executed as the kernels would: every push
    item of every device's launch (reads of the whole axis first, as the
    pushes run concurrently), then every wait. Fails on a table that does
    not give each shard's two sides exactly once, a push that writes what
    another push reads or writes, or a wait whose flags are short."""
    launches = state.launches[axis]
    assert state.blocks == (tuple(p.data_ptr() for p in pads), width, periodic)
    by_ptr = {p.data_ptr(): i for i, p in enumerate(pads)}
    flag_of = {f.data_ptr(): i for i, f in enumerate(state.flags)}
    word = state.flags[0].element_size()
    bc = _bits_value(halo_dma._bc_bits(bcv, pads[0].dtype), pads[0].dtype)
    reads = [torch.zeros(p.shape, dtype=torch.bool) for p in pads]
    writes = [torch.zeros(p.shape, dtype=torch.int32) for p in pads]
    staged, sides, owed = [], [], []
    assert [lau.device for lau in launches] == list(state.groups)
    for lau in launches:
        assert all(s.device == lau.device for s in lau.shards)
        assert tuple(lau.P) == tuple(pads[0].shape)
        assert len(lau.items) == 2 * len(lau.shards)
        ext = tuple(lau.E)
        for i, item in enumerate(lau.items):
            shard, k = lau.shards[i // 2], i % 2
            sides.append((shard.rank, k))
            assert item.src == pads[shard.rank].data_ptr()
            dst = by_ptr[item.dst]
            d = _region(item.dst_off, ext)
            writes[dst][d] += 1
            nb = mesh.neighbor(shard, axis, 2 * k - 1, periodic)
            if item.fill:
                assert nb is None and dst == shard.rank and item.flag is None
                staged.append((dst, d, bc))
            else:
                assert nb is not None and dst == nb.rank
                assert (nb.rank in lau.remote) == (nb.device != lau.device)
                assert item.flag == state.flags[nb.rank].data_ptr() + (2 * axis + 1 - k) * word
                s = _region(item.src_off, ext)
                reads[shard.rank][s] = True
                staged.append((dst, d, pads[shard.rank][s].clone()))
        for wait in lau.waits:
            owed.append((wait.flag, wait.code))
    assert sorted(sides) == [(s.rank, k) for s in mesh.shards for k in (0, 1)]
    for r, w in zip(reads, writes):
        assert int(w.max()) <= 1, "two pushes write one cell"
        assert not bool((r & (w > 0)).any()), "a push writes a cell another reads"
    for dst, d, val in staged:
        pads[dst][d] = val
    for lau in launches:  # the last block of each launch signals
        for item in lau.items:
            if item.flag is not None:
                base = max(p for p in flag_of if p <= item.flag)
                state.flags[flag_of[base]][(item.flag - base) // word] = state.epoch
    want = sorted(
        (state.flags[s.rank].data_ptr() + (2 * axis + side) * word, 1 + s.rank * 4 + axis)
        for s in mesh.shards for side, d in ((0, -1), (1, +1))
        if mesh.neighbor(s, axis, d, periodic) is not None)
    assert sorted(owed) == want
    for f, code in owed:
        rank = (code - 1) // 4
        base = state.flags[rank].data_ptr()
        assert int(state.flags[rank][(f - base) // word]) == state.epoch


def _ring(axis):
    shape = [1, 1, 1]
    shape[axis] = RING
    return ShardMesh(shape, [g // s for g, s in zip(GRID, shape)],
                     [torch.device("cpu")] * RING)


def _padded_shards(mesh, u: torch.Tensor, width, dtype):
    """Each shard's block of ``u`` in the interior of a width-``width``
    padded block (ghosts left at NaN, so a ghost left unwritten shows)."""
    local = mesh.local_shape
    pads = []
    for s in mesh.shards:
        p = torch.full(tuple(n + 2 * width for n in local), float("nan"), dtype=dtype)
        p[interior(local, width)] = u[tuple(
            slice(o, o + n) for o, n in zip(s.origin, local))]
        pads.append(p)
    return pads


def _axis_grown(pads, mesh, axis, width) -> np.ndarray:
    """The JAX layout: each shard grown along ``axis`` only, stitched."""
    local = mesh.local_shape
    parts = []
    for p in pads:
        idx = [slice(width, width + n) for n in local]
        idx[axis] = slice(None)
        parts.append(p[tuple(idx)].float().numpy())
    return np.concatenate(parts, axis)


CASES = [(a, w, p, b, s) for s in STORAGE for a in range(3) for p, b in BCS for w in WIDTHS]


@pytest.mark.parametrize("axis,width,periodic,bcv,storage", CASES)
def test_plain_version_and_launch_args_equal_jax_dma(jax_ref, axis, width, periodic,
                                                     bcv, storage):
    want = jax_ref[_key(axis, width, periodic, bcv, storage)]
    dtype = getattr(torch, storage)
    u = torch.from_numpy(_base()).to(dtype)  # round to nearest even, as JAX
    mesh = _ring(axis)

    pads = _padded_shards(mesh, u, width, dtype)
    state = halo_dma.DmaState(mesh, pads, width, periodic)
    assert list(state.launches) == [axis]
    halo_dma.exchange_axis_dma(pads, mesh, axis, width, periodic, bcv, state)
    got = _axis_grown(pads, mesh, axis, width)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()

    pads = _padded_shards(mesh, u, width, dtype)
    state = halo_dma.DmaState(mesh, pads, width, periodic)
    state.epoch += 1
    run_modelled(pads, mesh, axis, width, periodic, bcv, state)
    modelled = _axis_grown(pads, mesh, axis, width)
    assert modelled.tobytes() == want.tobytes()


def _bc(periodic):
    return BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET


@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2), (3, 1, 2)])
@pytest.mark.parametrize("storage", STORAGE)
def test_modelled_dma_exchange_equals_ppermute_on_3d_meshes(monkeypatch, mesh_shape, storage):
    """A whole exchange with the dma transport, its kernels modelled from
    their launch tables over 3 exchanges in a row (epochs 1-3 on the same
    flags), equals the ppermute transport byte for byte."""
    _modelled_vs_ppermute(monkeypatch, mesh_shape, storage, 1)


@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (2, 2, 2), (3, 1, 2)])
@pytest.mark.parametrize("storage", STORAGE)
def test_modelled_dma_exchange_over_modelled_devices(monkeypatch, mesh_shape, storage):
    """The same with the shards dealt over two modelled devices: one launch
    per device, and the receivers on the other device in its ``remote``."""
    _modelled_vs_ppermute(monkeypatch, mesh_shape, storage, 2)


def _modelled_vs_ppermute(monkeypatch, mesh_shape, storage, devices):
    dtype = getattr(torch, storage)
    local = (4, 5, 6)
    n = int(np.prod(mesh_shape))
    mesh = ShardMesh(mesh_shape, local, [torch.device("cpu", r % devices) for r in range(n)])
    rng = np.random.default_rng(11)
    monkeypatch.setattr(
        "heat3d_tpu_torch.ops.halo_dma.exchange_axis_dma",
        lambda pads, mesh, axis, w, p, bcv, state, sync=None: run_modelled(
            pads, mesh, axis, w, p, bcv, state),
    )
    for periodic, bcv in BCS:
        for width in WIDTHS:
            dma = ExchangePlan(mesh, _bc(periodic), width, "dma", dtype)
            ref = ExchangePlan(mesh, _bc(periodic), width, "ppermute", dtype)
            for _ in range(3):
                us = [torch.from_numpy(rng.standard_normal(local).astype(np.float32)).to(dtype)
                      for _ in mesh.shards]
                got = dma.apply(us, bcv)
                want = ref.apply(us, bcv)
                for g, w in zip(got, want):
                    assert g.float().numpy().tobytes() == w.float().numpy().tobytes()
            assert dma.dma.epoch == 3


def test_dma_rejects_size_one_axis_and_bad_blocks():
    mesh = ShardMesh((1, 2, 1), (4, 4, 4), [torch.device("cpu")] * 2)
    pads = [torch.zeros((6, 6, 6)) for _ in range(2)]
    state = halo_dma.DmaState(mesh, pads, 1, False)
    assert list(state.launches) == [1]
    with pytest.raises(ValueError, match="mesh size 1"):
        halo_dma.exchange_axis_dma(pads, mesh, 0, 1, False, 0.0, state)
    fresh = [torch.zeros((6, 6, 6)) for _ in range(2)]
    for blocks, width, periodic in ((fresh, 1, False), (pads, 1, True), (pads, 2, False)):
        with pytest.raises(ValueError, match="other padded blocks"):
            halo_dma.exchange_axis_dma(blocks, mesh, 1, width, periodic, 0.0, state)
    pads = [torch.zeros((6, 6, 6), dtype=torch.float64, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="no kernel"):
        halo_dma.exchange_axis_dma(pads, mesh, 1, 1, False, 0.0, state)


def test_bc_bits_round_to_storage():
    assert halo_dma._bc_bits(0.3, torch.float32) == int(
        np.array(0.3, np.float32).view(np.uint32))
    b = halo_dma._bc_bits(0.3, torch.bfloat16)
    assert b == int(torch.tensor(0.3).to(torch.bfloat16).view(torch.int16)) & 0xFFFF
    assert float(_bits_value(b, torch.bfloat16)) == float(torch.tensor(0.3).to(torch.bfloat16))
    assert halo_dma._bc_bits(-1.5, torch.bfloat16) == 0xBFC0


def test_launch_counts_reset():
    halo_dma.exchange_axis_dma.launches = 7
    assert halo_dma.launch_counts() == {"halo_dma": 7}
    halo_dma.reset_launch_counts()
    assert halo_dma.launch_counts() == {"halo_dma": 0}


if __name__ == "__main__":
    _reference(sys.argv[1])
