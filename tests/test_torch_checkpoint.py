"""The port's checkpoints (heat3d_tpu_torch.utils.checkpoint and
``HeatSolver3D.save_checkpoint``/``load_checkpoint``) against the JAX
package's, on the CPU: a checkpoint moves between the packages both ways,
on the same mesh and across meshes, in fp32 and bf16 storage and with
leapfrog's second level.

Tolerance: none. Loaded fields are held bitwise to the saved ones, shard
files and their ``.crc32`` sidecars byte for byte to the JAX package's
encoding of the same data (its own files on (1,1,1), where the JAX package
runs in this process; its ``_to_saveable``/``_crc32_hex``/``np.save`` of
each shard's block on a larger mesh), and manifests key for key except
``extra.config`` (each package's ``repr`` of its config).

Also the ports of the checkpoint tests of tests/test_solver.py (round
trip, bf16, cross-mesh stitch, stale exact-match files, consolidate and
its recoveries, the command line's periodic checkpoint and resume) and the
VTK dump against the JAX ``vtkio``. The resumed-equals-uninterrupted
checks compare runs that split their steps the same way: a time-blocked
run resumed at a step that is no multiple of tb runs its remainder single
steps elsewhere than the uninterrupted run.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat3d_tpu.core.config as rc
from heat3d_tpu.models.heat3d import HeatSolver3D as RefSolver
from heat3d_tpu.utils import checkpoint as ref_ckpt
from heat3d_tpu.utils import vtkio as ref_vtkio
from heat3d_tpu_torch import cli
from heat3d_tpu_torch.core import config, golden
from heat3d_tpu_torch.models.heat3d import HeatSolver3D, ShardedField
from heat3d_tpu_torch.timeint import MultiLevelCheckpointError
from heat3d_tpu_torch.utils import checkpoint as ckpt
from heat3d_tpu_torch.utils import vtkio

N = 16


def _cfg(m, mesh=(1, 1, 1), storage="float32", shape=(N, N, N), leapfrog=False,
         tb=1, bc_value=0.0):
    kw = dict(equation="wave", eq_params=(("c", 1.0),), integrator="leapfrog",
              grid=m.GridConfig(shape=shape, dt=0.01,
                                spacing=tuple(1.0 / s for s in shape))) if leapfrog else dict(
        grid=m.GridConfig(shape=shape))
    return m.SolverConfig(
        mesh=m.MeshConfig(shape=mesh),
        precision=m.Precision(storage=storage),
        stencil=m.StencilConfig(bc_value=bc_value),
        backend="jnp",
        time_blocking=tb,
        **kw,
    )


def _f32(a) -> np.ndarray:
    """A host field as float32 (bf16 exactly)."""
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _levels(u):
    return list(u) if isinstance(u, tuple) else [u]


def _ckpt_dirs(path, leapfrog):
    return [path, os.path.join(path, "level-1")] if leapfrog else [path]


def _manifest_wo_config(path):
    m = ckpt.load_manifest(path)
    m["extra"].pop("config", None)
    return m


def _assert_same_files(got_dir, want_dir):
    """Every shard file and sidecar byte-equal; manifests equal but for
    ``extra.config``."""
    names = sorted(f for f in os.listdir(want_dir) if f.startswith("shard_"))
    assert names == sorted(f for f in os.listdir(got_dir) if f.startswith("shard_"))
    for f in names:
        with open(os.path.join(got_dir, f), "rb") as a, open(os.path.join(want_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    assert _manifest_wo_config(got_dir) == _manifest_wo_config(want_dir)


def _ref_run(tmp_path, storage, leapfrog, steps=3):
    """A JAX-package (1,1,1) solve of ``steps`` steps from a gaussian, saved
    by the JAX package; returns (its checkpoint dir, its host levels)."""
    ref = RefSolver(_cfg(rc, storage=storage, leapfrog=leapfrog))
    u = ref.run(ref.init_state("gaussian"), steps)
    path = str(tmp_path / "jax")
    ref.save_checkpoint(path, u, steps)
    return path, [_f32(np.asarray(lv)) for lv in _levels(u)]


CASES = [("float32", False), ("bfloat16", False), ("float32", True), ("bfloat16", True)]
CASE_IDS = ["fp32", "bf16", "leapfrog-fp32", "leapfrog-bf16"]


@pytest.mark.parametrize("storage,leapfrog", CASES, ids=CASE_IDS)
def test_jax_checkpoint_loads_in_port_and_resaves_byte_equal(tmp_path, storage, leapfrog):
    """JAX (1,1,1) save -> port load on (1,1,1) and on (2,2,2) (the stitch)
    -> the same field bitwise; the port's (1,1,1) re-save is the JAX
    package's files byte for byte."""
    path, want = _ref_run(tmp_path, storage, leapfrog)
    for mesh in ((1, 1, 1), (2, 2, 2)):
        s = HeatSolver3D(_cfg(config, mesh=mesh, storage=storage, leapfrog=leapfrog),
                         device="cpu")
        u, step = s.load_checkpoint(path)
        assert step == 3
        assert all(t.dtype == getattr(torch, storage) for lv in _levels(u)
                   for t in s._shards(lv))
        for lv, w in zip(_levels(u), want):
            np.testing.assert_array_equal(s.gather(lv), w)
        if mesh == (1, 1, 1):
            mine = str(tmp_path / "port")
            s.save_checkpoint(mine, u, step)
            for got_dir, want_dir in zip(_ckpt_dirs(mine, leapfrog), _ckpt_dirs(path, leapfrog)):
                _assert_same_files(got_dir, want_dir)


def _expected_files(full: np.ndarray, mesh, local):
    """What the JAX package writes for each shard of ``full`` (a storage-shape
    host array in the storage dtype) on ``mesh``: {name: (npy bytes, crc)}."""
    out = {}
    for px in range(mesh[0]):
        for py in range(mesh[1]):
            for pz in range(mesh[2]):
                start = (px * local[0], py * local[1], pz * local[2])
                block = full[tuple(slice(o, o + n) for o, n in zip(start, local))]
                saveable = ref_ckpt._to_saveable(np.ascontiguousarray(block))
                buf = io.BytesIO()
                np.save(buf, saveable)
                out[ref_ckpt._shard_filename(start)] = (buf.getvalue(),
                                                        ref_ckpt._crc32_hex(saveable))
    return out


def _storage_host(s, u) -> np.ndarray:
    """The padded storage field of the port's state, in its dtype, as the
    JAX package holds it (ml_dtypes bf16)."""
    shards = s._shards(u)
    full = np.empty(s.cfg.padded_shape, np.float32)
    for sh, t in zip(s.mesh.shards, shards):
        full[tuple(slice(o, o + n) for o, n in zip(sh.origin, s.cfg.local_shape))] = \
            t.float().numpy()
    return np.asarray(jnp.asarray(full).astype(jnp.dtype(s.cfg.precision.storage)))


PORT_CASES = [((2, 2, 2), (N, N, N), "float32", False, 0.0),
              ((2, 2, 2), (N, N, N), "bfloat16", False, 0.0),
              ((2, 2, 2), (N, N, N), "float32", True, 0.1),
              ((3, 1, 1), (10, 8, 8), "float32", False, 0.3),
              ((3, 1, 1), (10, 8, 8), "bfloat16", False, 0.3)]


@pytest.mark.parametrize("mesh,shape,storage,leapfrog,bcv", PORT_CASES,
                         ids=["222-fp32", "222-bf16", "222-leapfrog", "311-uneven-fp32",
                              "311-uneven-bf16"])
def test_port_checkpoint_loads_in_jax_byte_equal(tmp_path, mesh, shape, storage, leapfrog,
                                                 bcv):
    """Port save on a sharded mesh (an uneven Dirichlet grid: its bc
    padding too) -> the JAX package's encoding of each shard, byte for
    byte; the JAX package loads it on (1,1,1) bitwise (the whole padded
    storage with ``utils.checkpoint.load``; the field with
    ``load_checkpoint`` where the storage shapes agree)."""
    cfg = _cfg(config, mesh=mesh, storage=storage, shape=shape, leapfrog=leapfrog,
               bc_value=bcv)
    s = HeatSolver3D(cfg, device="cpu")
    u = s.run(s.init_state("gaussian"), 3)
    path = str(tmp_path / "port")
    s.save_checkpoint(path, u, 3)
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    for lv, d in zip(_levels(u), _ckpt_dirs(path, leapfrog)):
        host = _storage_host(s, lv)
        if cfg.is_padded:
            pad = np.ones(cfg.padded_shape, bool)
            pad[tuple(slice(0, g) for g in shape)] = False
            assert np.all(_f32(host)[pad] == np.float32(jnp.asarray(bcv, host.dtype)))
        for name, (data, crc) in _expected_files(host, mesh, cfg.local_shape).items():
            with open(os.path.join(d, name), "rb") as f:
                assert f.read() == data, name
            with open(os.path.join(d, name + ".crc32")) as f:
                assert f.read() == crc, name
        got, step, _ = ref_ckpt.load(d, sharding)
        assert step == 3 and str(got.dtype) == storage
        np.testing.assert_array_equal(_f32(got), _f32(host))
        man = _manifest_wo_config(d)
        starts = sorted({tuple(sh.origin) for sh in s.mesh.shards})
        assert man == {"step": 3, "global_shape": list(cfg.padded_shape), "dtype": storage,
                       "format": 1, "checksums": "crc32-sidecar",
                       "shards": [list(x) for x in starts],
                       "extra": man["extra"]}
    want_extra = ({"levels": 2, "integrator": "leapfrog"} if leapfrog else {})
    assert _manifest_wo_config(path)["extra"] == want_extra
    if not cfg.is_padded:
        ref = RefSolver(_cfg(rc, storage=storage, shape=shape, leapfrog=leapfrog, bc_value=bcv))
        ru, rstep = ref.load_checkpoint(path)
        assert rstep == 3
        for got_lv, lv in zip(_levels(ru), _levels(u)):
            np.testing.assert_array_equal(_f32(np.asarray(got_lv)), s.gather(lv))


# ---- the checkpoint tests of tests/test_solver.py --------------------------------


def _solver(mesh=(1, 1, 1), storage="float32", tb=1, shape=(N, N, N)):
    return HeatSolver3D(_cfg(config, mesh=mesh, storage=storage, tb=tb, shape=shape),
                        device="cpu")


@pytest.mark.parametrize("mesh,tb", [((1, 1, 1), 1), ((2, 2, 2), 2)])
def test_checkpoint_roundtrip(tmp_path, mesh, tb):
    """Save at step 4, load, run 4 more: bitwise the uninterrupted 8-step
    run (4 is a multiple of tb, so both runs split their steps alike)."""
    s = _solver(mesh, tb=tb)
    u = s.run(s.init_state("hot-cube"), 4)
    path = str(tmp_path / "ck")
    s.save_checkpoint(path, u, step=4)
    u2, step = s.load_checkpoint(path)
    assert step == 4
    np.testing.assert_array_equal(s.gather(u), s.gather(u2))
    fresh = _solver(mesh, tb=tb)
    a = s.gather(s.run(u2, 4))
    b = fresh.gather(fresh.run(fresh.init_state("hot-cube"), 8))
    np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip_bf16(tmp_path):
    """bf16 is saved as its uint16 bits (np.save has no bfloat16) and read
    back through an int16 view: the same bits, no ml_dtypes."""
    s = _solver(storage="bfloat16")
    u = s.run(s.init_state("gaussian"), 2)
    path = str(tmp_path / "ckbf16")
    s.save_checkpoint(path, u, step=2)
    assert np.load(os.path.join(path, "shard_0_0_0.npy")).dtype == np.uint16
    assert ckpt.load_manifest(path)["dtype"] == "bfloat16"
    u2, step = s.load_checkpoint(path)
    assert step == 2 and u2.dtype == torch.bfloat16
    assert torch.equal(u.view(torch.int16), u2.view(torch.int16))


def _write_blocks(path, full, starts, block, manifest_extra=None, step=5):
    path.mkdir(exist_ok=True)
    for st in starts:
        np.save(path / ckpt._shard_filename(st),
                full[tuple(slice(o, o + n) for o, n in zip(st, block))])
    man = {"step": step, "global_shape": list(full.shape), "dtype": "float32",
           "format": 1, "extra": {}}
    man.update(manifest_extra or {})
    (path / ckpt.MANIFEST).write_text(json.dumps(man))


OCTANTS = [(sx, sy, sz) for sx in (0, 8) for sy in (0, 8) for sz in (0, 8)]


@pytest.mark.parametrize("mesh", [(1, 1, 1), (4, 1, 1)])
def test_checkpoint_cross_mesh_resume(tmp_path, mesh):
    """A fabricated (2,2,2)-blocked save of a known 16^3 field loads on
    another mesh, each shard stitched from the overlapping blocks; a
    manifest listing its save layout ignores a stale overlapping file; a
    missing block fails naming the coverage shortfall."""
    full = np.random.default_rng(7).standard_normal((N, N, N)).astype(np.float32)
    path = tmp_path / "ck222"
    _write_blocks(path, full, OCTANTS, (8, 8, 8))
    s = _solver(mesh)
    u2, step = s.load_checkpoint(str(path))
    assert step == 5
    np.testing.assert_array_equal(s.gather(u2), full)
    (path / ckpt._shard_filename((0, 0, 4))).write_bytes(
        (path / ckpt._shard_filename((0, 0, 8))).read_bytes())
    _write_blocks(path, full, OCTANTS, (8, 8, 8), {"shards": [list(x) for x in OCTANTS]})
    u3, _ = s.load_checkpoint(str(path))
    np.testing.assert_array_equal(s.gather(u3), full)
    (path / ckpt._shard_filename((8, 8, 8))).unlink()
    with pytest.raises(FileNotFoundError, match="cover"):
        s.load_checkpoint(str(path))


def test_checkpoint_stale_exact_match_ignored(tmp_path):
    """A stale shard file at a start the manifest does not list is never
    trusted, even when its shape matches the request exactly."""
    rng = np.random.default_rng(3)
    old = rng.standard_normal((N, N, N)).astype(np.float32)
    new = rng.standard_normal((N, N, N)).astype(np.float32)
    path = tmp_path / "ckstale"
    path.mkdir()
    np.save(path / ckpt._shard_filename((0, 0, 0)), old[:, :, :8])
    np.save(path / ckpt._shard_filename((0, 0, 8)), old[:, :, 8:])
    np.save(path / ckpt._shard_filename((0, 0, 0)), new)
    (path / ckpt.MANIFEST).write_text(json.dumps({
        "step": 9, "global_shape": [N, N, N], "dtype": "float32",
        "format": 1, "shards": [[0, 0, 0]], "extra": {}}))
    idx = (slice(0, N), slice(0, N), slice(8, N))
    val, _ = ckpt._resolve_shard(str(path), (N, N, N), "float32", {(0, 0, 0)}, None, idx)
    np.testing.assert_array_equal(val, new[:, :, 8:])
    s = _solver((1, 1, 2))
    u, _ = s.load_checkpoint(str(path))
    np.testing.assert_array_equal(s.gather(u), new)
    (path / ckpt.MANIFEST).write_text(json.dumps({
        "step": 9, "global_shape": [N, N, N], "dtype": "float32",
        "format": 1, "shards": [[0, 0, 8]], "extra": {}}))
    with pytest.raises(FileNotFoundError, match="cover"):
        _solver().load_checkpoint(str(path))


def test_checkpoint_wrong_storage_shape_names_the_cause(tmp_path):
    """A checkpoint of another storage shape fails before any shard read,
    with the JAX package's two hints."""
    s = HeatSolver3D(_cfg(config, mesh=(3, 1, 1), shape=(10, 8, 8)), device="cpu")
    path = str(tmp_path / "ck")
    s.save_checkpoint(path, s.init_state("hot-cube"), 1)
    with pytest.raises(ValueError, match="padded for a different mesh"):
        HeatSolver3D(_cfg(config, shape=(10, 8, 8)), device="cpu").load_checkpoint(path)
    with pytest.raises(ValueError, match="wrong checkpoint for this run"):
        HeatSolver3D(_cfg(config, shape=(14, 8, 8)), device="cpu").load_checkpoint(path)
    lf = HeatSolver3D(_cfg(config, shape=(12, 8, 8), leapfrog=True), device="cpu")
    with pytest.raises(MultiLevelCheckpointError, match="field level"):
        lf.load_checkpoint(path)


def test_checkpoint_consolidate(tmp_path):
    """consolidate merges a sharded save into one block (-o leaves the input
    untouched; in place removes the replaced shard files); the result
    loads. Also through the module's command line."""
    full = np.random.default_rng(11).standard_normal((N, N, N)).astype(np.float32)
    path = tmp_path / "ckc"
    _write_blocks(path, full, OCTANTS, (8, 8, 8), {"shards": [list(x) for x in OCTANTS]},
                  step=3)
    dest = ckpt.consolidate(str(path), str(tmp_path / "out"))
    assert ckpt.load_manifest(dest)["shards"] == [[0, 0, 0]]
    np.testing.assert_array_equal(
        np.load(os.path.join(dest, ckpt._shard_filename((0, 0, 0)))), full)
    assert (path / ckpt._shard_filename((8, 8, 8))).exists()
    assert ckpt._cli(["consolidate", str(path), "-o", str(path) + "/"]) == 0
    assert sorted(f for f in os.listdir(path) if f.endswith(".npy")) == \
        [ckpt._shard_filename((0, 0, 0))]
    s = _solver((2, 2, 2))
    u, step = s.load_checkpoint(str(path))
    assert step == 3
    np.testing.assert_array_equal(s.gather(u), full)


def test_checkpoint_consolidate_rerun_recovers(tmp_path):
    """A crash between consolidate's data and manifest replaces, or mid
    sweep, is finished by a re-run; a stale consolidated block that
    disagrees with the listed partials is refused; an out-of-range stale
    block is rejected."""
    full = np.random.default_rng(13).standard_normal((N, N, N)).astype(np.float32)
    path = tmp_path / "ckcrash"
    path.mkdir()
    np.save(path / ckpt._shard_filename((0, 0, 0)), full)
    np.save(path / ckpt._shard_filename((0, 0, 8)), full[:, :, 8:])
    (path / ckpt.MANIFEST).write_text(json.dumps({
        "step": 4, "global_shape": [N, N, N], "dtype": "float32",
        "format": 1, "shards": [[0, 0, 0], [0, 0, 8]], "extra": {}}))
    dest = ckpt.consolidate(str(path))
    assert ckpt.load_manifest(dest)["shards"] == [[0, 0, 0]]
    assert sorted(f for f in os.listdir(path) if f.endswith(".npy")) == \
        [ckpt._shard_filename((0, 0, 0))]
    np.testing.assert_array_equal(np.load(path / ckpt._shard_filename((0, 0, 0))), full)
    np.save(path / ckpt._shard_filename((0, 0, 8)), full[:, :, 8:])
    ckpt.consolidate(str(path))
    assert sorted(f for f in os.listdir(path) if f.endswith(".npy")) == \
        [ckpt._shard_filename((0, 0, 0))]
    np.save(path / ckpt._shard_filename((0, 0, 0)), np.zeros((N, N, N), np.float32))
    np.save(path / ckpt._shard_filename((0, 0, 8)), full[:, :, 8:])
    (path / ckpt.MANIFEST).write_text(json.dumps({
        "step": 7, "global_shape": [N, N, N], "dtype": "float32",
        "format": 1, "shards": [[0, 0, 0], [0, 0, 8]], "extra": {}}))
    with pytest.raises(ValueError, match="stale consolidated save"):
        ckpt.consolidate(str(path))
    assert (path / ckpt._shard_filename((0, 0, 8))).exists()
    np.save(path / ckpt._shard_filename((0, 0, 12)), np.zeros((N, N, 8), np.float32))
    (path / ckpt.MANIFEST).write_text(json.dumps({
        "step": 4, "global_shape": [N, N, 8], "dtype": "float32",
        "format": 1, "extra": {}}))
    with pytest.raises(ValueError, match="outside the manifest shape"):
        ckpt.consolidate(str(path))


def test_checkpoint_consolidate_recovery_out_of_range_block(tmp_path):
    full = np.arange(N ** 3, dtype=np.float32).reshape(N, N, N)
    path = tmp_path / "ckoor"
    path.mkdir()
    np.save(path / ckpt._shard_filename((0, 0, 0)), full)
    np.save(path / ckpt._shard_filename((0, 0, 12)), np.zeros((N, N, 8), np.float32))
    (path / ckpt.MANIFEST).write_text(json.dumps({
        "step": 2, "global_shape": [N, N, N], "dtype": "float32",
        "format": 1, "shards": [[0, 0, 0], [0, 0, 12]], "extra": {}}))
    with pytest.raises(ValueError, match="outside the manifest shape"):
        ckpt.consolidate(str(path))


def test_consolidate_equals_jax_consolidate(tmp_path):
    """The port's consolidate of a port (2,2,2) save writes the bytes the
    JAX package's consolidate writes from the same save."""
    s = _solver((2, 2, 2), storage="bfloat16")
    u = s.run(s.init_state("gaussian"), 2)
    s.save_checkpoint(str(tmp_path / "a"), u, 2)
    s.save_checkpoint(str(tmp_path / "b"), u, 2)
    ckpt.consolidate(str(tmp_path / "a"))
    ref_ckpt.consolidate(str(tmp_path / "b"))
    _assert_same_files(str(tmp_path / "a"), str(tmp_path / "b"))


# ---- the command line -------------------------------------------------------------


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_exact_step_count_and_periodic_checkpoint(tmp_path, capsys):
    """--steps N runs exactly N updates with --residual-every, and
    --checkpoint-every fires on its grid; the final checkpoint holds the
    fp64 oracle's field."""
    ck = str(tmp_path / "ck")
    assert cli.main(["--grid", "16", "--steps", "10", "--residual-every", "4",
                     "--checkpoint", ck, "--checkpoint-every", "4", "--device", "cpu"]) == 0
    assert _summary(capsys)["steps"] == 10
    assert ckpt.load_manifest(ck)["step"] == 10
    cfg = config.SolverConfig(grid=config.GridConfig.cube(16))
    want = golden.run(golden.make_init("hot-cube", (16, 16, 16)), cfg.grid, cfg.stencil, 10)
    s = HeatSolver3D(cfg, device="cpu")
    u2, _ = s.load_checkpoint(ck)
    np.testing.assert_allclose(s.gather(u2).astype(np.float64), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("extra", [[], ["--mesh", "2", "2", "2", "--time-blocking", "2"]],
                         ids=["111", "222-tb2"])
def test_cli_checkpoint_resume_equals_uninterrupted(tmp_path, capsys, extra):
    """4 steps, --checkpoint; then --resume for 4 more: the final
    checkpoint is the uninterrupted 8-step run's, byte for byte (4 is a
    multiple of tb), and the golden check counts from t=0."""
    base = ["--grid", "16", "--device", "cpu", *extra]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert cli.main([*base, "--steps", "8", "--checkpoint", one]) == 0
    capsys.readouterr()
    assert cli.main([*base, "--steps", "4", "--checkpoint", two]) == 0
    capsys.readouterr()
    assert cli.main([*base, "--steps", "4", "--checkpoint", two, "--resume",
                     "--golden-check"]) == 0
    summary = _summary(capsys)
    assert summary["steps"] == 4 and summary["golden_pass"]
    assert ckpt.load_manifest(two)["step"] == 8
    _assert_same_files(two, one)


def test_cli_dump_vtk_equals_jax_vtkio(tmp_path, capsys):
    """--dump-vtk writes the gathered field through the port's copy of
    ``vtkio``: the JAX writer's bytes for the same field, read back by
    both readers as the field; an unwritable path fails before the run."""
    path = str(tmp_path / "u.vtk")
    argv = ["--grid", "12", "--steps", "3", "--mesh", "2", "1", "1", "--device", "cpu",
            "--spacing", "1.0", "0.5", "2.0", "--dump-vtk", path]
    assert cli.main(argv) == 0
    assert _summary(capsys)["vtk_path"] == path
    s = HeatSolver3D(config.SolverConfig(
        grid=config.GridConfig(shape=(12, 12, 12), spacing=(1.0, 0.5, 2.0)),
        mesh=config.MeshConfig(shape=(2, 1, 1))), device="cpu")
    field = s.gather(s.run(s.init_state("hot-cube"), 3))
    ref_path = str(tmp_path / "ref.vtk")
    ref_vtkio.write_structured_points(ref_path, field, spacing=(1.0, 0.5, 2.0))
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    for reader in (vtkio.read_structured_points, ref_vtkio.read_structured_points):
        got, meta = reader(path)
        np.testing.assert_array_equal(got, field)
        assert meta["dimensions"] == (12, 12, 12) and meta["spacing"] == (1.0, 0.5, 2.0)
    plane = field[:, 5, :]
    vtkio.write_structured_points(str(tmp_path / "p.vtk"), plane)
    ref_vtkio.write_structured_points(str(tmp_path / "q.vtk"), plane)
    assert (tmp_path / "p.vtk").read_bytes() == (tmp_path / "q.vtk").read_bytes()
    with pytest.raises(ValueError, match="not writable"):
        cli._main(["--grid", "8", "--device", "cpu", "--dump-vtk",
                   str(tmp_path / "no" / "such" / "dir.vtk")])


def test_sharded_field_save_syncs_nothing_on_cpu(tmp_path):
    """A ShardedField saved without a solver: the origins follow from its
    mesh shape and shard shape, as the solver's mesh places them."""
    shards = [torch.full((4, 8, 8), float(r)) for r in range(4)]
    ckpt.save(str(tmp_path / "ck"), ShardedField(shards, (2, 2, 1)), 7)
    man = ckpt.load_manifest(str(tmp_path / "ck"))
    assert man["global_shape"] == [8, 16, 8]
    assert man["shards"] == [[0, 0, 0], [0, 8, 0], [4, 0, 0], [4, 8, 0]]
    np.testing.assert_array_equal(np.load(tmp_path / "ck" / "shard_4_0_0.npy"),
                                  np.full((4, 8, 8), 2.0, np.float32))
