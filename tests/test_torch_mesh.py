"""The port's sharded solve (HeatSolver3D over a mesh of shards, every shard
on the CPU, where the kernels' plain versions run) against the JAX package
on a 4-device CPU mesh, and against itself on a (1,1,1) mesh.

The JAX side runs once per worker in a subprocess (this file run as a
script, in the environment tests/test_multidevice.py gives its 4-device
CPU mesh, with ``HEAT3D_DIRECT_INTERPRET=1`` so its direct and streamk
kernels run in Pallas interpret mode) and writes every case into one
``.npz``:
- the sharded ``exchange`` and ``exchange_halo_faces`` under ``shard_map``
  on a (2,2,1) mesh, widths 1-4, periodic and Dirichlet (bc 0 and 0.3),
  float32 and bf16: the port's exchange plans are held to them byte for
  byte (the dma transport in one case: on the CPU it runs the same slab
  copies, its kernels' plain version);
- the JAX solver on (2,2,1): faces-direct tb 1/2, streamk tb 3/4, the
  exchange path under ``HEAT3D_NO_DIRECT``, an uneven grid; the port runs
  each with ``halo='ppermute'`` and ``halo='dma'`` (the JAX package runs
  DMA only on a TPU, so its ppermute solve is the reference of both). The
  tolerance is ``torch_port_checks.assert_close_per_update``; each side is
  also held to the fp64 golden oracle at the tests/test_torch_solver.py
  tier;
- the JAX ``init_state`` (storage, padding included) and ``gather``, held
  byte-equal.

The port alone: every sharded route equals the (1,1,1) solve bitwise, the
route table, the streamk domain-edge mask on an interior shard, the mesh's
topology, the command line and the carry helpers.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat3d_tpu_torch import carry, cli
from heat3d_tpu_torch.core import config, golden
from heat3d_tpu_torch.models.heat3d import HeatSolver3D, ShardedField
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded
from heat3d_tpu_torch.parallel import step, topology
from heat3d_tpu_torch.parallel.halo import exchange_halo
from heat3d_tpu_torch.parallel.plan import ExchangePlan, FacesPlan
from torch_port_checks import assert_close_per_update

MESH = (2, 2, 1)
EVEN = (16, 12, 10)
UNEVEN = (15, 11, 10)
WIDTHS = (1, 2, 3, 4)
BCS = ((True, 0.0), (False, 0.0), (False, 0.3))
STORAGE = ("float32", "bfloat16")
INITS = ("hot-cube", "gaussian", "random")
# the JAX solver's cases on MESH: each also runs in the port with halo='dma'
SOLVES = {
    "fd1": dict(kind="7pt", periodic=False, bcv=0.3, tb=1, steps=4),
    "fd2": dict(kind="27pt", periodic=True, bcv=0.0, tb=2, steps=5),
    "sk3": dict(kind="7pt", periodic=False, bcv=0.3, tb=3, steps=7),
    "sk4": dict(kind="27pt", periodic=False, bcv=0.0, tb=4, steps=9),
    "nd1": dict(kind="7pt", periodic=False, bcv=0.3, tb=1, steps=4, no_direct=True),
    "uneven": dict(kind="7pt", periodic=False, bcv=0.3, tb=2, steps=5, shape=UNEVEN),
}


def _base(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfg(m, shape=EVEN, mesh=MESH, kind="7pt", periodic=False, bcv=0.0, tb=1,
         halo="ppermute", storage="float32", backend="auto", seed=2):
    """A SolverConfig of the port's (``m = config``) or the JAX package's
    config module."""
    bc = m.BoundaryCondition.PERIODIC if periodic else m.BoundaryCondition.DIRICHLET
    return m.SolverConfig(
        grid=m.GridConfig(shape=shape),
        stencil=m.StencilConfig(kind=kind, bc=bc, bc_value=bcv),
        mesh=m.MeshConfig(shape=mesh), halo=halo, backend=backend,
        precision=m.Precision(storage=storage), time_blocking=tb,
        run=m.RunConfig(seed=seed),
    )


def _case_cfg(m, case, halo="ppermute"):
    return _cfg(m, case.get("shape", EVEN), MESH, case["kind"], case["periodic"],
                case["bcv"], case["tb"], halo)


def _ex_key(width, periodic, bcv, storage):
    return f"w{width}_p{int(periodic)}_b{bcv}_{storage}"


def _reference(path: str) -> None:
    """Every JAX case (needs 4 JAX devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from heat3d_tpu.core import config as rc
    from heat3d_tpu.models.heat3d import HeatSolver3D as RefSolver
    from heat3d_tpu.parallel.halo import exchange_halo as ref_exchange
    from heat3d_tpu.parallel.halo import exchange_halo_faces
    from heat3d_tpu.parallel.topology import build_mesh, field_sharding
    from heat3d_tpu.utils.compat import shard_map

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    out = {}
    mcfg = rc.MeshConfig(shape=MESH)
    mesh = build_mesh(mcfg, jax.devices()[:4])
    spec = P(*mcfg.axis_names)
    for storage in STORAGE:
        u = jax.device_put(jnp.asarray(_base(EVEN)).astype(getattr(jnp, storage)),
                           field_sharding(mesh, mcfg))
        for periodic, bcv in BCS:
            bc = rc.BoundaryCondition.PERIODIC if periodic else rc.BoundaryCondition.DIRICHLET
            for w in WIDTHS:
                key = _ex_key(w, periodic, bcv, storage)
                out["ex_" + key] = f32(jax.jit(shard_map(
                    lambda x: ref_exchange(x, mcfg, bc, bcv, w), mesh=mesh,
                    in_specs=spec, out_specs=spec, check_vma=False))(u))
                faces = jax.jit(shard_map(
                    lambda x: exchange_halo_faces(x, mcfg, bc, bcv, w), mesh=mesh,
                    in_specs=spec, out_specs=(spec,) * 6, check_vma=False))(u)
                for i, f in enumerate(faces):
                    out[f"face{i}_" + key] = f32(f)
    os.environ["HEAT3D_DIRECT_INTERPRET"] = "1"
    for name, case in SOLVES.items():
        if case.get("no_direct"):
            os.environ["HEAT3D_NO_DIRECT"] = "1"
        else:
            os.environ.pop("HEAT3D_NO_DIRECT", None)
        ref = RefSolver(_case_cfg(rc, case), devices=jax.devices()[:4])
        u0 = ref.init_state("random")
        out["u0_" + name] = f32(ref.gather(u0))
        out["out_" + name] = f32(ref.gather(ref.run(u0, case["steps"])))
    os.environ.pop("HEAT3D_NO_DIRECT", None)
    for shape in (EVEN, UNEVEN):
        for storage in STORAGE:
            ref = RefSolver(_cfg(rc, shape, bcv=0.3, storage=storage),
                            devices=jax.devices()[:4])
            for init in INITS:
                u = ref.init_state(init)
                key = f"{shape[0]}_{storage}_{init}"
                out["storage_" + key] = f32(u)
                out["gather_" + key] = f32(ref.gather(u))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    from test_multidevice import _cpu_mesh_env

    path = str(tmp_path_factory.mktemp("mesh_ref") / "ref.npz")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), path],
        env=_cpu_mesh_env(4), capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, f"JAX reference failed:\n{proc.stderr[-4000:]}"
    return np.load(path)


def _stitch(blocks, mesh) -> np.ndarray:
    """Per-shard blocks (rank order) placed by mesh coordinates, as
    ``shard_map``'s out_specs lay them out."""
    b = [x.float().numpy() for x in blocks]
    shape = tuple(p * n for p, n in zip(mesh.shape, b[0].shape))
    full = np.empty(shape, np.float32)
    for s, x in zip(mesh.shards, b):
        full[tuple(slice(c * n, (c + 1) * n) for c, n in zip(s.coords, x.shape))] = x
    return full


def _bc(periodic):
    return config.BoundaryCondition.PERIODIC if periodic else config.BoundaryCondition.DIRICHLET


def _cpu_mesh(shape, local):
    return topology.ShardMesh(shape, local, [torch.device("cpu")] * int(np.prod(shape)))


def _shards(cfg, mesh, arr):
    return carry.split_global(arr, cfg, mesh).shards


# ---- exchanges -------------------------------------------------------------

EX_CASES = [(w, p, b, s) for s in STORAGE for p, b in BCS for w in WIDTHS]
# on CPU blocks the dma transport runs the same slab copies (the DMA
# kernels' plain version), so one case covers the plan's dma branch
EX_TRANSPORT_CASES = ([("ppermute",) + c for c in EX_CASES]
                      + [("dma", 2, False, 0.3, "bfloat16")])


@pytest.mark.parametrize("transport,width,periodic,bcv,storage", EX_TRANSPORT_CASES)
def test_sharded_exchange_equals_jax(jax_ref, transport, width, periodic, bcv, storage):
    dtype = getattr(torch, storage)
    cfg = _cfg(config, storage=storage, periodic=periodic, bcv=bcv)
    mesh = topology.build_shard_mesh(cfg, "cpu")
    us = _shards(cfg, mesh, torch.from_numpy(_base(EVEN)).to(dtype).float().numpy())
    pads = ExchangePlan(mesh, _bc(periodic), width, transport, dtype).apply(us, bcv)
    want = jax_ref["ex_" + _ex_key(width, periodic, bcv, storage)]
    got = _stitch(pads, mesh)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("width,periodic,bcv,storage", EX_CASES)
def test_sharded_faces_exchange_equals_jax(jax_ref, width, periodic, bcv, storage):
    dtype = getattr(torch, storage)
    cfg = _cfg(config, storage=storage, periodic=periodic, bcv=bcv)
    mesh = topology.build_shard_mesh(cfg, "cpu")
    us = _shards(cfg, mesh, torch.from_numpy(_base(EVEN)).to(dtype).float().numpy())
    faces = FacesPlan(mesh, _bc(periodic), width, dtype).apply(us, bcv)
    for i in range(6):
        want = jax_ref[f"face{i}_" + _ex_key(width, periodic, bcv, storage)]
        got = _stitch([f[i] for f in faces], mesh)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i


def test_single_shard_exchange_unchanged():
    """On one shard the plan's exchange equals ``exchange_halo`` (the
    single-device form) byte for byte."""
    u = torch.from_numpy(_base(EVEN))
    mesh = _cpu_mesh((1, 1, 1), EVEN)
    for periodic, bcv in BCS:
        for w in WIDTHS:
            got = ExchangePlan(mesh, _bc(periodic), w, "ppermute", torch.float32).apply([u], bcv)
            assert torch.equal(got[0], exchange_halo(u, _bc(periodic), bcv, w))


# ---- the solver against JAX -------------------------------------------------


def _golden(cfg, u0, steps):
    from heat3d_tpu_torch import eqn

    return golden.run(u0.astype(np.float64), cfg.grid, cfg.stencil, steps,
                      taps=eqn.solver_taps(cfg))


@pytest.mark.parametrize("halo", ["ppermute", "dma"])
@pytest.mark.parametrize("name", list(SOLVES))
def test_sharded_solver_matches_jax_and_golden(jax_ref, monkeypatch, name, halo):
    case = SOLVES[name]
    if case.get("no_direct"):
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    cfg = _case_cfg(config, case, halo)
    solver = HeatSolver3D(cfg, device="cpu")
    u0 = jax_ref["u0_" + name]
    got = solver.gather(solver.run(solver.init_state(u0), case["steps"]))
    want = jax_ref["out_" + name]
    assert got.shape == cfg.grid.shape
    assert_close_per_update(got, want, "float32", case["steps"], err_msg=name)
    g = _golden(cfg, u0, case["steps"])
    np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want, g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("shape", [EVEN, UNEVEN], ids=["even", "uneven"])
def test_init_state_and_gather_equal_jax(jax_ref, shape, storage):
    cfg = _cfg(config, shape, bcv=0.3, storage=storage)
    solver = HeatSolver3D(cfg, device="cpu")
    for init in INITS:
        u = solver.init_state(init)
        assert isinstance(u, ShardedField) and u.dtype == getattr(torch, storage)
        key = f"{shape[0]}_{storage}_{init}"
        storage_want = jax_ref["storage_" + key]
        assert storage_want.shape == cfg.padded_shape
        assert _stitch(u.shards, solver.mesh).tobytes() == storage_want.tobytes(), init
        assert solver.gather(u).tobytes() == jax_ref["gather_" + key].tobytes(), init


# ---- the port against itself ------------------------------------------------

# (mesh, grid) of the bitwise cases: even on every mesh
_MESHES = {(2, 2, 2): (18, 20, 10), (3, 1, 2): (18, 20, 10), (1, 4, 1): (18, 20, 10)}
BITWISE = [
    # (time_blocking, halo, HEAT3D_NO_DIRECT, backend)
    (1, "ppermute", False, "auto"), (2, "ppermute", False, "auto"),
    (3, "ppermute", False, "auto"), (4, "ppermute", False, "auto"),
    (1, "ppermute", True, "auto"), (2, "ppermute", True, "auto"),
    (1, "dma", False, "auto"), (2, "dma", False, "auto"), (4, "dma", False, "auto"),
    (3, "ppermute", False, "jnp"), (5, "dma", False, "auto"),
]


@pytest.mark.parametrize("periodic,kind,storage", [
    (False, "7pt", "float32"), (True, "27pt", "float32"), (False, "27pt", "bfloat16")])
@pytest.mark.parametrize("mesh_shape", list(_MESHES))
@pytest.mark.parametrize("tb,halo,no_direct,backend", BITWISE)
def test_sharded_solve_equals_single_shard_bitwise(monkeypatch, mesh_shape, tb, halo,
                                                   no_direct, backend, periodic, kind,
                                                   storage):
    shape = _MESHES[mesh_shape]
    bcv = 0.0 if periodic else 0.3
    steps = 2 * tb + 1
    one = _cfg(config, shape, (1, 1, 1), kind, periodic, bcv, 1, storage=storage)
    s1 = HeatSolver3D(one, device="cpu")
    want = s1.gather(s1.run(s1.init_state("random"), steps))
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    cfg = _cfg(config, shape, mesh_shape, kind, periodic, bcv, tb, halo, storage, backend)
    solver = HeatSolver3D(cfg, device="cpu")
    got = solver.gather(solver.run(solver.init_state("random"), steps))
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("tb,halo", [(1, "ppermute"), (2, "ppermute"), (4, "dma"), (3, "ppermute")])
def test_uneven_sharded_solve_equals_single_shard_bitwise(tb, halo):
    shape = (17, 13, 11)
    one = _cfg(config, shape, (1, 1, 1), bcv=0.3)
    s1 = HeatSolver3D(one, device="cpu")
    want = s1.gather(s1.run(s1.init_state("gaussian"), 9))
    cfg = _cfg(config, shape, (2, 3, 2), bcv=0.3, tb=tb, halo=halo)
    assert cfg.is_padded
    solver = HeatSolver3D(cfg, device="cpu")
    got = solver.gather(solver.run(solver.init_state("gaussian"), 9))
    assert got.tobytes() == want.tobytes()
    g = _golden(cfg, golden.make_init("gaussian", shape, seed=2), 9)
    np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-6)


def test_sharded_convergence_and_residual_match_single_shard():
    kw = dict(shape=(16, 12, 10), bcv=0.0)
    one = HeatSolver3D(_cfg(config, mesh=(1, 1, 1), **kw), device="cpu")
    many = HeatSolver3D(_cfg(config, mesh=(2, 2, 2), tb=2, **kw), device="cpu")
    a = one.run_to_convergence(one.init_state("gaussian"), tol=2e-2, max_steps=80)
    b = many.run_to_convergence(many.init_state("gaussian"), tol=2e-2, max_steps=80)
    assert 1 < b.steps < 80 and b.steps == a.steps
    # the psum adds the shards' partial sums in another order: a few ulps
    assert b.residual == pytest.approx(a.residual, rel=1e-5)
    assert many.gather(b.u).tobytes() == one.gather(a.u).tobytes()
    _, r2 = many.step_with_residual(many.init_state("gaussian"))
    _, r1 = one.step_with_residual(one.init_state("gaussian"))
    assert r2.dtype == torch.float32 and float(r2) == pytest.approx(float(r1), rel=1e-5)


ROUTES = [
    # mesh, halo, tb, HEAT3D_NO_DIRECT, grid, backend -> step route, superstep route
    ((1, 1, 1), "ppermute", 2, False, EVEN, "auto", "direct", "direct2"),
    ((1, 1, 1), "dma", 2, False, EVEN, "auto", "exchange", "streamk"),
    (MESH, "ppermute", 1, False, EVEN, "auto", "faces-direct", None),
    (MESH, "ppermute", 2, False, EVEN, "auto", "faces-direct", "faces-direct2"),
    (MESH, "ppermute", 3, False, EVEN, "auto", "faces-direct", "streamk"),
    (MESH, "ppermute", 4, False, EVEN, "auto", "faces-direct", "streamk"),
    (MESH, "ppermute", 1, True, EVEN, "auto", "exchange", None),
    (MESH, "ppermute", 2, True, EVEN, "auto", "exchange", "streamk"),
    (MESH, "dma", 1, False, EVEN, "auto", "exchange", None),
    (MESH, "dma", 2, False, EVEN, "auto", "exchange", "streamk"),
    (MESH, "dma", 4, False, EVEN, "auto", "exchange", "streamk"),
    (MESH, "ppermute", 1, False, UNEVEN, "auto", "exchange", None),
    (MESH, "ppermute", 2, False, UNEVEN, "auto", "exchange", "stepk"),
    (MESH, "dma", 4, False, UNEVEN, "auto", "exchange", "stepk"),
    (MESH, "ppermute", 3, False, EVEN, "jnp", "exchange", "stepk"),
]


@pytest.mark.parametrize("mesh_shape,halo,tb,no_direct,shape,backend,route,super_route", ROUTES)
def test_route_table(monkeypatch, mesh_shape, halo, tb, no_direct, shape, backend, route,
                     super_route):
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    cfg = _cfg(config, shape, mesh_shape, tb=tb, halo=halo, backend=backend)
    assert step.step_route(cfg) == route
    if super_route is not None:
        assert step.superstep_route(cfg) == super_route


def _global_steps(g, taps, bcv, k):
    for _ in range(k):
        g = apply_taps_padded(exchange_halo(g, _bc(False), bcv, 1), taps)
    return g


def test_streamk_edge_mask_on_interior_shard():
    """The middle shard of a (3,1,1) mesh, tb=3, Dirichlet 0.3: the streamk
    plain version with the shard's domain-edge mask equals three padded
    updates of the global field with domain-edge pins; the all-edges mask
    (a whole-domain block's) pins genuine neighbour ring cells and differs."""
    from heat3d_tpu_torch import eqn

    shape, k, bcv = (18, 8, 9), 3, 0.3
    cfg = _cfg(config, shape, (3, 1, 1), bcv=bcv, tb=k)
    taps = eqn.solver_taps(cfg)
    g = torch.from_numpy(_base(shape))
    want = _global_steps(g, taps, bcv, k)
    mesh = topology.build_shard_mesh(cfg, "cpu")
    us = _shards(cfg, mesh, g.numpy())
    pads = ExchangePlan(mesh, _bc(False), k, "ppermute", torch.float32).apply(us, bcv)
    mid = mesh.shards[1]
    assert mid.edges == (False, False, True, True, True, True)
    for s in mesh.shards:
        got = ss.apply_taps_streamk(pads[s.rank], taps, k, False, bcv, edges=s.edges)
        assert torch.equal(got, want[6 * s.rank: 6 * s.rank + 6]), s.rank
    all_edges = ss.apply_taps_streamk(pads[1], taps, k, False, bcv, edges=ss.ALL_EDGES)
    assert not torch.equal(all_edges, want[6:12])
    # the same through the solver (streamk route) and the stepk route
    # (_fill_mid_ghosts with the shard origin)
    for backend in ("auto", "jnp"):
        solver = HeatSolver3D(_cfg(config, shape, (3, 1, 1), bcv=bcv, tb=k,
                                   backend=backend), device="cpu")
        out = solver.run(carry.split_global(g.numpy(), solver.cfg, solver.mesh), k)
        assert torch.equal(torch.from_numpy(solver.gather(out)), want), backend


def test_shard_mesh_topology():
    mesh = _cpu_mesh((2, 3, 1), (4, 5, 6))
    assert len(mesh) == 6
    for s in mesh.shards:
        assert mesh.at(s.coords) is s
        assert s.origin == tuple(c * n for c, n in zip(s.coords, (4, 5, 6)))
        assert s.edges == tuple(e for c, p in zip(s.coords, (2, 3, 1))
                                for e in (c == 0, c == p - 1))
        assert s.stream is None
    for axis, n in enumerate((2, 3, 1)):
        for periodic in (False, True):
            for direction in (+1, -1):
                pairs = {(src, dst) for src, dst in topology.shift_perm(n, direction, periodic)}
                for s in mesh.shards:
                    nb = mesh.neighbor(s, axis, direction, periodic)
                    c = s.coords[axis]
                    if nb is None:
                        assert not any(src == c for src, _ in pairs)
                    else:
                        assert (c, nb.coords[axis]) in pairs


def test_mesh_devices_placement(monkeypatch):
    assert topology.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topology.mesh_devices(2, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert topology.mesh_devices(2, None) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="only 2 visible"):
        topology.mesh_devices(4, None)


def test_carry_split_and_stitch_round_trip():
    cfg = _cfg(config, UNEVEN, bcv=0.3)
    mesh = topology.build_shard_mesh(cfg, "cpu")
    arr = _base(UNEVEN)
    field = carry.split_global(arr, cfg, mesh)
    assert [tuple(t.shape) for t in field.shards] == [cfg.local_shape] * 4
    hi = field[1, 1, 0]  # the shard holding the padding of x and y
    assert (hi[-1] == torch.tensor(0.3)).all() and (hi[:, -1] == torch.tensor(0.3)).all()
    assert carry.stitch_global(field, cfg, mesh).tobytes() == arr.tobytes()
    state = carry.state_from_reference(arr, cfg, "cpu")
    assert isinstance(state, ShardedField)


@pytest.mark.parametrize("argv,route", [
    (["--grid", "16", "12", "10", "--mesh", "2", "2", "1", "--halo", "dma",
      "--time-blocking", "4", "--steps", "9"], "streamk"),
    (["--grid", "15", "11", "10", "--mesh", "2", "2", "1", "--time-blocking", "2",
      "--steps", "5", "--bc-value", "0.3"], "stepk"),
    (["--grid", "16", "--mesh", "2", "--stencil", "27pt", "--time-blocking", "2",
      "--steps", "4"], "faces-direct2"),
])
def test_cli_mesh_golden_check_on_cpu(capsys, argv, route):
    rc = cli.main(argv + ["--golden-check", "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["golden_pass"] and summary["superstep_route"] == route
    assert summary["shards_per_device"] == int(np.prod(summary["mesh"]))
    assert summary["gcell_updates_per_sec"] is None


def test_state_type_checks():
    solver = HeatSolver3D(_cfg(config), device="cpu")
    with pytest.raises(TypeError, match="ShardedField"):
        solver.run(torch.zeros(EVEN), 1)
    with pytest.raises(ValueError, match="shards"):
        solver.run(ShardedField([torch.zeros((8, 6, 10))], MESH), 1)


if __name__ == "__main__":
    _reference(sys.argv[1])
