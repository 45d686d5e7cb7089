"""The port's overlap routes (the fused DMA-overlap and fused RDMA kernels'
plain versions, the fused, 3D-fused and overlap-split steps, the
partitioned exchange plan) against the JAX package on a 4-device CPU mesh,
and against the port's (1,1,1) solve.

The JAX side runs once per worker in a subprocess (this file run as a
script, in the environment tests/test_multidevice.py gives its 4-device
CPU mesh) and writes every case into one ``.npz``:
- the real Pallas fused kernels in interpret mode on a 1D ring ``("x",)``
  of 4 devices at 16^3 (as tests/multidevice_checks.py runs them):
  ``apply_step_fused_dma`` with ``return_ghosts`` and
  ``apply_superstep_fused_dma`` for 7pt/27pt x Dirichlet 1.5/periodic x
  float32/bf16 storage, ``apply_step_fused_rdma`` /
  ``apply_superstep_fused_rdma`` with monolithic and partitioned plans
  (floor 0, so the sub-blocks are real). The port's plain versions
  (``reference_fused_step`` / ``_superstep``) are held to them within
  ``torch_port_checks.assert_close_per_update``; the landed ghost planes,
  bc substituted at the Dirichlet x domain faces, byte for byte;
- the JAX solver with ``HEAT3D_DIRECT_INTERPRET=1`` (which dispatches the
  fused kernels' XLA reference contracts) on every new route: ``overlap``
  + ``dma`` on (4,1,1) at tb 1 and 2 (odd step counts, so the remainder
  step runs) and on (2,2,1) (the 3D route), ``fused_rdma='on'`` on
  (4,1,1) at tb 1 and 2, monolithic and partitioned, ``overlap`` +
  ``ppermute`` under ``HEAT3D_NO_DIRECT`` (the overlap split) and
  ``halo_plan='partitioned'`` on the exchange path. The port runs each on
  the CPU; both are also held to the fp64 golden oracle at the
  tests/test_torch_solver.py tier;
- the partitioned exchange plan's padded blocks on (2,2,1), held byte-equal
  to the port's partitioned and monolithic plans.

The port alone: every new route equals the (1,1,1) solve bitwise, the
route table, the gates against the JAX gates (pure functions), the plan's
partition bounds against the JAX plan's, the config and route errors
against the JAX package's, the x-ghost seeding of the faces exchange, the
fused state's argument checks and the new command-line flags.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat3d_tpu_torch import cli
from heat3d_tpu_torch.core import config, golden
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.ops import stencil_dma_fused as fd
from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
from heat3d_tpu_torch.parallel import plan as port_plan
from heat3d_tpu_torch.parallel import step, topology
from heat3d_tpu_torch.parallel.plan import ExchangePlan, FacesPlan
from torch_port_checks import assert_close_per_update

GRID = (16, 16, 16)
RING = (4, 1, 1)
STORAGE = ("float32", "bfloat16")
# (stencil, periodic, bc value, storage) of the kernel cases of rows 9-10
KCASES = [(k, p, 0.0 if p else 1.5, s) for k in ("7pt", "27pt") for p in (False, True)
          for s in STORAGE]
# (row kernel, plan mode, stencil, periodic, storage) of rows 11-12
RCASES = [(tb, mode, k, p, s) for tb in (1, 2) for mode, k, p, s in (
    ("partitioned", "27pt", False, "float32"), ("monolithic", "7pt", True, "bfloat16"))]
# the JAX solver's cases: mesh, knobs, env, steps
SOLVES = {
    "dma_overlap1": dict(mesh=RING, kw=dict(overlap=True, halo="dma"), steps=5,
                         kind="7pt", periodic=False, bcv=0.3),
    "dma_overlap2": dict(mesh=RING, kw=dict(overlap=True, halo="dma", time_blocking=2),
                         steps=5, kind="27pt", periodic=True, bcv=0.0),
    "dma_overlap_3d": dict(mesh=(2, 2, 1), kw=dict(overlap=True, halo="dma"), steps=4,
                           kind="27pt", periodic=False, bcv=0.3),
    "rdma1_mono": dict(mesh=RING, kw=dict(fused_rdma="on"), steps=4, kind="7pt",
                       periodic=False, bcv=0.3),
    "rdma2_mono": dict(mesh=RING, kw=dict(fused_rdma="on", time_blocking=2), steps=5,
                       kind="7pt", periodic=True, bcv=0.0),
    "rdma1_part": dict(mesh=RING, kw=dict(fused_rdma="on", halo_plan="partitioned"),
                       steps=4, kind="27pt", periodic=True, bcv=0.0, part0=True),
    "rdma2_part": dict(mesh=RING, kw=dict(fused_rdma="on", halo_plan="partitioned",
                                          time_blocking=2),
                       steps=5, kind="27pt", periodic=False, bcv=0.3, part0=True),
    "overlap_split": dict(mesh=(2, 2, 1), kw=dict(overlap=True), steps=4, kind="27pt",
                          periodic=False, bcv=0.3, no_direct=True),
    "partitioned1": dict(mesh=(2, 2, 1), kw=dict(halo_plan="partitioned"), steps=4,
                         kind="7pt", periodic=True, bcv=0.0, part0=True),
    "partitioned2": dict(mesh=(2, 2, 1), kw=dict(halo_plan="partitioned", time_blocking=2),
                         steps=5, kind="27pt", periodic=False, bcv=0.3, part0=True),
}
ROUTE_OF = {
    "dma_overlap1": ("fused-dma", None), "dma_overlap2": ("fused-dma", "fused-dma2"),
    "dma_overlap_3d": ("fused-dma-3d", None), "rdma1_mono": ("fused-rdma", None),
    "rdma2_mono": ("fused-rdma", "fused-rdma2"), "rdma1_part": ("fused-rdma", None),
    "rdma2_part": ("fused-rdma", "fused-rdma2"), "overlap_split": ("overlap", None),
    "partitioned1": ("exchange", None), "partitioned2": ("exchange", "stepk"),
}
PEX = [(w, p, b) for w in (1, 2) for p, b in ((False, 0.3), (True, 0.0))]


def _base(shape=GRID, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _taps(m, kind):
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps

    g = m.GridConfig(shape=GRID)
    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


def _kkey(kind, periodic, storage):
    return f"{kind}_p{int(periodic)}_{storage}"


def _cfg(m, name):
    case = SOLVES[name]
    bc = m.BoundaryCondition.PERIODIC if case["periodic"] else m.BoundaryCondition.DIRICHLET
    return m.SolverConfig(
        grid=m.GridConfig(shape=GRID),
        stencil=m.StencilConfig(kind=case["kind"], bc=bc, bc_value=case["bcv"]),
        mesh=m.MeshConfig(shape=case["mesh"]), run=m.RunConfig(seed=3), **case["kw"],
    )


def _case_env(case) -> dict:
    env = {}
    if case.get("no_direct"):
        env["HEAT3D_NO_DIRECT"] = "1"
    if case.get("part0"):
        env["HEAT3D_PLAN_PART_MIN_BYTES"] = "0"
    return env


def _reference(path: str) -> None:
    """Every JAX case (needs 4 JAX devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    import heat3d_tpu.ops.stencil_dma_fused as jfd
    import heat3d_tpu.ops.stencil_fused_rdma as jfr
    from heat3d_tpu.core import config as rc
    from heat3d_tpu.models.heat3d import HeatSolver3D as RefSolver
    from heat3d_tpu.parallel.plan import build_plan, clear_plan_cache
    from heat3d_tpu.parallel.topology import build_mesh, field_sharding
    from heat3d_tpu.utils.compat import shard_map

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    out = {}
    ring = Mesh(np.array(jax.devices()[:4]).reshape(4), ("x",))
    spec = P("x")
    kw = dict(axis_name="x", axis_size=4, mesh_axes=("x",), interpret=True)

    def run(fn, u, n_out=1):
        return jax.jit(shard_map(fn, mesh=ring, in_specs=spec,
                                 out_specs=spec if n_out == 1 else (spec,) * n_out,
                                 check_vma=False))(u)

    for storage in STORAGE:
        u = jax.device_put(jnp.asarray(_base()).astype(getattr(jnp, storage)),
                           NamedSharding(ring, spec))
        for kind, periodic, bcv, s in KCASES:
            if s != storage:
                continue
            taps = _taps(rc, kind)
            key = _kkey(kind, periodic, storage)
            o, glo, ghi = run(lambda x: jfd.apply_step_fused_dma(
                x, taps, periodic=periodic, bc_value=bcv, return_ghosts=True, **kw), u, 3)
            out["k9_" + key], out["k9glo_" + key], out["k9ghi_" + key] = f32(o), f32(glo), f32(ghi)
            out["k10_" + key] = f32(run(lambda x: jfd.apply_superstep_fused_dma(
                x, taps, periodic=periodic, bc_value=bcv, **kw), u))
        for tb, mode, kind, periodic, s in RCASES:
            if s != storage:
                continue
            taps = _taps(rc, kind)
            bc = rc.BoundaryCondition.PERIODIC if periodic else rc.BoundaryCondition.DIRICHLET
            plan = build_plan(rc.MeshConfig(shape=RING), bc, width=tb, mode=mode,
                              min_part_bytes=0)
            fn = jfr.apply_step_fused_rdma if tb == 1 else jfr.apply_superstep_fused_rdma
            out[f"r{tb}_{mode}_" + _kkey(kind, periodic, storage)] = f32(run(
                lambda x: fn(x, taps, plan=plan, periodic=periodic,
                             bc_value=0.0 if periodic else 1.5, **kw), u))
            out[f"r{tb}_{mode}_bounds"] = np.array(
                plan.face_partition_bounds(0, (4, 16, 16), 4))

    # the partitioned exchange on (2,2,1)
    mcfg = rc.MeshConfig(shape=(2, 2, 1))
    mesh = build_mesh(mcfg, jax.devices()[:4])
    mspec = P(*mcfg.axis_names)
    u = jax.device_put(jnp.asarray(_base()), field_sharding(mesh, mcfg))
    for w, periodic, bcv in PEX:
        bc = rc.BoundaryCondition.PERIODIC if periodic else rc.BoundaryCondition.DIRICHLET
        plan = build_plan(mcfg, bc, width=w, mode="partitioned", min_part_bytes=0)
        out[f"pex_w{w}_p{int(periodic)}"] = f32(jax.jit(shard_map(
            lambda x: plan.apply(x, bcv), mesh=mesh, in_specs=mspec, out_specs=mspec,
            check_vma=False))(u))

    os.environ["HEAT3D_DIRECT_INTERPRET"] = "1"
    for name, case in SOLVES.items():
        for k in ("HEAT3D_NO_DIRECT", "HEAT3D_PLAN_PART_MIN_BYTES"):
            os.environ.pop(k, None)
        os.environ.update(_case_env(case))
        clear_plan_cache()
        ref = RefSolver(_cfg(rc, name), devices=jax.devices()[:4])
        u0 = ref.init_state("random")
        out["u0_" + name] = f32(ref.gather(u0))
        out["out_" + name] = f32(ref.gather(ref.run(u0, case["steps"])))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    from test_multidevice import _cpu_mesh_env

    path = str(tmp_path_factory.mktemp("fused_ref") / "ref.npz")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), path],
        env=_cpu_mesh_env(4), capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, f"JAX reference failed:\n{proc.stderr[-4000:]}"
    return np.load(path)


def _cpu_mesh(shape, local):
    return topology.ShardMesh(shape, local, [torch.device("cpu")] * int(np.prod(shape)))


def _ring_shards(storage):
    """The 16^3 field's four x-slab shards, rounded to ``storage`` as the
    JAX side rounds them."""
    dtype = getattr(torch, storage)
    full = torch.from_numpy(_base()).to(dtype)
    mesh = _cpu_mesh(RING, (4, 16, 16))
    return mesh, [full[4 * i: 4 * i + 4].contiguous() for i in range(4)]


def _stack(ts) -> np.ndarray:
    return torch.cat([t.float() for t in ts]).numpy()


# ---- kernel level: the plain versions against the Pallas kernels ------------


@pytest.mark.parametrize("kind,periodic,bcv,storage", KCASES)
def test_fused_dma_plain_versions_equal_pallas_kernels(jax_ref, kind, periodic, bcv, storage):
    mesh, us = _ring_shards(storage)
    taps = _taps(config, kind)
    key = _kkey(kind, periodic, storage)
    outs, ghosts = fd.apply_step_fused_dma(us, taps, mesh, None, periodic, bcv,
                                           return_ghosts=True)
    assert_close_per_update(_stack(outs), jax_ref["k9_" + key], storage, 1, err_msg=key)
    # the landed planes: the JAX kernel's are the raw ring transfer, so the
    # Dirichlet x domain faces read bc only after substitution
    glo = jax_ref["k9glo_" + key].reshape(4, 16, 16).copy()
    ghi = jax_ref["k9ghi_" + key].reshape(4, 16, 16).copy()
    if not periodic:
        glo[0] = np.float32(torch.tensor(bcv, dtype=getattr(torch, storage)).float())
        ghi[3] = glo[0, 0, 0]
    got_lo = np.stack([g[0].float().numpy() for g in ghosts])
    got_hi = np.stack([g[1].float().numpy() for g in ghosts])
    assert got_lo.tobytes() == glo.tobytes() and got_hi.tobytes() == ghi.tobytes()
    two = fd.apply_superstep_fused_dma(us, taps, mesh, None, periodic, bcv)
    assert_close_per_update(_stack(two), jax_ref["k10_" + key], storage, 2, err_msg=key)


@pytest.mark.parametrize("tb,mode,kind,periodic,storage", RCASES)
def test_fused_rdma_plain_versions_equal_pallas_kernels(jax_ref, tb, mode, kind, periodic,
                                                        storage):
    mesh, us = _ring_shards(storage)
    taps = _taps(config, kind)
    bcv = 0.0 if periodic else 1.5
    sched = port_plan.Schedule(RING, tb, mode, min_part_bytes=0)
    bounds = fr.plan_send_bounds(sched, (4, 16, 16), 4)
    assert np.array(bounds).tolist() == jax_ref[f"r{tb}_{mode}_bounds"].tolist()
    assert len(bounds) == (2 if mode == "partitioned" else 1)
    state = fd.FusedState(mesh, tb, getattr(torch, storage), periodic, bounds)
    fn = fr.apply_step_fused_rdma if tb == 1 else fr.apply_superstep_fused_rdma
    got = fn(us, taps, mesh, state, periodic, bcv)
    want = jax_ref[f"r{tb}_{mode}_" + _kkey(kind, periodic, storage)]
    assert_close_per_update(_stack(got), want, storage, tb)
    plain = (fr.reference_fused_rdma_step if tb == 1 else fr.reference_fused_rdma_superstep)(
        us, taps, mesh, periodic, bcv)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


# ---- the solver against JAX --------------------------------------------------


def _golden(cfg, u0, steps):
    from heat3d_tpu_torch import eqn

    return golden.run(u0.astype(np.float64), cfg.grid, cfg.stencil, steps,
                      taps=eqn.solver_taps(cfg))


@pytest.mark.parametrize("name", list(SOLVES))
def test_overlap_routes_match_jax_and_golden(jax_ref, monkeypatch, name):
    case = SOLVES[name]
    for k, v in _case_env(case).items():
        monkeypatch.setenv(k, v)
    cfg = _cfg(config, name)
    route, super_route = ROUTE_OF[name]
    assert step.step_route(cfg) == route
    if super_route is not None:
        assert step.superstep_route(cfg) == super_route
    solver = HeatSolver3D(cfg, device="cpu")
    u0 = jax_ref["u0_" + name]
    got = solver.gather(solver.run(solver.init_state(u0), case["steps"]))
    want = jax_ref["out_" + name]
    assert got.shape == cfg.grid.shape
    assert_close_per_update(got, want, "float32", case["steps"], err_msg=name)
    g = _golden(cfg, u0, case["steps"])
    np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want, g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("width,periodic,bcv", PEX)
def test_partitioned_exchange_equals_jax_and_monolithic(jax_ref, monkeypatch, width,
                                                        periodic, bcv):
    monkeypatch.setenv("HEAT3D_PLAN_PART_MIN_BYTES", "0")
    bc = config.BoundaryCondition.PERIODIC if periodic else config.BoundaryCondition.DIRICHLET
    mesh = _cpu_mesh((2, 2, 1), (8, 8, 16))
    full = torch.from_numpy(_base())
    us = [full[tuple(slice(o, o + n) for o, n in zip(s.origin, mesh.local_shape))].contiguous()
          for s in mesh.shards]
    part = ExchangePlan(mesh, bc, width, "ppermute", torch.float32, "partitioned")
    assert part.schedule.face_partition_bounds(0, mesh.local_shape, 4) == ((0, 4), (4, 8))
    mono = ExchangePlan(mesh, bc, width, "ppermute", torch.float32)
    a, b = part.apply(us, bcv), mono.apply(us, bcv)
    want = jax_ref[f"pex_w{width}_p{int(periodic)}"]
    got = np.empty(want.shape, np.float32)
    m = [n + 2 * width for n in mesh.local_shape]
    for s, x in zip(mesh.shards, a):
        got[tuple(slice(c * n, (c + 1) * n) for c, n in zip(s.coords, m))] = x.numpy()
    assert got.tobytes() == want.tobytes()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- the port against itself -------------------------------------------------

BITWISE = [
    # mesh, knobs, HEAT3D_NO_DIRECT
    ((4, 1, 1), dict(overlap=True, halo="dma"), False),
    ((4, 1, 1), dict(overlap=True, halo="dma", time_blocking=2), False),
    ((2, 2, 2), dict(overlap=True, halo="dma"), False),
    ((2, 1, 3), dict(overlap=True, halo="dma"), False),
    ((4, 1, 1), dict(fused_rdma="on"), False),
    ((4, 1, 1), dict(fused_rdma="on", halo_plan="partitioned", time_blocking=2), False),
    ((2, 2, 2), dict(overlap=True), True),
    ((2, 2, 2), dict(overlap=True, backend="jnp"), False),
    ((1, 1, 1), dict(overlap=True), True),
    ((2, 3, 1), dict(halo_plan="partitioned", time_blocking=3), False),
]


@pytest.mark.parametrize("periodic,kind,storage", [
    (False, "7pt", "float32"), (True, "27pt", "float32"), (False, "27pt", "bfloat16")])
@pytest.mark.parametrize("mesh_shape,kw,no_direct", BITWISE)
def test_overlap_routes_equal_single_shard_bitwise(monkeypatch, mesh_shape, kw, no_direct,
                                                   periodic, kind, storage):
    monkeypatch.setenv("HEAT3D_PLAN_PART_MIN_BYTES", "0")
    shape = (16, 12, 18)
    bc = config.BoundaryCondition.PERIODIC if periodic else config.BoundaryCondition.DIRICHLET

    def solve(mesh, **knobs):
        cfg = config.SolverConfig(
            grid=config.GridConfig(shape=shape),
            stencil=config.StencilConfig(kind=kind, bc=bc, bc_value=0.0 if periodic else 0.3),
            mesh=config.MeshConfig(shape=mesh), precision=config.Precision(storage=storage),
            **knobs)
        s = HeatSolver3D(cfg, device="cpu")
        return s.gather(s.run(s.init_state("random"), 5))

    want = solve((1, 1, 1))
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    assert solve(mesh_shape, **kw).tobytes() == want.tobytes()


ROUTES = [
    # mesh, knobs, grid, HEAT3D_NO_DIRECT -> step route, superstep route
    ((4, 1, 1), dict(overlap=True, halo="dma"), GRID, False, "fused-dma", None),
    ((4, 1, 1), dict(overlap=True, halo="dma", time_blocking=2), GRID, False,
     "fused-dma", "fused-dma2"),
    ((4, 1, 1), dict(overlap=True, halo="dma"), GRID, True, "fused-dma", None),
    ((2, 2, 1), dict(overlap=True, halo="dma"), GRID, False, "fused-dma-3d", None),
    ((2, 1, 2), dict(overlap=True, halo="dma"), GRID, False, "fused-dma-3d", None),
    ((4, 1, 1), dict(fused_rdma="on"), GRID, False, "fused-rdma", None),
    ((4, 1, 1), dict(fused_rdma="on", time_blocking=2), GRID, False, "fused-rdma",
     "fused-rdma2"),
    ((4, 1, 1), dict(fused_rdma="on", halo_plan="partitioned", time_blocking=2), GRID,
     False, "fused-rdma", "fused-rdma2"),
    ((2, 2, 1), dict(fused_rdma="on"), GRID, False, "faces-direct", None),
    ((4, 1, 1), dict(fused_rdma="on", backend="jnp"), GRID, False, "exchange", None),
    ((8, 1, 1), dict(fused_rdma="on", time_blocking=2), GRID, False, "fused-rdma",
     "faces-direct2"),
    ((4, 1, 1), dict(fused_rdma="on"), (15, 16, 16), False, "exchange", None),
    ((2, 2, 1), dict(overlap=True), GRID, False, "faces-direct", None),
    ((2, 2, 1), dict(overlap=True), GRID, True, "overlap", None),
    ((2, 2, 1), dict(overlap=True, backend="conv"), GRID, False, "overlap", None),
    ((2, 2, 1), dict(overlap=True), (15, 16, 16), False, "overlap", None),
    ((1, 1, 1), dict(overlap=True), GRID, False, "direct", None),
    ((2, 2, 1), dict(halo_plan="partitioned"), GRID, False, "exchange", None),
    ((2, 2, 1), dict(halo_plan="partitioned", time_blocking=2), GRID, False, "exchange",
     "stepk"),
    ((2, 2, 1), dict(halo_plan="partitioned", time_blocking=4), GRID, False, "exchange",
     "stepk"),
]


@pytest.mark.parametrize("mesh_shape,kw,shape,no_direct,route,super_route", ROUTES)
def test_overlap_route_table(monkeypatch, mesh_shape, kw, shape, no_direct, route,
                             super_route):
    if no_direct:
        monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    cfg = config.SolverConfig(grid=config.GridConfig(shape=shape),
                              mesh=config.MeshConfig(shape=mesh_shape), **kw)
    assert step.step_route(cfg) == route
    if super_route is not None:
        assert step.superstep_route(cfg) == super_route


def test_fused_rdma_env_override(monkeypatch):
    cfg = config.SolverConfig(grid=config.GridConfig(shape=GRID),
                              mesh=config.MeshConfig(shape=RING))
    assert step.resolve_fused_rdma(cfg) == "off" and step.step_route(cfg) == "faces-direct"
    monkeypatch.setenv("HEAT3D_FUSED_RDMA", "1")
    assert step.resolve_fused_rdma(cfg) == "on" and step.step_route(cfg) == "fused-rdma"
    monkeypatch.setenv("HEAT3D_FUSED_RDMA", "off")
    on = config.SolverConfig(grid=config.GridConfig(shape=GRID),
                             mesh=config.MeshConfig(shape=RING), fused_rdma="on")
    assert step.resolve_fused_rdma(on) == "off" and step.step_route(on) == "faces-direct"


# ---- gates, plans and errors against the JAX package ---------------------------

GATE_SHAPES = [(4, 16, 16), (2, 8, 8), (1, 16, 16), (3, 16, 16), (4, 8, 24), (8, 16, 16)]
GATE_MESHES = [(4, 1, 1), (2, 1, 1), (1, 4, 1), (2, 2, 1), (2, 1, 2), (1, 1, 1), (4, 2, 2)]


@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("gate", ["fused_dma_supported", "fused_dma_3d_supported",
                                  "fused_dma2_supported", "fused_rdma_supported",
                                  "fused_rdma2_supported"])
def test_gates_equal_jax_gates(gate, kind):
    import heat3d_tpu.ops.stencil_dma_fused as jfd
    import heat3d_tpu.ops.stencil_fused_rdma as jfr

    ref = getattr(jfd, gate, None) or getattr(jfr, gate)
    port = getattr(fd, gate, None) or getattr(fr, gate)
    from heat3d_tpu.core import config as rc

    taps = _taps(rc, kind)
    for shape in GATE_SHAPES:
        for mesh in GATE_MESHES:
            for item in (4, 2):
                assert port(shape, mesh, taps, item, item) == ref(shape, mesh, taps, item, item), (
                    gate, shape, mesh, item)


def test_gates_have_no_vmem_rule():
    """The JAX gates also hold a shard's resident ghost planes and plane
    ring to the TPU's VMEM; the CUDA kernel keeps the ghosts in device
    memory and tiles (y, z), so a shard the JAX gate rejects on VMEM alone
    is in the port's scope (the routing then differs, the values do not:
    ROADMAP Queue 3)."""
    import heat3d_tpu.ops.stencil_dma_fused as jfd

    shape, mesh = (4, 2048, 2048), (4, 1, 1)
    taps = _taps(config, "7pt")
    assert not jfd.fused_dma_supported(shape, mesh, taps)
    assert not jfd.fused_dma2_supported(shape, mesh, taps)
    assert fd.fused_dma_supported(shape, mesh, taps)
    assert fd.fused_dma2_supported(shape, mesh, taps)


def test_partition_bounds_equal_jax(monkeypatch):
    from heat3d_tpu.core import config as rc
    from heat3d_tpu.parallel import plan as jplan

    for extent in range(1, 12):
        for parts in range(1, 6):
            assert port_plan.partition_bounds(extent, parts) == jplan.partition_bounds(
                extent, parts)
    for floor in (None, "0", "4096", "x"):
        if floor is None:
            monkeypatch.delenv("HEAT3D_PLAN_PART_MIN_BYTES", raising=False)
        else:
            monkeypatch.setenv("HEAT3D_PLAN_PART_MIN_BYTES", floor)
        assert port_plan.part_min_bytes() == jplan.part_min_bytes()
        for mesh in ((4, 1, 1), (2, 2, 1), (2, 2, 2), (1, 3, 1)):
            for width in (1, 2, 4):
                for mode in ("monolithic", "partitioned"):
                    ref = jplan.build_plan(rc.MeshConfig(shape=mesh),
                                           rc.BoundaryCondition.DIRICHLET, width=width,
                                           mode=mode)
                    ours = port_plan.Schedule(mesh, width, mode,
                                              min_part_bytes=port_plan.part_min_bytes())
                    assert ours.messages_per_exchange() == ref.messages_per_exchange()
                    for local in ((8, 64, 64), (16, 512, 512), (4, 3, 1024)):
                        for item in (2, 4):
                            for axis in range(3):
                                assert ours.face_partition_bounds(axis, local, item) == \
                                    ref.face_partition_bounds(axis, local, item)
                            assert ours.traffic(local, item) == ref.traffic(local, item)


def test_effective_halo_plan(monkeypatch):
    cfg = config.SolverConfig(grid=config.GridConfig(shape=GRID),
                              mesh=config.MeshConfig(shape=RING), halo_plan="partitioned")
    assert port_plan.effective_halo_plan(cfg) == "partitioned"
    monkeypatch.setenv("HEAT3D_NO_PLAN", "1")
    assert port_plan.effective_halo_plan(cfg) == "monolithic"
    assert step.make_exchanges(cfg, _cpu_mesh(RING, (4, 16, 16))).mode == "monolithic"


ERRORS = [
    # knobs, mesh, which step maker raises, the JAX message's words
    (dict(overlap=True, time_blocking=3), (2, 2, 1), "superstep", "mutually exclusive"),
    (dict(overlap=True, time_blocking=2), (2, 2, 1), "superstep", "mutually exclusive"),
    (dict(overlap=True, halo="dma", time_blocking=2), (2, 2, 1), "superstep",
     "mutually exclusive"),
    (dict(overlap=True, halo="dma"), (1, 2, 2), "step", "needs the fused DMA-overlap"),
    (dict(overlap=True, halo="dma"), (1, 1, 1), "step", "needs the fused DMA-overlap"),
    (dict(overlap=True), (8, 1, 1), "step", "local blocks >= 3"),
]


@pytest.mark.parametrize("kw,mesh,maker,words", ERRORS)
def test_route_errors_match_jax(monkeypatch, kw, mesh, maker, words):
    from heat3d_tpu.core import config as rc
    from heat3d_tpu.parallel import step as jstep

    def make(m):
        return m.SolverConfig(grid=m.GridConfig(shape=GRID),
                              mesh=m.MeshConfig(shape=mesh), **kw)

    jmake = jstep.make_superstep_fn if maker == "superstep" else jstep.make_step_fn
    with pytest.raises(ValueError, match=words):
        jmake(make(rc), None)
    cfg = make(config)
    mesh_t = topology.build_shard_mesh(cfg, "cpu")
    port_make = step.make_superstep_fn if maker == "superstep" else step.make_step_fn
    # the JAX package has no direct route on the CPU
    monkeypatch.setenv("HEAT3D_NO_DIRECT", "1")
    with pytest.raises(ValueError, match=words):
        port_make(cfg, mesh_t)


@pytest.mark.parametrize("kw,words", [
    (dict(fused_rdma="on", halo="dma"), "'dma' exchange"),
    (dict(fused_rdma="on", overlap=True), "mutually exclusive"),
    (dict(fused_rdma="on", time_blocking=3), "k <= 2"),
    (dict(halo_plan="partitioned", halo="dma"), "ppermute"),
])
def test_config_errors_match_jax(kw, words):
    from heat3d_tpu.core import config as rc

    for m in (rc, config):
        with pytest.raises(ValueError, match=words):
            m.SolverConfig(grid=m.GridConfig(shape=GRID), mesh=m.MeshConfig(shape=RING), **kw)


# ---- pieces ----------------------------------------------------------------------


def test_faces_exchange_seeded_with_x_ghosts_equals_plain():
    """The 3D route's seeding: x faces from the fused step's landed planes
    give the faces exchange's own faces, corners included."""
    taps = _taps(config, "27pt")
    for periodic, bcv in ((False, 0.3), (True, 0.0)):
        bc = config.BoundaryCondition.PERIODIC if periodic else config.BoundaryCondition.DIRICHLET
        mesh = _cpu_mesh((2, 2, 2), (4, 6, 8))
        us = [torch.from_numpy(_base((4, 6, 8), seed=s.rank)) for s in mesh.shards]
        _, ghosts = fd.apply_step_fused_dma(us, taps, mesh, None, periodic, bcv,
                                            return_ghosts=True)
        want = FacesPlan(mesh, bc, 1, torch.float32).apply(us, bcv)
        got = FacesPlan(mesh, bc, 1, torch.float32).apply(us, bcv, x_ghosts=ghosts)
        for f, g in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(f, g))


def test_fused_state_and_wrapper_checks():
    mesh = _cpu_mesh(RING, (4, 16, 16))
    with pytest.raises(ValueError, match="tile"):
        fd.FusedState(mesh, 1, torch.float32, False, ((0, 8), (9, 16)))
    with pytest.raises(ValueError, match="send ranges"):
        fd.FusedState(mesh, 1, torch.float32, False, tuple((i, i + 1) for i in range(16)))
    with pytest.raises(ValueError, match="width 1 or 2"):
        fd.FusedState(mesh, 3, torch.float32, False)
    with pytest.raises(ValueError, match="along x"):
        fd.FusedState(_cpu_mesh((1, 4, 1), (16, 4, 16)), 1, torch.float32, False)
    state = fd.FusedState(mesh, 1, torch.float32, False, ((0, 8), (8, 16)))
    assert state.bounds == ((0, 8), (8, 16)) and state.groups == []
    small = _cpu_mesh(RING, (2, 8, 8))
    us = [torch.zeros((2, 8, 8)) for _ in range(4)]
    with pytest.raises(ValueError, match="nx >= 4"):
        fd.apply_superstep_fused_dma(us, _taps(config, "7pt"), small)
    before = fd.launch_counts()
    fd.apply_step_fused_dma(us, _taps(config, "7pt"), small)
    assert fd.launch_counts() == before  # the plain version launches nothing


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("periodic,bcv", [(False, 0.3), (True, 0.0)], ids=["dir0.3", "periodic"])
def test_fused_plain_versions_keep_the_chain_under_mehrstellen(monkeypatch, periodic, bcv,
                                                               storage):
    """Under ``HEAT3D_MEHRSTELLEN`` the fused wrappers (DMA and RDMA, one
    and two updates) run the tap chain, as the JAX fused kernels do: their
    plain versions, which the CPU wrappers run, equal their knob-off
    results bitwise, and the instance stays the chain's."""
    mesh = _cpu_mesh(RING, (4, 9, 11))
    taps = _taps(config, "27pt")
    rng = np.random.default_rng(12)
    us = [torch.from_numpy(rng.standard_normal((4, 9, 11)).astype(np.float32)).to(storage)
          for _ in range(4)]
    wrappers = (fd.apply_step_fused_dma, fd.apply_superstep_fused_dma,
                fr.apply_step_fused_rdma, fr.apply_superstep_fused_rdma)

    def run():
        return [[t.clone() for t in w(us, taps, mesh, None, periodic, bcv)] for w in wrappers]

    monkeypatch.delenv("HEAT3D_MEHRSTELLEN", raising=False)
    off = run()
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1")
    on = run()
    for w, a, b in zip(wrappers, off, on):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), w.__name__
    assert fd.fused_instance(1, taps) == fd.fused_instance(2, taps) == 2


@pytest.mark.parametrize("kind,knobs,want", [
    ("7pt", {}, 1), ("27pt", {}, 2),
    ("7pt", {"HEAT3D_FACTOR_7PT": "1"}, 0), ("27pt", {"HEAT3D_FACTOR_Y": "0"}, 0)])
def test_fused_instance_choice(monkeypatch, kind, knobs, want):
    """The one- and two-update fused kernels run the 7pt and 27pt chains on
    their compile-time instances (the stream kernels' table) and any other
    chain on the generic one."""
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    taps = _taps(config, kind)
    assert fd.fused_instance(1, taps) == want
    assert fd.fused_instance(2, taps) == want


def test_fused_build_takes_the_chain_table(monkeypatch):
    """The fused source is built with the stream kernels' chain table (its
    compile-time instances are those chains), and its library name follows
    the table, so an edited table rebuilds it."""
    from heat3d_tpu_torch.ops import _build
    from heat3d_tpu_torch.ops import stencil_stream as ss

    assert _build.source_flags("stencil_fused") == ss.nvcc_defines()
    before = _build._target("stencil_fused")
    chains = dict(ss.CHAINS)
    chains[1] = ("7pt", ss.CHAINS[1][1][::-1])
    monkeypatch.setattr(ss, "CHAINS", chains)
    assert _build._target("stencil_fused") != before
    monkeypatch.undo()
    assert _build._target("stencil_fused") == before


# the (y, z) output tile of the compile-time instances by halo: Geom<H> of
# csrc/stencil_chain.cuh (a 40 x 64 or 32 x 64 frame less 2H a side)
_CHAIN_TILE = {1: (38, 62), 2: (28, 60)}


def _kernel_tiles(local_shape, nlocal: int, xchunk: int, halo: int = 1):
    """The tiles of the kernels of ``halo`` updates as
    ``fused_chain_kernel<T, H, S>`` (and ``fused_kernel<T, H>``) walk them:
    ``interior``, (local shard, first output plane, end plane) per x-chunk
    of the planes [H, nx - H), and ``skin``, the planes [0, H) and
    [nx - H, nx) per shard; each also covers every (y, z) tile of its
    shard."""
    nx = local_shape[0]
    inner = nx - 2 * halo
    nchunks = -(-inner // xchunk) if inner > 0 else 0
    interior = [(li, halo + c * xchunk, min(nx - halo, halo + (c + 1) * xchunk))
                for li in range(nlocal) for c in range(nchunks)]
    skin = [(li, 0 if side == 0 else nx - halo, halo if side == 0 else nx)
            for li in range(nlocal) for side in (0, 1)]
    return interior, skin


_TILE_LOCALS = {1: [(2, 40, 70), (3, 9, 66), (16, 20, 70), (128, 1024, 1024),
                    (256, 1024, 1024), (37, 77, 125)],
                2: [(4, 77, 125), (5, 9, 66), (16, 20, 70), (128, 1024, 1024),
                    (256, 1024, 1024), (37, 77, 125)]}


@pytest.mark.parametrize("halo,local", [
    pytest.param(h, local, id=f"{'' if h == 1 else 'h2-'}local{i}")
    for h, locals_ in _TILE_LOCALS.items() for i, local in enumerate(locals_)])
@pytest.mark.parametrize("nlocal,resident", [(1, 1), (4, 528), (8, 528), (2, 660)])
def test_fused_tiles_cover_each_plane_once(halo, local, nlocal, resident):
    """The tiles of the kernel of ``halo`` updates at the x-chunk the host
    computes for a compile-time instance: every output plane of every shard
    is in exactly one tile; an interior tile's input planes [x0 - H,
    x1 + H) lie inside the shard (no x ghost, so it never waits), a skin
    tile's include an x ghost plane."""
    nx, ny, nz = local
    ty, tz = _CHAIN_TILE[halo]
    tiles_yz = nlocal * -(-ny // ty) * -(-nz // tz)
    xchunk = fd.wave_xchunk(nx - 2 * halo, tiles_yz, resident, waves=fd._WAVES[halo])
    assert xchunk >= 1
    interior, skin = _kernel_tiles(local, nlocal, xchunk, halo)
    for li in range(nlocal):
        planes = []
        for sh, x0, x1 in interior:
            if sh == li:
                assert 0 <= x0 - halo and x1 + halo <= nx, (x0, x1)
                planes += range(x0, x1)
        for sh, x0, x1 in skin:
            if sh == li:
                assert x0 - halo < 0 or x1 + halo > nx, (x0, x1)
                planes += range(x0, x1)
        assert sorted(planes) == list(range(nx))
    assert len(skin) == 2 * nlocal
    # no more chunks than the floor on their length allows (each at least
    # half the floor, but the last of a shard, which takes the rest), and no
    # more than the waves need
    floor = min(fd._MIN_CHAIN_XCHUNK, nx - 2 * halo)
    assert all(x1 - x0 >= floor // 2 for _, x0, x1 in interior if x1 < nx - halo)
    assert len(interior) // nlocal <= max(1, -(-fd._WAVES[halo] * resident // tiles_yz))


def _push_runs(width, y0, y1, ny, nz, ntiles, chunk):
    """The element runs the push tiles of one send copy, as
    ``push_flat<T, H>`` cuts them: tile t takes elements [t * chunk,
    (t + 1) * chunk) of the send's ``width`` runs of (y1 - y0) * nz laid end
    to end, split where a run ends; each (plane, start, length) in the
    (ny, nz) plane's flat index."""
    run = (y1 - y0) * nz
    cuts = []
    for t in range(ntiles):
        lo, hi = t * chunk, min((t + 1) * chunk, width * run)
        for q in range(width):
            b, e = max(lo, q * run), min(hi, (q + 1) * run)
            if b < e:
                cuts.append((q, y0 * nz + b - q * run, e - b))
    return cuts


@pytest.mark.parametrize("chunk", [256 * 128, 2048])
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("ny,nz,parts", [(40, 70, 1), (40, 70, 2), (77, 125, 3),
                                         (9, 66, 2), (1024, 1024, 2)])
def test_fused_push_tiles_cover_each_send_once(width, ny, nz, parts, chunk):
    """The push tiles the host lays out for each send (``FusedState``:
    ceil(width * (y1 - y0) * nz / chunk) a send; ``chunk`` the kernel's
    PUSH_CHUNK, 256 threads x 128, or a smaller one that splits small
    sends too) cover the send's slab, planes x0 .. x0 + width - 1 over rows
    [y0, y1), each element once, and the sends of a face tile the whole
    (width, ny, nz) landing buffer."""
    covered = np.zeros((width, ny * nz), dtype=np.int64)
    for y0, y1 in port_plan.partition_bounds(ny, parts):
        ntiles = -(-(width * (y1 - y0) * nz) // chunk)
        cuts = _push_runs(width, y0, y1, ny, nz, ntiles, chunk)
        assert all(0 < n <= chunk for _, _, n in cuts)
        for q, start, n in cuts:
            assert y0 * nz <= start and start + n <= y1 * nz
            covered[q, start:start + n] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("argv,route", [
    (["--mesh", "4", "1", "1", "--halo", "dma", "--overlap", "--time-blocking", "2",
      "--steps", "5"], ("fused-dma", "fused-dma2")),
    (["--mesh", "2", "2", "1", "--halo", "dma", "--overlap", "--stencil", "27pt",
      "--steps", "3"], ("fused-dma-3d", None)),
    (["--mesh", "4", "1", "1", "--fused-rdma", "on", "--halo-plan", "partitioned",
      "--time-blocking", "2", "--steps", "5"], ("fused-rdma", "fused-rdma2")),
])
def test_cli_overlap_flags_golden_check_on_cpu(capsys, argv, route):
    rc = cli.main(["--grid", "16"] + argv + ["--golden-check", "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["golden_pass"]
    assert (summary["step_route"], summary["superstep_route"]) == route
    assert summary["overlap"] == ("--overlap" in argv)
    assert summary["fused_rdma"] == ("on" if "--fused-rdma" in argv else "off")
    assert summary["halo_plan"] == ("partitioned" if "--halo-plan" in argv else "monolithic")


def test_cli_overlap_out_of_scope_exits_2(capsys):
    rc = cli.main(["--grid", "16", "--mesh", "1", "2", "2", "--halo", "dma", "--overlap",
                   "--steps", "2", "--device", "cpu"])
    assert rc == 2
    assert "fused DMA-overlap" in capsys.readouterr().err


if __name__ == "__main__":
    _reference(sys.argv[1])
