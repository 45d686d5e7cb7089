"""bf16 stencil compute in the port (``Precision(compute='bfloat16')``,
BASELINE.json config 5 "bf16 stencil + fp32 residual norm"), on the CPU.

The contract is the JAX package's: the field is read in its storage dtype
and cast to bf16, every multiply and add of the update is rounded to bf16
(round to nearest even), the tap weights are bf16 of ``np.float32(w)``,
the result is cast back to storage, the residual stays float32.

- The plain update (``stencil_eager.apply_taps_padded``) equals eager JAX
  ``stencil_jnp.apply_taps_padded(compute_dtype=bfloat16)`` bitwise: eager
  JAX and eager PyTorch both round each bf16 operation.
- Each kernel's plain version against the JAX Pallas kernel in interpret
  mode, in this process under the default XLA flags: direct1, direct2
  (tap chain and Mehrstellen), the stream kernel, streamk k = 2..4 (in
  ``shard_map``), and in a subprocess on a 4-device CPU ring the fused
  DMA/RDMA step and superstep. Tolerance: one bf16 ulp of the value per
  update plus ``torch_port_checks.assert_close_per_update``'s bf16
  propagation term (its ``storage="bfloat16"`` rule). It is needed because
  jitted JAX code keeps excess precision under the default flags
  (``xla_allow_excess_precision``): XLA drops convert pairs, so the
  interpreted kernels round once, where eager code rounds every operation.
- With ``XLA_FLAGS=--xla_allow_excess_precision=false`` and
  ``HEAT3D_DIRECT_INTERPRET=1`` set before JAX starts (a subprocess), the
  same JAX kernels equal the port's plain versions bitwise, and the JAX
  ``HeatSolver3D`` equals the port's CPU solve bitwise at tb 1, 2 and 4,
  fp32/bf16 and bf16/bf16, and on the 27pt Mehrstellen route.
- Every sharded route on a CPU mesh under bf16 compute equals the port's
  (1,1,1) solve bitwise.
- Accuracy, as tests/test_solver.py: bf16/bf16 and fp32/bf16 within
  0.05 * max of the fp32 solve and within 5e-2 relative of the fp64
  golden oracle; the command line's golden gate is 5e-2 wherever bf16 is
  in the chain (storage or compute), 1e-5 for fp32/fp32.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat3d_tpu.ops.stencil_pallas_direct as ref_direct
from heat3d_tpu.core import config as rc
from heat3d_tpu.ops import stencil_jnp
from heat3d_tpu.ops import stencil_pallas as ref_pallas
from heat3d_tpu.parallel.step import exchange as ref_exchange
from heat3d_tpu_torch import cli
from heat3d_tpu_torch.core import config, golden
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.ops import stencil_direct as sd
from heat3d_tpu_torch.ops import stencil_dma_fused as fd
from heat3d_tpu_torch.ops import stencil_fused_rdma as fr
from heat3d_tpu_torch.ops import stencil_stream as ss
from heat3d_tpu_torch.ops.stencil_eager import apply_taps_padded, compute_weight, pad_local
from heat3d_tpu_torch.parallel import plan as port_plan
from heat3d_tpu_torch.parallel import step, topology
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

BF16 = torch.bfloat16
# the kernels' shapes: odd, no extent a multiple of another
SHAPE = (6, 9, 13)
# the fused kernels' 4-shard x ring of a 16^3 field
GRID = (16, 16, 16)
RING = (4, 1, 1)
# (stencil, periodic, bc value, storage) of the fused cases
FCASES = [("7pt", False, 1.5, "float32"), ("27pt", True, 0.0, "float32"),
          ("27pt", False, 1.5, "bfloat16"), ("7pt", True, 0.0, "bfloat16")]
# (time_blocking, plan mode, stencil, periodic, storage) of the RDMA cases
RCASES = [(1, "partitioned", "27pt", False, "float32"),
          (2, "partitioned", "7pt", True, "bfloat16")]
# the solver cases held bitwise to the JAX solver: (tb, steps, stencil,
# storage, Mehrstellen knob)
SOLVES = [(1, 5, "7pt", "float32", False), (2, 5, "7pt", "float32", False),
          (4, 9, "7pt", "float32", False), (1, 5, "27pt", "bfloat16", False),
          (2, 5, "7pt", "bfloat16", False), (4, 9, "27pt", "bfloat16", False),
          (2, 5, "27pt", "float32", True)]
SOLVE_SHAPE = (10, 12, 14)
SOLVE_BC = 0.3


def _jdtype(storage):
    return getattr(jnp, storage)


def _bc(m, periodic):
    return m.BoundaryCondition.PERIODIC if periodic else m.BoundaryCondition.DIRICHLET


def _kernel_cases():
    """(name, stencil, storage, Mehrstellen, periodic, bc) of the kernel
    cases of the bitwise subprocess: each kernel over both stencils and
    storage dtypes, the boundary settings taken in turn."""
    cases = []
    i = 0
    for name in ("direct1", "direct2", "stream1", "streamk2", "streamk3", "streamk4"):
        for kind in ("7pt", "27pt"):
            for storage in ("float32", "bfloat16"):
                for mehr in ((False, True) if name.startswith("direct") and kind == "27pt"
                             else (False,)):
                    periodic, bcv = BCS[i % len(BCS)]
                    i += 1
                    cases.append((name, kind, storage, mehr, periodic, bcv))
    return cases


def _key(*parts) -> str:
    return "_".join(str(p) for p in parts)


def _solve_cfg(m, tb, kind, storage):
    return m.SolverConfig(
        grid=m.GridConfig(shape=SOLVE_SHAPE),
        stencil=m.StencilConfig(kind=kind, bc=_bc(m, False), bc_value=SOLVE_BC),
        mesh=m.MeshConfig(shape=(1, 1, 1)),
        precision=m.Precision(storage=storage, compute="bfloat16"),
        run=m.RunConfig(seed=4), time_blocking=tb,
    )


def _ring_taps(m, kind):
    g = m.GridConfig(shape=GRID)
    from heat3d_tpu_torch.core.stencils import STENCILS, stencil_taps

    return stencil_taps(STENCILS[kind], g.alpha, g.effective_dt(), g.spacing)


def _base(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _reference(path: str, mode: str) -> None:
    """The JAX side, in a process of its own (4 CPU devices). ``mode``
    'fused': the fused kernels only (default XLA flags); 'bitwise': every
    kernel case, the fused kernels and the solver cases (excess precision
    off, ``HEAT3D_DIRECT_INTERPRET=1``)."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    import heat3d_tpu.ops.stencil_dma_fused as jfd
    import heat3d_tpu.ops.stencil_fused_rdma as jfr
    from heat3d_tpu import eqn as ref_eqn
    from heat3d_tpu.models.heat3d import HeatSolver3D as RefSolver
    from heat3d_tpu.parallel.plan import build_plan
    from heat3d_tpu.utils.compat import shard_map

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    bf = jnp.bfloat16
    out = {}
    ring = Mesh(np.array(jax.devices()[:4]).reshape(4), ("x",))
    spec = P("x")
    kw = dict(axis_name="x", axis_size=4, mesh_axes=("x",), interpret=True,
              compute_dtype=bf)

    def run(fn, u):
        return jax.jit(shard_map(fn, mesh=ring, in_specs=spec, out_specs=spec,
                                 check_vma=False))(u)

    for kind, periodic, bcv, storage in FCASES:
        u = jax.device_put(jnp.asarray(_base(GRID, 7)).astype(_jdtype(storage)),
                           NamedSharding(ring, spec))
        taps = _ring_taps(rc, kind)
        out[_key("f1", kind, periodic, storage)] = f32(run(lambda x: jfd.apply_step_fused_dma(
            x, taps, periodic=periodic, bc_value=bcv, **kw), u))
        out[_key("f2", kind, periodic, storage)] = f32(run(
            lambda x: jfd.apply_superstep_fused_dma(x, taps, periodic=periodic,
                                                    bc_value=bcv, **kw), u))
    for tb, plan_mode, kind, periodic, storage in RCASES:
        u = jax.device_put(jnp.asarray(_base(GRID, 7)).astype(_jdtype(storage)),
                           NamedSharding(ring, spec))
        taps = _ring_taps(rc, kind)
        plan = build_plan(rc.MeshConfig(shape=RING), _bc(rc, periodic), width=tb,
                          mode=plan_mode, min_part_bytes=0)
        fn = jfr.apply_step_fused_rdma if tb == 1 else jfr.apply_superstep_fused_rdma
        out[_key("r", tb, plan_mode, kind, periodic, storage)] = f32(run(
            lambda x: fn(x, taps, plan=plan, periodic=periodic,
                         bc_value=0.0 if periodic else 1.5, **kw), u))
    if mode == "bitwise":
        for name, kind, storage, mehr, periodic, bcv in _kernel_cases():
            os.environ["HEAT3D_MEHRSTELLEN"] = "1" if mehr else "0"
            taps = _taps(kind, SHAPE)
            ju = jnp.asarray(_base(SHAPE, 21)).astype(_jdtype(storage))
            key = _key(name, kind, storage, mehr, periodic, bcv)
            if name.startswith("direct"):
                fn = ref_direct.apply_taps_direct if name == "direct1" else \
                    ref_direct.apply_taps_direct2
                out[key] = f32(fn(ju, taps, periodic=periodic, bc_value=bcv,
                                  compute_dtype=bf, interpret=True))
            elif name == "stream1":
                jup = jnp.asarray(_base(tuple(n + 2 for n in SHAPE), 22)).astype(
                    _jdtype(storage))
                out[key] = f32(ref_pallas.apply_taps_pallas(
                    jup, taps, compute_dtype=bf, out_dtype=_jdtype(storage), interpret=True))
            else:
                k = int(name[-1])
                cfg = ref_config(SHAPE, kind, periodic, bcv, tb=k)
                out[key] = f32(on_mesh(
                    lambda x: ref_pallas.apply_taps_pallas_streamk(
                        ref_exchange(x, cfg, width=k), taps, k, cfg.mesh.axis_names,
                        periodic=periodic, bc_value=bcv, compute_dtype=bf,
                        interpret=True),
                    cfg, ju))
        os.environ["HEAT3D_DIRECT_INTERPRET"] = "1"
        for tb, steps, kind, storage, mehr in SOLVES:
            os.environ["HEAT3D_MEHRSTELLEN"] = "1" if mehr else "0"
            cfg = _solve_cfg(rc, tb, kind, storage)
            ref = RefSolver(cfg, devices=jax.devices()[:1])
            u0 = ref.init_state("random")
            key = _key("solve", tb, kind, storage, mehr)
            out["u0_" + key] = f32(ref.gather(u0))
            out["taps_" + key] = np.asarray(ref_eqn.solver_taps(cfg), dtype=np.float64)
            out["out_" + key] = f32(ref.gather(ref.run(u0, steps)))
    np.savez(path, **out)


def _run_reference(tmp_path_factory, mode: str):
    from test_multidevice import _cpu_mesh_env

    env = _cpu_mesh_env(4)
    if mode == "bitwise":
        env["XLA_FLAGS"] = (env["XLA_FLAGS"] + " --xla_allow_excess_precision=false").strip()
        env["HEAT3D_DIRECT_INTERPRET"] = "1"
    path = str(tmp_path_factory.mktemp(f"bf16_{mode}") / "ref.npz")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path, mode],
                          env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, f"JAX reference ({mode}) failed:\n{proc.stderr[-4000:]}"
    return np.load(path)


@pytest.fixture(scope="module")
def fused_ref(tmp_path_factory):
    return _run_reference(tmp_path_factory, "fused")


@pytest.fixture(scope="module")
def bitwise_ref(tmp_path_factory):
    return _run_reference(tmp_path_factory, "bitwise")


# ---- the plain update against eager JAX ---------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("mehrstellen", [False, True], ids=["chain", "mehrstellen"])
def test_plain_update_equals_eager_jax_bitwise(mehrstellen, kind, dtype):
    storage, tdtype, jdtype = dtype
    taps = _taps(kind, SHAPE)
    ju, tu = _field(SHAPE, 11, jdtype)
    for periodic, bcv in BCS:
        want = stencil_jnp.apply_taps_padded(
            stencil_jnp.pad_local(ju, _bc(rc, periodic), bcv), taps,
            compute_dtype=jnp.bfloat16, mehrstellen=mehrstellen)
        got = apply_taps_padded(pad_local(tu.to(tdtype), _bc(config, periodic), bcv), taps,
                                mehrstellen=mehrstellen, compute_dtype=BF16)
        assert got.dtype == tdtype and tuple(got.shape) == SHAPE
        assert _as_np(got).tobytes() == np.asarray(want.astype(jnp.float32)).tobytes(), \
            (kind, storage, periodic, bcv)


def test_compute_weights_and_program_are_bf16_values():
    """The weights the kernels get are the plain version's: bf16 of
    ``np.float32(w)`` (``jnp.asarray(w, bfloat16)``'s rounding), in the
    chain program and in the Mehrstellen record; float32 compute keeps
    ``np.float32(w)``; any other compute dtype is refused."""
    for kind in ("7pt", "27pt"):
        taps = _taps(kind, SHAPE)
        prog = sd.chain_program(taps, BF16)
        prog32 = sd.chain_program(taps)
        for i, (_, _, _, w) in enumerate(sd.emission_program(taps)):
            assert prog32.t[i].w == w
            assert prog.t[i].w == float(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    coeffs = sd.decompose_mehrstellen(_taps("27pt", SHAPE))
    rec = sd.mehrstellen_program(_taps("27pt", SHAPE), BF16)
    assert [rec.t[i].w for i in range(3)] == [compute_weight(c, BF16) for c in coeffs]
    assert [compute_weight(c, BF16) for c in coeffs] == [
        float(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32)) for c in coeffs]
    with pytest.raises(ValueError, match="compute dtype"):
        sd.chain_program(_taps("7pt", SHAPE), torch.float16)
    with pytest.raises(ValueError, match="compute dtype"):
        apply_taps_padded(torch.zeros(4, 4, 4), _taps("7pt", SHAPE),
                          compute_dtype=torch.float16)


def test_cpu_path_counts_no_bf16_launches():
    taps = _taps("7pt", SHAPE)
    u = torch.zeros(SHAPE)
    before = dict(sd.compute_bf16_launch_counts(), **ss.compute_bf16_launch_counts())
    sd.apply_taps_direct2(sd.apply_taps_direct(u, taps, compute_dtype=BF16), taps,
                          compute_dtype=BF16)
    ss.apply_taps_streamk(exchange_halo(u, config.BoundaryCondition.DIRICHLET, 0.0, 2),
                          taps, 2, compute_dtype=BF16)
    assert dict(sd.compute_bf16_launch_counts(), **ss.compute_bf16_launch_counts()) == before


# ---- the plain versions against the Pallas kernels (default XLA flags) --------


def _direct_case(kind, dtype, mehrstellen, monkeypatch):
    storage, tdtype, jdtype = dtype
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1" if mehrstellen else "0")
    taps = _taps(kind, SHAPE)
    ju, tu = _field(SHAPE, 12, jdtype)
    for periodic, bcv in BCS:
        for updates, (jfn, fn) in enumerate(
                ((ref_direct.apply_taps_direct, sd.apply_taps_direct),
                 (ref_direct.apply_taps_direct2, sd.apply_taps_direct2)), start=1):
            want = jfn(ju, taps, periodic=periodic, bc_value=bcv,
                       compute_dtype=jnp.bfloat16, interpret=True)
            got = fn(tu.to(tdtype), taps, periodic, bcv, compute_dtype=BF16)
            assert got.dtype == tdtype and tuple(got.shape) == SHAPE
            assert_close_per_update(_as_np(got), np.asarray(want.astype(jnp.float32)),
                                    "bfloat16", updates,
                                    err_msg=f"direct{updates} {kind} {storage} "
                                            f"periodic={periodic} bc={bcv}")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind,mehrstellen", [("7pt", False), ("27pt", False),
                                              ("27pt", True)])
def test_direct_plain_versions_match_pallas_interpret(monkeypatch, kind, mehrstellen, dtype):
    _direct_case(kind, dtype, mehrstellen, monkeypatch)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
def test_stream_plain_version_matches_pallas_interpret(kind, dtype):
    storage, tdtype, jdtype = dtype
    taps = _taps(kind, SHAPE)
    jup, tup = _field(tuple(n + 2 for n in SHAPE), 13, jdtype)
    want = ref_pallas.apply_taps_pallas(jup, taps, compute_dtype=jnp.bfloat16,
                                        out_dtype=jdtype, interpret=True)
    got = ss.apply_taps_stream(tup.to(tdtype), taps, compute_dtype=BF16)
    assert got.dtype == tdtype
    assert_close_per_update(_as_np(got), np.asarray(want.astype(jnp.float32)), "bfloat16", 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[0])
@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_streamk_plain_version_matches_pallas_interpret(k, kind, dtype):
    storage, tdtype, jdtype = dtype
    shape = (6, 7, 9)
    taps = _taps(kind, shape)
    ju, tu = _field(shape, 40 + k, jdtype)
    for periodic, bcv in BCS:
        cfg = ref_config(shape, kind, periodic, bcv, tb=k)
        want = on_mesh(
            lambda x: ref_pallas.apply_taps_pallas_streamk(
                ref_exchange(x, cfg, width=k), taps, k, cfg.mesh.axis_names,
                periodic=periodic, bc_value=bcv, compute_dtype=jnp.bfloat16,
                interpret=True),
            cfg, ju)
        got = ss.apply_taps_streamk(exchange_halo(tu.to(tdtype), _bc(config, periodic), bcv, k),
                                    taps, k, periodic, bcv, compute_dtype=BF16)
        assert got.dtype == tdtype and tuple(got.shape) == shape
        assert_close_per_update(_as_np(got), np.asarray(want.astype(jnp.float32)),
                                "bfloat16", k,
                                err_msg=f"k={k} {kind} {storage} periodic={periodic} bc={bcv}")


def _ring(storage):
    """The 16^3 field's four x-slab shards on a CPU mesh, rounded to
    ``storage`` as the JAX side rounds them."""
    full = torch.from_numpy(_base(GRID, 7)).to(getattr(torch, storage))
    mesh = topology.ShardMesh(RING, (4, 16, 16), [torch.device("cpu")] * 4)
    return mesh, [full[4 * i: 4 * i + 4].contiguous() for i in range(4)]


def _stack(ts) -> np.ndarray:
    return torch.cat([t.float() for t in ts]).numpy()


def _fused_outputs(kind, periodic, bcv, storage):
    mesh, us = _ring(storage)
    taps = _ring_taps(config, kind)
    one = fd.apply_step_fused_dma(us, taps, mesh, None, periodic, bcv, compute_dtype=BF16)
    two = fd.apply_superstep_fused_dma(us, taps, mesh, None, periodic, bcv,
                                       compute_dtype=BF16)
    return _stack(one), _stack(two)


def _rdma_output(tb, mode, kind, periodic, storage):
    mesh, us = _ring(storage)
    taps = _ring_taps(config, kind)
    bounds = fr.plan_send_bounds(port_plan.Schedule(RING, tb, mode, min_part_bytes=0),
                                 (4, 16, 16), 4)
    state = fd.FusedState(mesh, tb, getattr(torch, storage), periodic, bounds)
    fn = fr.apply_step_fused_rdma if tb == 1 else fr.apply_superstep_fused_rdma
    return _stack(fn(us, taps, mesh, state, periodic, 0.0 if periodic else 1.5,
                     compute_dtype=BF16))


@pytest.mark.parametrize("kind,periodic,bcv,storage", FCASES)
def test_fused_plain_versions_match_pallas_interpret(fused_ref, kind, periodic, bcv, storage):
    one, two = _fused_outputs(kind, periodic, bcv, storage)
    assert_close_per_update(one, fused_ref[_key("f1", kind, periodic, storage)], "bfloat16", 1)
    assert_close_per_update(two, fused_ref[_key("f2", kind, periodic, storage)], "bfloat16", 2)


@pytest.mark.parametrize("tb,mode,kind,periodic,storage", RCASES)
def test_rdma_plain_versions_match_pallas_interpret(fused_ref, tb, mode, kind, periodic,
                                                    storage):
    got = _rdma_output(tb, mode, kind, periodic, storage)
    assert_close_per_update(got, fused_ref[_key("r", tb, mode, kind, periodic, storage)],
                            "bfloat16", tb)


# ---- bitwise with the excess precision off --------------------------------------


def test_kernels_equal_pallas_interpret_bitwise_without_excess_precision(bitwise_ref,
                                                                        monkeypatch):
    """Every kernel case of the subprocess (direct1 and direct2 on the
    chain and the Mehrstellen route, the stream kernel, streamk k = 2..4;
    both stencils, both storage dtypes, the three boundary settings in
    turn), the fused DMA step and superstep and the fused RDMA kernels:
    the port's plain versions byte for byte."""
    for name, kind, storage, mehr, periodic, bcv in _kernel_cases():
        monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1" if mehr else "0")
        taps = _taps(kind, SHAPE)
        dtype = getattr(torch, storage)
        key = _key(name, kind, storage, mehr, periodic, bcv)
        if name.startswith("direct"):
            u = torch.from_numpy(_base(SHAPE, 21)).to(dtype)
            fn = sd.apply_taps_direct if name == "direct1" else sd.apply_taps_direct2
            got = fn(u, taps, periodic, bcv, compute_dtype=BF16)
        elif name == "stream1":
            up = torch.from_numpy(_base(tuple(n + 2 for n in SHAPE), 22)).to(dtype)
            got = ss.apply_taps_stream(up, taps, compute_dtype=BF16)
        else:
            k = int(name[-1])
            u = torch.from_numpy(_base(SHAPE, 21)).to(dtype)
            got = ss.apply_taps_streamk(exchange_halo(u, _bc(config, periodic), bcv, k),
                                        taps, k, periodic, bcv, compute_dtype=BF16)
        assert _as_np(got).tobytes() == bitwise_ref[key].tobytes(), key
    for kind, periodic, bcv, storage in FCASES:
        one, two = _fused_outputs(kind, periodic, bcv, storage)
        assert one.tobytes() == bitwise_ref[_key("f1", kind, periodic, storage)].tobytes()
        assert two.tobytes() == bitwise_ref[_key("f2", kind, periodic, storage)].tobytes()
    for tb, mode, kind, periodic, storage in RCASES:
        got = _rdma_output(tb, mode, kind, periodic, storage)
        assert got.tobytes() == bitwise_ref[_key("r", tb, mode, kind, periodic,
                                                 storage)].tobytes()


@pytest.mark.parametrize("tb,steps,kind,storage,mehr", SOLVES)
def test_solver_equals_jax_solver_bitwise_without_excess_precision(bitwise_ref, monkeypatch,
                                                                   tb, steps, kind, storage,
                                                                   mehr):
    monkeypatch.setenv("HEAT3D_MEHRSTELLEN", "1" if mehr else "0")
    key = _key("solve", tb, kind, storage, mehr)
    cfg = _solve_cfg(config, tb, kind, storage)
    solver = HeatSolver3D(cfg, device="cpu", taps=bitwise_ref["taps_" + key])
    got = solver.gather(solver.run(solver.init_state(bitwise_ref["u0_" + key]), steps))
    want = bitwise_ref["out_" + key]
    assert got.shape == want.shape
    assert got.astype(np.float32).tobytes() == want.tobytes(), \
        float(np.abs(got - want).max())


# ---- the sharded routes -----------------------------------------------------------

# (mesh, knobs, time_blocking, route) of the sharded routes under bf16 compute
ROUTES = [
    ((2, 2, 2), {}, 1, "faces-direct"),
    ((2, 2, 2), {}, 2, "faces-direct2"),
    ((2, 2, 2), {}, 4, "streamk"),
    ((2, 2, 2), {"halo": "dma"}, 1, "exchange"),
    ((4, 1, 1), {"halo": "dma", "overlap": True}, 1, "fused-dma"),
    ((4, 1, 1), {"halo": "dma", "overlap": True}, 2, "fused-dma2"),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 1, "fused-rdma"),
    ((4, 1, 1), {"fused_rdma": "on", "halo_plan": "partitioned"}, 2, "fused-rdma2"),
]


def _cfg(mesh, storage, tb=1, kind="27pt", compute="bfloat16", bcv=0.3, **knobs):
    return config.SolverConfig(
        grid=config.GridConfig(shape=GRID),
        stencil=config.StencilConfig(kind=kind, bc_value=bcv),
        mesh=config.MeshConfig(shape=mesh),
        precision=config.Precision(storage=storage, compute=compute),
        run=config.RunConfig(seed=5), time_blocking=tb, **knobs)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh,knobs,tb,route", ROUTES, ids=[r[3] for r in ROUTES])
def test_sharded_routes_equal_single_shard_bitwise(monkeypatch, mesh, knobs, tb, route,
                                                   storage):
    monkeypatch.setenv("HEAT3D_PLAN_PART_MIN_BYTES", "0")
    steps = 2 * tb + 1
    one = HeatSolver3D(_cfg((1, 1, 1), storage), device="cpu")
    want = one.gather(one.run(one.init_state("random"), steps))
    cfg = _cfg(mesh, storage, tb, **knobs)
    assert (step.superstep_route(cfg) if tb > 1 else step.step_route(cfg)) == route
    solver = HeatSolver3D(cfg, device="cpu")
    got = solver.gather(solver.run(solver.init_state("random"), steps))
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("backend", ["jnp", "conv"])
def test_plain_backends_take_the_compute_dtype(backend):
    """The exchange path's plain arms compute in bf16 too: the jnp arm is
    the plain chain (bitwise to the kernels' solve), the conv arm one
    bf16 ``F.conv3d`` (its own summation order: within the bf16
    accuracy gate of the fp32 solve)."""
    steps = 4
    kernel = HeatSolver3D(_cfg((1, 1, 1), "float32", kind="7pt"), device="cpu")
    want = kernel.gather(kernel.run(kernel.init_state("random"), steps))
    arm = HeatSolver3D(_cfg((1, 1, 1), "float32", kind="7pt", backend=backend), device="cpu")
    got = arm.gather(arm.run(arm.init_state("random"), steps))
    if backend == "jnp":
        assert got.tobytes() == want.tobytes()
    else:
        fp32 = HeatSolver3D(_cfg((1, 1, 1), "float32", kind="7pt", compute="float32"),
                            device="cpu")
        ref = fp32.gather(fp32.run(fp32.init_state("random"), steps))
        assert np.max(np.abs(got - ref)) < 0.05 * max(1.0, np.max(np.abs(ref)))
        assert not np.array_equal(got, ref)


# ---- accuracy -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["7pt", "27pt"])
@pytest.mark.parametrize("storage", ["bfloat16", "float32"])
def test_bf16_compute_tracks_fp32_and_golden(kind, storage):
    steps = 5
    mine = HeatSolver3D(_cfg((1, 1, 1), storage, tb=2, kind=kind, bcv=0.0), device="cpu")
    got = mine.gather(mine.run(mine.init_state("gaussian"), steps)).astype(np.float64)
    fp32 = HeatSolver3D(_cfg((1, 1, 1), "float32", kind=kind, compute="float32", bcv=0.0),
                        device="cpu")
    ref = fp32.gather(fp32.run(fp32.init_state("gaussian"), steps))
    assert np.max(np.abs(got - ref)) < 0.05 * max(1.0, np.max(np.abs(ref)))
    cfg = mine.cfg
    from heat3d_tpu_torch import eqn

    g = golden.run(golden.make_init("gaussian", GRID, seed=cfg.run.seed), cfg.grid,
                   cfg.stencil, steps, taps=eqn.solver_taps(cfg))
    assert np.max(np.abs(got - g)) / np.max(np.abs(g)) < 5e-2


@pytest.mark.parametrize("storage,compute,tol", [("fp32", "bf16", 5e-2), ("bf16", "bf16", 5e-2),
                                                 ("fp32", "fp32", 1e-5)])
def test_cli_golden_gate_follows_the_chain(capsys, storage, compute, tol):
    """``--compute-dtype`` on the command line: bf16 anywhere in the chain
    takes the 5e-2 gate (a bf16 run misses 1e-5, so the gate is not the
    fp32 one), fp32/fp32 keeps 1e-5."""
    rc_ = cli.main(["--grid", "16", "--steps", "5", "--dtype", storage, "--compute-dtype",
                    compute, "--golden-check", "--device", "cpu"])
    assert rc_ == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["compute_dtype"] == ("bfloat16" if compute == "bf16" else "float32")
    assert summary["golden_pass"] and summary["golden_rel_err"] < tol
    if compute == "bf16":
        assert summary["golden_rel_err"] > 1e-5


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
