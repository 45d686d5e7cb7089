"""The port's halo-exchange benchmark (``bench_halo``, ``halo_loop``,
``halo_row``, ``run_suite``, the bench command line) against the JAX
package's.

The JAX side runs once per worker in a subprocess (this file run as a
script, with the 4-device CPU mesh of tests/test_multidevice.py and
``HEAT3D_PLAN_PART_MIN_BYTES=0``): the body of the JAX ``bench_halo`` loop
(``heat3d_tpu/bench/harness.py`` ``_loop``: ``exchange`` of the config,
then each received ghost face folded onto the carry's boundary face)
under ``shard_map`` for k = 3 iterations, on (2,2,1) and (1,1,1), both
orderings, both plan modes. The port's ``halo_loop`` carry is held to it
byte for byte; ``halo='dma'`` in the port (on the CPU its kernels' plain
version, the ppermute slab copies) is held to the JAX ppermute loop, which
gives the same values.

Rows are built on the CPU from made-up timings (``halo_row`` measures
nothing) and held to ``heat3d_tpu.analysis.provenance.check_row`` and to
the JAX row's field names. The card's tests of the loop and the bench are
in tests/test_torch_kernels.py (``cuda``).
"""

import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat3d_tpu.analysis.provenance import check_row
from heat3d_tpu.utils.timing import percentile as ref_percentile
from heat3d_tpu_torch import carry
from heat3d_tpu_torch.bench import __main__ as bench_cli
from heat3d_tpu_torch.bench import harness
from heat3d_tpu_torch.core import config
from heat3d_tpu_torch.parallel import topology
from heat3d_tpu_torch.parallel.step import make_exchanges
from heat3d_tpu_torch.utils.timing import percentile

EVEN = (16, 12, 10)
K = 3
# mesh, halo_order, halo_plan, storage, periodic, bc_value of the JAX loops
LOOPS = [
    ((2, 2, 1), "axis", "monolithic", "float32", False, 0.3),
    ((2, 2, 1), "axis", "partitioned", "float32", False, 0.3),
    ((2, 2, 1), "pairwise", "monolithic", "float32", False, 0.3),
    ((2, 2, 1), "pairwise", "partitioned", "float32", False, 0.3),
    ((2, 2, 1), "axis", "monolithic", "bfloat16", True, 0.0),
    ((2, 2, 1), "pairwise", "monolithic", "bfloat16", True, 0.0),
    ((1, 1, 1), "axis", "monolithic", "float32", False, 0.3),
    ((1, 1, 1), "pairwise", "monolithic", "float32", True, 0.0),
]
# the port's cases: each JAX loop on the ppermute transport, and the
# axis-ordered monolithic ones on the dma transport too
CASES = ([("ppermute",) + c for c in LOOPS]
         + [("dma",) + c for c in LOOPS if c[1:3] == ("axis", "monolithic")])
# the JAX halo row's fields (heat3d_tpu/bench/harness.py bench_halo); the
# port's cost_bytes_per_step is the analytic count of obs.perf.roofline
JAX_HALO_FIELDS = (
    "bench", "ts", "platform", "grid", "mesh", "dtype", "halo_order", "halo_plan",
    "plan_messages_per_exchange", "plan_bytes_per_device", "iters",
    "exchanges_per_program", "p50_us", "p95_mean_us", "min_us", "sync_rtt_us",
    "sync_rtt_s", "rtt_dominated", "ici", "halo_bytes_per_device",
    "cost_bytes_per_step",
)


def _base(shape=EVEN, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfg(m, mesh=(2, 2, 1), order="axis", plan="monolithic", storage="float32",
         periodic=False, bcv=0.0, halo="ppermute", grid=EVEN, **kw):
    """A SolverConfig of the port's (``m = config``) or the JAX package's
    config module."""
    bc = m.BoundaryCondition.PERIODIC if periodic else m.BoundaryCondition.DIRICHLET
    return m.SolverConfig(
        grid=m.GridConfig(shape=grid),
        stencil=m.StencilConfig(kind="7pt", bc=bc, bc_value=bcv),
        mesh=m.MeshConfig(shape=mesh), precision=m.Precision(storage=storage),
        halo=halo, halo_order=order, halo_plan=plan, **kw,
    )


def _key(mesh, order, plan, storage, periodic, bcv):
    return f"m{''.join(map(str, mesh))}_{order}_{plan}_{storage}_p{int(periodic)}_b{bcv}"


def _reference(path: str) -> None:
    """The JAX loop of every case (needs 4 JAX devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from heat3d_tpu.core import config as rc
    from heat3d_tpu.parallel.step import exchange
    from heat3d_tpu.parallel.topology import build_mesh, field_sharding
    from heat3d_tpu.utils.compat import shard_map

    out = {}
    for case in LOOPS:
        cfg = _cfg(rc, *case)
        nx, ny, nz = cfg.local_shape
        mesh = build_mesh(cfg.mesh, jax.devices()[:cfg.mesh.num_devices])
        spec = P(*cfg.mesh.axis_names)

        def _loop(u_local, n, cfg=cfg, nx=nx, ny=ny, nz=nz):
            def body(_, u):
                p = exchange(u, cfg)
                out = u
                out = out.at[0].set(p[0, 1:1 + ny, 1:1 + nz])
                out = out.at[nx - 1].set(p[nx + 1, 1:1 + ny, 1:1 + nz])
                out = out.at[:, 0].set(p[1:1 + nx, 0, 1:1 + nz])
                out = out.at[:, ny - 1].set(p[1:1 + nx, ny + 1, 1:1 + nz])
                out = out.at[:, :, 0].set(p[1:1 + nx, 1:1 + ny, 0])
                out = out.at[:, :, nz - 1].set(p[1:1 + nx, 1:1 + ny, nz + 1])
                return out

            return jax.lax.fori_loop(0, n, body, u_local)

        run_n = jax.jit(shard_map(_loop, mesh=mesh, in_specs=(spec, P()), out_specs=spec,
                                  check_vma=False))
        u = jax.device_put(jnp.asarray(_base()).astype(jnp.dtype(cfg.precision.storage)),
                           field_sharding(mesh, cfg.mesh))
        got = run_n(u, jnp.int32(K))
        out[_key(*case)] = np.asarray(got.astype(jnp.float32))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    from test_multidevice import _cpu_mesh_env

    path = str(tmp_path_factory.mktemp("halo_loop_ref") / "ref.npz")
    env = {**_cpu_mesh_env(4), "HEAT3D_PLAN_PART_MIN_BYTES": "0"}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), path],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, f"JAX reference failed:\n{proc.stderr[-4000:]}"
    return np.load(path)


# ---- the loop ---------------------------------------------------------------


@pytest.mark.parametrize("halo,mesh_shape,order,plan,storage,periodic,bcv", CASES)
def test_halo_loop_equals_jax_loop(jax_ref, monkeypatch, halo, mesh_shape, order, plan,
                                   storage, periodic, bcv):
    monkeypatch.setenv("HEAT3D_PLAN_PART_MIN_BYTES", "0")
    cfg = _cfg(config, mesh_shape, order, plan, storage, periodic, bcv, halo)
    mesh = topology.build_shard_mesh(cfg, "cpu")
    field = carry.split_global(_base(), cfg, mesh)
    us = [field] if isinstance(field, torch.Tensor) else list(field.shards)
    plan_ = make_exchanges(cfg, mesh).plan(1, getattr(torch, storage))
    assert plan_.transport == halo and plan_.halo_order == order
    before = [u.clone() for u in us]
    out = harness.halo_loop(plan_, mesh, us, K, bcv)
    assert out is us and any(not torch.equal(a, b) for a, b in zip(us, before))
    got = carry.stitch_global(us[0] if len(us) == 1 else field, cfg, mesh)
    want = jax_ref[_key(mesh_shape, order, plan, storage, periodic, bcv)]
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_fold_ghosts_order_and_width_check():
    """Later faces win on the shared edges (x, then y, then z), and the loop
    takes width-1 plans only."""
    u = torch.zeros((3, 4, 5))
    pad = torch.zeros((5, 6, 7))
    pad[0], pad[-1] = 1.0, 2.0
    pad[:, 0], pad[:, -1] = 3.0, 4.0
    pad[:, :, 0], pad[:, :, -1] = 5.0, 6.0
    harness.fold_ghosts(u, pad)
    assert u[0, 1, 1] == 1.0 and u[2, 1, 1] == 2.0
    assert u[0, 0, 1] == 3.0 and u[0, 3, 1] == 4.0
    assert u[0, 0, 0] == 5.0 and u[2, 3, 4] == 6.0 and u[1, 1, 2] == 0.0
    cfg = _cfg(config)
    mesh = topology.build_shard_mesh(cfg, "cpu")
    wide = make_exchanges(cfg, mesh).plan(2, torch.float32)
    with pytest.raises(ValueError, match="width-1"):
        harness.halo_loop(wide, mesh, [torch.zeros(cfg.local_shape)] * 4, 1, 0.0)


# ---- the row -----------------------------------------------------------------

ROWS = [("ppermute", "axis", "monolithic"), ("ppermute", "axis", "partitioned"),
        ("ppermute", "pairwise", "monolithic"), ("ppermute", "pairwise", "partitioned"),
        ("dma", "axis", "monolithic")]


def _row(halo, order, plan, mesh=(2, 2, 2), times=(3e-5, 1e-5, 2e-5, 5e-5, 4e-5)):
    cfg = _cfg(config, mesh, order, plan, halo=halo, grid=(32, 32, 32))
    shards = int(np.prod(mesh))
    return cfg, harness.halo_row(cfg, k=40, iters=len(times), times=list(times),
                                 devices=[torch.device("cpu")], shards=shards,
                                 sync_rtt_s=2e-5, exchange_kernel_launches=0)


@pytest.mark.parametrize("halo,order,plan", ROWS)
def test_halo_row_passes_provenance_lint(halo, order, plan):
    cfg, row = _row(halo, order, plan)
    assert check_row(row) == []
    assert set(JAX_HALO_FIELDS) <= set(row)
    from heat3d_tpu_torch.obs.perf.roofline import halo_exchange_bytes

    assert row["cost_bytes_per_step"] == halo_exchange_bytes(
        mesh_shape=(2, 2, 2), local=(16, 16, 16), order=order, itemsize=4)
    json.dumps(row)
    assert row["p95_mean_us"] >= row["p50_us"] >= row["min_us"]
    assert row["p50_us"] == pytest.approx(3e-5 * 1e6)
    assert row["min_us"] == pytest.approx(1e-5 * 1e6)
    assert row["p95_mean_us"] == pytest.approx(5e-5 * 1e6)
    # 3 faces x 2 directions of a 16^3 local block, fp32 (the JAX test)
    assert row["halo_bytes_per_device"] == 2 * 3 * 16 * 16 * 4
    assert (row["halo"], row["halo_order"], row["halo_plan"]) == (halo, order, plan)
    assert row["ici"] and row["platform"] == "cpu" and row["shards_per_device"] == 8
    assert row["exchanges_per_program"] == 40 and row["iters"] == 5
    assert row["rtt_dominated"] is False
    # the pairwise faces are raw: the plan's bytes are the JAX formula's; the
    # axis order's later faces carry the earlier ghosts
    if order == "pairwise":
        assert row["plan_bytes_per_device"] == row["halo_bytes_per_device"]
    else:
        assert row["plan_bytes_per_device"] == 2 * (16 * 16 + 18 * 16 + 18 * 18) * 4
    assert row["plan_messages_per_exchange"] == 6


def test_halo_row_single_shard_and_rtt_dominated():
    _, row = _row("ppermute", "axis", "monolithic", mesh=(1, 1, 1), times=(1e-7, 2e-7))
    assert row["ici"] is False and row["plan_messages_per_exchange"] == 0
    # 40 exchanges of 0.1 us against a 20 us round trip
    assert row["rtt_dominated"] is True
    assert row["halo_bytes_per_device"] == 2 * 3 * 32 * 32 * 4


def test_percentile_equals_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 10, 31):
        vals = list(rng.standard_normal(n))
        for q in (0, 50, 95, 100):
            assert percentile(vals, q) == ref_percentile(vals, q)
    with pytest.raises(ValueError):
        percentile([], 50)


# ---- the suite and the command line -------------------------------------------


def _stub_benches(monkeypatch, calls):
    def tput(cfg, steps=50, repeats=3, device=None):
        calls.append(("throughput", cfg.time_blocking, steps, repeats, device))
        return {"bench": "throughput", "time_blocking": cfg.time_blocking}

    def halo(cfg, iters=10, device=None):
        calls.append(("halo", cfg.halo_order, iters, device))
        return {"bench": "halo", "halo_order": cfg.halo_order}

    monkeypatch.setattr(harness, "bench_throughput", tput)
    monkeypatch.setattr(harness, "bench_halo", halo)


def test_run_suite_dedupes_halo_rows(monkeypatch):
    """Configs differing only in tb share one halo row (the JAX test)."""
    calls = []
    _stub_benches(monkeypatch, calls)
    cfg = _cfg(config, (1, 1, 1), grid=(16, 16, 16))
    buf = io.StringIO()
    results = harness.run_suite([cfg, dataclasses.replace(cfg, time_blocking=2)], steps=2,
                                out=buf)
    kinds = [r["bench"] for r in results]
    assert kinds.count("throughput") == 2 and kinds.count("halo") == 1
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 3 and [json.loads(x)["bench"] for x in lines] == kinds


@pytest.mark.parametrize("change", [dict(halo_order="pairwise"),
                                    dict(halo_plan="partitioned"), dict(halo="dma"),
                                    dict(precision=config.Precision(storage="bfloat16"))])
def test_run_suite_new_halo_row_per_exchange_shape(monkeypatch, change):
    calls = []
    _stub_benches(monkeypatch, calls)
    cfg = _cfg(config, grid=(16, 16, 16))
    results = harness.run_suite([cfg, dataclasses.replace(cfg, **change)], steps=2,
                                out=io.StringIO(), device="cpu", iters=4)
    assert [r["bench"] for r in results] == ["throughput", "halo", "throughput", "halo"]
    assert all(c[-1] == "cpu" for c in calls)
    assert [c[2] for c in calls if c[0] == "halo"] == [4, 4]


def test_benches_raise_without_cuda(monkeypatch):
    """A CPU time is never a device time."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(config, (1, 1, 1), grid=(16, 16, 16))
    for bench in (harness.bench_halo, harness.bench_throughput):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench(cfg)


@pytest.mark.parametrize("argv,want", [
    ([], ("suite", 30, 3)),
    (["--bench", "all", "--iters", "5", "--repeats", "2"], ("suite", 5, 2)),
    (["--bench", "halo", "--iters", "7"], ("halo", 7)),
    (["--bench", "throughput", "--repeats", "4"], ("throughput", 4)),
])
def test_bench_command_line(monkeypatch, capsys, argv, want):
    got = []
    monkeypatch.setattr(bench_cli, "run_suite",
                        lambda cfgs, steps, device, iters, repeats, state_path:
                        got.append(("suite", iters, repeats)))
    monkeypatch.setattr(bench_cli, "bench_halo", lambda cfg, iters, device:
                        got.append(("halo", iters)) or {"bench": "halo"})
    monkeypatch.setattr(bench_cli, "bench_throughput", lambda cfg, steps, repeats, device:
                        got.append(("throughput", repeats)) or {"bench": "throughput"})
    assert bench_cli.main(["--grid", "16", "--device", "cpu", *argv]) == 0
    assert got == [want]


def test_ab_script_reads_the_last_throughput_row(tmp_path):
    """``scripts/torch_bench_ab.py`` takes the last throughput row of a
    bench run, whether a halo row follows it (``--bench all``) or not."""
    spec = importlib.util.spec_from_file_location(
        "torch_bench_ab", os.path.join(os.path.dirname(__file__), "..", "scripts",
                                       "torch_bench_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    for rows in ([{"bench": "throughput", "gcell_updates_per_sec": 1.0},
                  {"bench": "halo", "p50_us": 9.0}],
                 [{"bench": "throughput", "gcell_updates_per_sec": 2.0}]):
        pkg = tmp_path / str(len(rows)) / "heat3d_tpu_torch" / "bench"
        pkg.mkdir(parents=True)
        (pkg.parent / "__init__.py").write_text("")
        (pkg / "__init__.py").write_text("")
        (pkg / "__main__.py").write_text(
            "".join(f"print({json.dumps(json.dumps(r))})\n" for r in rows))
        assert ab.run(str(pkg.parent.parent), []) == rows[0]


if __name__ == "__main__":
    _reference(sys.argv[1])
