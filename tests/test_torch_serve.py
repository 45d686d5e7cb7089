"""The port's serving part one (``heat3d_tpu_torch.serve``) on the CPU, held
to the JAX package's ``heat3d_tpu.serve``.

- Against the JAX ``EnsembleSolver`` (one CPU device, ``batch_mesh=1``):
  the traced binding at tb 1/2/3, the Mehrstellen route (27pt), bf16
  storage, per-member ``eq_params`` and coefficient fields, each member
  within ``torch_port_checks.assert_close_per_update`` of the JAX member
  (XLA's CPU backend contracts some multiply-adds into FMAs; eager PyTorch
  rounds each operation).
- Within the port, bitwise: packing invariance (a member alone, in a batch
  of 4 and in a batch of 8 padded by the queue), frozen members under
  mixed budgets, ``bind='baked'`` and the traced binding equal to solo
  ``HeatSolver3D(backend='jnp')`` runs, (2,1,1) and (2,2,1) meshes and
  ``batch_mesh=2`` equal to (1,1,1), member residuals equal to the solo
  residual.
- The scenario refusals, member configs and bucket keys as in JAX; the
  queue (submission order, padding, backpressure, snapshots, residuals,
  default budgets, a failing bucket, solver reuse); the command line's
  ``--smoke`` and ``--requests`` against ``python -m heat3d_tpu serve`` in
  a ``JAX_PLATFORMS=cpu`` child; the ``--bench`` row through the JAX
  provenance lint. The always-on modes (``--async``, ``--loadgen``,
  ``--slo``) are held in ``tests/test_torch_serve_async.py`` and
  ``tests/test_torch_serve_soak.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import (
    BoundaryCondition,
    GridConfig,
    MeshConfig,
    Precision,
    RunConfig,
    SolverConfig,
    StencilConfig,
)
from heat3d_tpu_torch.models.heat3d import HeatSolver3D
from heat3d_tpu_torch.serve.ensemble import EnsembleSolver
from heat3d_tpu_torch.serve.scenario import (
    Scenario,
    ScenarioBatch,
    request_bucket_key,
    solver_bucket_key,
)
from torch_port_checks import assert_close_per_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (init, alpha, bc_value, steps, seed)
HETERO = [
    ("hot-cube", 0.3, 1.0, 4, 1),
    ("gaussian", 0.8, 0.0, 3, 2),
    ("random", 0.5, -0.5, 2, 3),
    ("random", 0.6, 0.3, 5, 4),
]


def _specs(n=4):
    return [dict(init=i, alpha=a, bc_value=b, steps=s, seed=d) for i, a, b, s, d in HETERO[:n]]


def _base(grid=12, kind="7pt", tb=1, mesh=(1, 1, 1), periodic=False, bf16=False,
          steps=4, **kw):
    return SolverConfig(
        grid=GridConfig.cube(grid),
        stencil=StencilConfig(kind=kind, bc=BoundaryCondition.PERIODIC if periodic
                              else BoundaryCondition.DIRICHLET),
        mesh=MeshConfig(shape=mesh),
        precision=Precision.bf16() if bf16 else Precision.fp32(),
        run=RunConfig(num_steps=steps),
        backend="jnp",
        halo="ppermute",
        time_blocking=tb,
        **kw,
    )


def _jbase(grid=12, kind="7pt", tb=1, periodic=False, bf16=False, steps=4, **kw):
    from heat3d_tpu.core import config as rc

    return rc.SolverConfig(
        grid=rc.GridConfig.cube(grid),
        stencil=rc.StencilConfig(kind=kind, bc=rc.BoundaryCondition.PERIODIC if periodic
                                 else rc.BoundaryCondition.DIRICHLET),
        mesh=rc.MeshConfig(shape=(1, 1, 1)),
        precision=rc.Precision.bf16() if bf16 else rc.Precision.fp32(),
        run=rc.RunConfig(num_steps=steps),
        backend="jnp",
        halo="ppermute",
        time_blocking=tb,
        **kw,
    )


def _members(specs, **extra):
    return [Scenario(**s, **extra) for s in specs]


def _run(batch, **kw):
    es = EnsembleSolver(batch, device="cpu", **kw)
    return es.gather(es.run(es.init_state()))


def _solo(batch, m):
    solo = HeatSolver3D(batch.member_config(m), device="cpu")
    return solo.gather(solo.run(solo.init_state(batch.members[m].init),
                                batch.member_steps(m)))


@pytest.fixture(autouse=True)
def _detached(monkeypatch):
    monkeypatch.delenv("HEAT3D_LEDGER", raising=False)
    monkeypatch.delenv("HEAT3D_SLO_SPEC", raising=False)
    monkeypatch.delenv("HEAT3D_MEHRSTELLEN", raising=False)
    monkeypatch.setenv("HEAT3D_TUNE_DISABLE", "1")
    obs.deactivate()
    yield
    obs.deactivate()


# ---- against the JAX ensemble ----------------------------------------------

_JAX_CASES = [
    ("tb1", {}, {}),
    ("tb2", {"tb": 2}, {}),
    ("tb3-27pt", {"tb": 3, "kind": "27pt"}, {}),
    ("periodic-tb2", {"tb": 2, "periodic": True}, {}),
    ("mehrstellen-27pt", {"kind": "27pt"}, {"HEAT3D_MEHRSTELLEN": "1"}),
    ("bf16-tb2", {"tb": 2, "bf16": True}, {}),
    ("advection-eq-params", {"equation": "advection-diffusion"}, {}),
    ("coef-fields", {}, {}),
]


@pytest.mark.parametrize("case,kw,env", _JAX_CASES,
                         ids=[c[0] for c in _JAX_CASES])
def test_traced_ensemble_matches_jax(monkeypatch, case, kw, env):
    from heat3d_tpu.serve.ensemble import EnsembleSolver as JEnsemble
    from heat3d_tpu.serve.scenario import Scenario as JScenario
    from heat3d_tpu.serve.scenario import ScenarioBatch as JBatch

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    specs = _specs()
    extra = [{} for _ in specs]
    if case == "advection-eq-params":
        extra = [{"eq_params": (("vx", 0.5 + 0.4 * i),)} for i in range(len(specs))]
    if case == "coef-fields":
        names = ("uniform", "layered", "checker", "lognormal")
        extra = [{"coef_field": (n, i, 0.5, 1.5)} for i, n in enumerate(names)]
    mine = ScenarioBatch(_base(**kw), [Scenario(**s, **e) for s, e in zip(specs, extra)])
    ref = JBatch(_jbase(**kw), [JScenario(**s, **e) for s, e in zip(specs, extra)])
    es = EnsembleSolver(mine, device="cpu")
    if case == "mehrstellen-27pt":
        assert es._mehrstellen
    got = es.gather(es.run(es.init_state()))
    jes = JEnsemble(ref, bind="traced")
    want = np.asarray(jes.gather(jes.run(jes.init_state())), np.float32)
    storage = "bfloat16" if kw.get("bf16") else "float32"
    for m, s in enumerate(specs):
        assert_close_per_update(got[m], want[m], storage, max(1, s["steps"]),
                                err_msg=f"{case} member {m}")


def test_make_coef_field_equals_jax_to_the_bit():
    from heat3d_tpu.timeint import coeffield as jcf
    from heat3d_tpu_torch.timeint import coeffield as cf

    assert cf.COEF_FIELDS == jcf.COEF_FIELDS
    for name in cf.COEF_FIELDS:
        for seed, lo, hi in ((0, 0.5, 1.5), (3, 0.2, 2.0), (1, 1.0, 1.0)):
            a = cf.make_coef_field(name, (6, 7, 9), seed=seed, lo=lo, hi=hi)
            b = jcf.make_coef_field(name, (6, 7, 9), seed=seed, lo=lo, hi=hi)
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
    assert cf.varcoef_stable_dt(1.5, (1.0, 0.5, 2.0)) == jcf.varcoef_stable_dt(1.5, (1.0, 0.5, 2.0))
    u = np.random.default_rng(0).standard_normal((5, 6, 7))
    a = cf.make_coef_field("uniform", (5, 6, 7))
    for periodic in (True, False):
        np.testing.assert_array_equal(
            cf.reference_varcoef_step(u, a, 0.05, (1.0, 1.0, 1.0), periodic, 0.3),
            jcf.reference_varcoef_step(u, a, 0.05, (1.0, 1.0, 1.0), periodic, 0.3))


# ---- scenario validation and bucketing, as in JAX ----------------------------


def _raises_like(fn_mine, fn_ref):
    with pytest.raises(Exception) as mine:
        fn_mine()
    with pytest.raises(Exception) as ref:
        fn_ref()
    assert type(mine.value) is type(ref.value)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    {"alpha": 0.0}, {"dt": -0.1}, {"steps": -1}, {"integrator": "rk4"},
    {"coef_field": ("nope",)}, {"coef_field": ("uniform", 0, 2.0, 1.0)},
    {"coef_field": ("uniform", 0, 0.5, 1.5, 9)},
], ids=["alpha", "dt", "steps", "integrator", "field-name", "field-lo-hi", "field-arity"])
def test_scenario_refusals_match_jax(kw):
    from heat3d_tpu.serve.scenario import Scenario as JScenario

    _raises_like(lambda: Scenario(**kw), lambda: JScenario(**kw))


def test_batch_refusals_match_jax():
    from heat3d_tpu.serve.scenario import Scenario as JScenario
    from heat3d_tpu.serve.scenario import ScenarioBatch as JBatch

    _raises_like(lambda: ScenarioBatch(_base(), []), lambda: JBatch(_jbase(), []))
    _raises_like(
        lambda: ScenarioBatch(_base(), [Scenario(coef_field=("uniform",)), Scenario()]),
        lambda: JBatch(_jbase(), [JScenario(coef_field=("uniform",)), JScenario()]))
    _raises_like(
        lambda: ScenarioBatch(_base(), [Scenario(integrator="leapfrog"),
                                        Scenario(integrator="implicit-cg")]),
        lambda: JBatch(_jbase(), [JScenario(integrator="leapfrog"),
                                  JScenario(integrator="implicit-cg")]))
    _raises_like(
        lambda: ScenarioBatch(_base(equation="wave"), [Scenario(coef_field=("uniform",))]),
        lambda: JBatch(_jbase(equation="wave"), [JScenario(coef_field=("uniform",))]))


def test_member_configs_and_bucket_keys_match_jax():
    from heat3d_tpu.serve import scenario as js

    specs = _specs()
    for kw in ({}, {"kind": "27pt", "tb": 2}, {"bf16": True, "periodic": True}):
        mine = ScenarioBatch(_base(**kw), _members(specs))
        ref = js.ScenarioBatch(_jbase(**kw), [js.Scenario(**s) for s in specs])
        assert mine.bucket_key() == ref.bucket_key()
        assert solver_bucket_key(mine.base) == js.solver_bucket_key(ref.base)
        for m in range(len(specs)):
            assert mine.member_dt(m) == ref.member_dt(m)
            assert mine.member_steps(m) == ref.member_steps(m)
            np.testing.assert_array_equal(mine.member_taps(m), ref.member_taps(m))
    cf = Scenario(coef_field="checker")
    assert request_bucket_key(_base(), cf) == js.request_bucket_key(
        _jbase(), js.Scenario(coef_field="checker"))
    assert request_bucket_key(_base(), cf)[-1] == "coef-field"
    assert ScenarioBatch(_base(), [cf]).member_dt(0) == js.ScenarioBatch(
        _jbase(), [js.Scenario(coef_field="checker")]).member_dt(0)
    # values are per-member tensors, structure buckets
    a = ScenarioBatch(_base(grid=10), [Scenario(alpha=0.3)])
    b = ScenarioBatch(_base(grid=10), [Scenario(alpha=0.9, bc_value=2.0)])
    c = ScenarioBatch(_base(grid=12), [Scenario(alpha=0.3)])
    d = ScenarioBatch(_base(grid=10, kind="27pt"), [Scenario(alpha=0.3)])
    assert a.bucket_key() == b.bucket_key() != c.bucket_key() != d.bucket_key()


def test_ensemble_refusals_match_jax():
    from heat3d_tpu.serve.ensemble import EnsembleSolver as JEnsemble
    from heat3d_tpu.serve.scenario import Scenario as JScenario
    from heat3d_tpu.serve.scenario import ScenarioBatch as JBatch

    specs = _specs(3)
    cases = [
        ({"backend": "pallas"}, {}), ({"backend": "conv"}, {}), ({"halo": "dma"}, {}),
        ({"halo_order": "pairwise"}, {}), ({"overlap": True}, {}),
        ({"integrator": "implicit-cg"}, {}), ({}, {"batch_mesh": 2}),
        ({"time_blocking": 3, "grid": GridConfig.cube(2)}, {}),
    ]
    for over, kw in cases:
        jover = dict(over)
        if "grid" in jover:
            from heat3d_tpu.core import config as rc

            jover["grid"] = rc.GridConfig.cube(2)
        mine = ScenarioBatch(dataclasses.replace(_base(), **over), _members(specs))
        ref = JBatch(dataclasses.replace(_jbase(), **jover), [JScenario(**s) for s in specs])
        _raises_like(lambda: EnsembleSolver(mine, device="cpu", **kw),
                     lambda: JEnsemble(ref, **kw))
    four = _members(_specs(4))
    _raises_like(
        lambda: EnsembleSolver(ScenarioBatch(_base(), four), batch_mesh=2, bind="baked",
                               device="cpu"),
        lambda: JEnsemble(JBatch(_jbase(), [JScenario(**s) for s in _specs(4)]),
                          batch_mesh=2, bind="baked"))
    cf = [Scenario(**s, coef_field=("uniform",)) for s in specs]
    jcf = [JScenario(**s, coef_field=("uniform",)) for s in specs]
    _raises_like(lambda: EnsembleSolver(ScenarioBatch(_base(), cf), bind="baked", device="cpu"),
                 lambda: JEnsemble(JBatch(_jbase(), jcf), bind="baked"))
    _raises_like(lambda: EnsembleSolver(ScenarioBatch(_base(tb=2), cf), device="cpu"),
                 lambda: JEnsemble(JBatch(_jbase(tb=2), jcf)))


def test_ensemble_pins_auto_knobs_to_the_chain():
    auto = dataclasses.replace(_base(), backend="auto", halo="auto", time_blocking=0)
    es = EnsembleSolver(ScenarioBatch(auto, _members(_specs(3))), device="cpu")
    assert (es.cfg.backend, es.cfg.halo, es.cfg.time_blocking) == ("jnp", "ppermute", 1)


def test_ensemble_resolves_time_blocking_through_the_batch_bucket(tmp_path, monkeypatch):
    from heat3d_tpu_torch.tune import cache as tcache

    monkeypatch.delenv("HEAT3D_TUNE_DISABLE")
    monkeypatch.setenv(tcache.ENV_CACHE, str(tmp_path / "tc.json"))
    base = dataclasses.replace(_base(), time_blocking=0)
    key = tcache.cache_key(base, batch_size=4, device="cpu")
    assert key.endswith("|b2^2")
    tcache.store_entry(key, dataclasses.replace(base, time_blocking=2), 1.0, device="cpu")
    es = EnsembleSolver(ScenarioBatch(base, _members(_specs())), device="cpu")
    assert es.cfg.time_blocking == 2
    es1 = EnsembleSolver(ScenarioBatch(base, _members(_specs(1))), device="cpu")
    assert es1.cfg.time_blocking == 1  # B=1 is the solo key: a miss


# ---- within the port, bitwise ----------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"tb": 2}, {"kind": "27pt", "tb": 3}, {"bf16": True, "tb": 2},
    {"grid": 13, "mesh": (2, 2, 1), "tb": 2}, {"periodic": True, "mesh": (2, 1, 1)},
], ids=["tb1", "tb2", "27pt-tb3", "bf16-tb2", "uneven-221-tb2", "periodic-211"])
def test_traced_and_baked_equal_solo_bitwise(kw):
    batch = ScenarioBatch(_base(**kw), _members(_specs()))
    traced = _run(batch)
    baked = _run(batch, bind="baked")
    for m in range(len(batch)):
        want = _solo(batch, m)
        np.testing.assert_array_equal(baked[m], want)
        np.testing.assert_array_equal(traced[m], want)


@pytest.mark.parametrize("kw", [{}, {"kind": "27pt", "tb": 2}, {"bf16": True}],
                         ids=["7pt", "27pt-tb2", "bf16"])
def test_packing_invariance_bitwise(kw):
    """A member alone (B=1), in a batch of 4, and in a batch of 8 padded by
    the queue's rule (0-step copies), bitwise the same."""
    from heat3d_tpu_torch.serve.queue import pad_batch

    base = _base(**kw)
    members = _members(_specs())
    b4 = _run(ScenarioBatch(base, members))
    b8 = _run(pad_batch(base, members, 8))
    for m, sc in enumerate(members):
        alone = _run(ScenarioBatch(base, [sc]))[0]
        np.testing.assert_array_equal(b4[m], alone)
        np.testing.assert_array_equal(b8[m], alone)


def test_frozen_members_under_mixed_budgets_bitwise():
    base = _base(tb=2)
    members = _members(_specs())
    es = EnsembleSolver(ScenarioBatch(base, members), device="cpu")
    u0 = es.init_state()
    budgets = [0, 1, 5, 2]
    got = es.gather(es.run(u0, budgets))
    start = es.gather(es.init_state())
    np.testing.assert_array_equal(got[0], start[0])  # budget 0: untouched
    for m, b in enumerate(budgets):
        alone = EnsembleSolver(ScenarioBatch(base, [members[m]]), device="cpu")
        want = alone.gather(alone.run(alone.init_state(), b))[0]
        np.testing.assert_array_equal(got[m], want)


@pytest.mark.parametrize("mesh,batch_mesh", [((2, 1, 1), 1), ((2, 2, 1), 1), ((1, 1, 1), 2),
                                             ((2, 1, 1), 2)],
                         ids=["211", "221", "bm2", "211-bm2"])
def test_meshes_and_batch_mesh_equal_single_shard_bitwise(mesh, batch_mesh):
    members = _members(_specs())
    for tb in (1, 2):
        want = _run(ScenarioBatch(_base(tb=tb), members))
        got = _run(ScenarioBatch(_base(tb=tb, mesh=mesh), members), batch_mesh=batch_mesh)
        np.testing.assert_array_equal(got, want)


def test_member_residuals_equal_solo_bitwise():
    batch = ScenarioBatch(_base(mesh=(2, 1, 1)), _members(_specs()))
    for bind in ("traced", "baked"):
        es = EnsembleSolver(batch, bind=bind, device="cpu")
        u, r = es.step_with_member_residuals(es.init_state())
        assert tuple(r.shape) == (4,)
        for m in range(4):
            solo = HeatSolver3D(batch.member_config(m), device="cpu")
            _, rs = solo.step_with_residual(solo.init_state(batch.members[m].init))
            assert torch.equal(r[m], rs), (bind, m)
        _, agg = es.step_with_residual(u)
        assert float(agg) >= 0.0


def test_coef_field_members_match_the_fp64_reference():
    from heat3d_tpu_torch.core import golden
    from heat3d_tpu_torch.timeint.coeffield import reference_varcoef_step

    names = ("uniform", "layered", "checker", "lognormal")
    for mesh, periodic, n in (((1, 1, 1), False, 13), ((2, 2, 1), True, 12)):
        members = [Scenario(**s, coef_field=(nm, i)) for i, (s, nm) in
                   enumerate(zip(_specs(), names))]
        batch = ScenarioBatch(_base(grid=n, mesh=mesh, periodic=periodic), members)
        got = _run(batch)
        for m, sc in enumerate(members):
            u = golden.make_init(sc.init, (n,) * 3, seed=sc.seed).astype(np.float64)
            a = batch.member_coef_field(m)
            for _ in range(sc.steps):
                u = reference_varcoef_step(u, a, batch.member_dt(m), (1.0, 1.0, 1.0),
                                           periodic=periodic, bc_value=sc.bc_value)
            np.testing.assert_allclose(got[m], u, rtol=0, atol=1e-5 * max(1.0, np.abs(u).max()))


def test_checkpoint_round_trip_and_supervised_run(tmp_path):
    batch = ScenarioBatch(_base(mesh=(2, 1, 1)), _members(_specs()))
    es = EnsembleSolver(batch, device="cpu", batch_mesh=2)
    u = es.run(es.init_state(), 2)
    es.save_checkpoint(str(tmp_path / "ck"), u, 2)
    man = json.load(open(tmp_path / "ck" / "manifest.json"))
    assert man["global_shape"] == [4, 12, 12, 12] and len(man["shards"]) == 4
    # another layout of the same storage shape loads it (the stitch)
    other = EnsembleSolver(batch, device="cpu")
    v, step = other.load_checkpoint(str(tmp_path / "ck"))
    assert step == 2
    np.testing.assert_array_equal(other.gather(v), es.gather(u))
    res = es.run_supervised(4, str(tmp_path / "gens"), checkpoint_every=2)
    assert res.steps_done == 4
    # lockstep: every member 4 steps, as one unsupervised run
    lock = EnsembleSolver(ScenarioBatch(_base(), _members(_specs())), device="cpu")
    np.testing.assert_array_equal(es.gather(res.u), lock.gather(lock.run(lock.init_state(), 4)))


# ---- the queue ----------------------------------------------------------------


def test_pad_pow2_and_padded_size_as_jax():
    from heat3d_tpu.serve import queue as jq
    from heat3d_tpu_torch.serve import queue as q

    for n in (1, 2, 3, 5, 64, 100):
        for cap in (8, 64):
            assert q._pad_pow2(n, cap) == jq._pad_pow2(n, cap)
            for bm in (1, 2, 3, 4):
                assert q._padded_size(n, cap, bm) == jq._padded_size(n, cap, bm)


def test_queue_buckets_pack_and_stream_in_submission_order(tmp_path):
    from heat3d_tpu_torch.serve.queue import ScenarioQueue

    led = str(tmp_path / "serve.jsonl")
    obs.activate(led, meta={"entry": "test"})
    try:
        q = ScenarioQueue(device="cpu")
        a, b = _base(grid=10), _base(grid=12)
        specs = _specs()
        rids = [q.submit(a, Scenario(**specs[0])), q.submit(b, Scenario(alpha=0.6, steps=3)),
                q.submit(a, Scenario(**specs[1])), q.submit(b, Scenario(alpha=0.9, steps=2)),
                q.submit(a, Scenario(**specs[2]))]
        assert rids == [0, 1, 2, 3, 4] and len(q) == 5
        results = list(q.drain())
        assert len(q) == 0
    finally:
        obs.deactivate(rc=0)
    assert [r.request_id for r in results] == rids
    by = {r.request_id: r for r in results}
    assert by[0].batch_size == by[2].batch_size == 3
    assert by[1].batch_size == by[3].batch_size == 2
    events = [json.loads(ln) for ln in open(led) if ln.strip()]
    names = [e.get("event") for e in events]
    assert names.count("serve_submit") == 5 and names.count("serve_result") == 5
    assert names.count("serve_batch_start") == 2 and names.count("serve_metrics_summary") == 1
    spans = [e for e in events if e.get("event") == "serve_batch" and e.get("kind") == "span"]
    assert len(spans) == 2
    assert sum(s["cell_updates"] for s in spans) == (4 + 3 + 2) * 1000 + (3 + 2) * 1728
    assert all(s["init_s"] >= 0 and s["run_s"] >= 0 and s["gather_s"] >= 0 for s in spans)
    summary = [e for e in events if e.get("event") == "serve_metrics_summary"][0]
    assert summary["delivered"] == 5 and summary["batches"] == 2
    # the live members of the padded batch (3 -> 4) equal the unpadded batch
    base = _base(grid=10)
    want = _run(ScenarioBatch(base, [Scenario(**s) for s in specs[:3]]))
    for rid, m in ((0, 0), (2, 1), (4, 2)):
        np.testing.assert_array_equal(by[rid].field, want[m])


def test_queue_reuses_the_bucket_solver_and_rebinds_values():
    from heat3d_tpu_torch.serve.queue import ScenarioQueue

    q = ScenarioQueue(device="cpu")
    base = _base()
    specs = _specs()
    for s in specs[:2]:
        q.submit(base, Scenario(**s))
    first = list(q.drain())
    solver = next(iter(q._solvers.values()))
    plans = dict(solver._plans)
    for s in specs[2:]:
        q.submit(base, Scenario(**s))
    second = list(q.drain())
    assert len(q._solvers) == 1 and next(iter(q._solvers.values())) is solver
    assert all(solver._plans[k] is p for k, p in plans.items())
    want = _run(ScenarioBatch(base, _members(specs)))
    for r, m in zip(first + second, range(4)):
        np.testing.assert_array_equal(r.field, want[m])


def test_queue_default_budget_backpressure_and_failing_bucket():
    from heat3d_tpu_torch.serve.queue import Backpressure, ScenarioQueue

    q = ScenarioQueue(device="cpu")
    q.submit(_base(grid=10, steps=2), Scenario(alpha=0.5, seed=1))
    q.submit(_base(grid=10, steps=4), Scenario(alpha=0.5, seed=1))
    res = {r.request_id: r for r in q.drain()}
    assert (res[0].steps, res[1].steps) == (2, 4)
    assert not np.array_equal(res[0].field, res[1].field)

    q = ScenarioQueue(max_depth=2, device="cpu")
    q.submit(_base(), Scenario())
    q.submit(_base(), Scenario())
    with pytest.raises(Backpressure, match="queue full") as e:
        q.submit(_base(), Scenario())
    assert e.value.depth == 2 and e.value.max_depth == 2
    list(q.drain())
    q.submit(_base(), Scenario())

    q = ScenarioQueue(device="cpu")
    good = q.submit(_base(grid=10), Scenario(**_specs()[0]))
    bad = q.submit(_base(grid=2, tb=2), Scenario(**_specs()[1]))
    got = []
    with pytest.raises(ValueError, match="local extents"):
        for r in q.drain():
            got.append(r.request_id)
    assert got == [good] and bad in q._pending and good not in q._pending


def test_queue_snapshots_and_residuals():
    from heat3d_tpu_torch.serve.queue import ScenarioQueue

    q = ScenarioQueue(snapshot_every=2, with_residuals=True, device="cpu")
    base = _base(grid=8)
    q.submit(base, Scenario(alpha=0.5, steps=5, seed=1))
    q.submit(base, Scenario(alpha=0.3, steps=2, seed=2))
    res = {r.request_id: r for r in q.drain()}
    assert len(res[0].snapshots) == 3 and res[0].residual_sumsq is not None
    np.testing.assert_array_equal(res[0].snapshots[-1], res[0].field)
    np.testing.assert_array_equal(res[1].snapshots[0], res[1].field)
    np.testing.assert_array_equal(res[1].snapshots[2], res[1].field)
    es = EnsembleSolver(ScenarioBatch(base, [Scenario(alpha=0.5, steps=5, seed=1)]),
                        device="cpu")
    _, r = es.step_with_member_residuals(es.run(es.init_state()))
    assert res[0].residual_sumsq == float(r[0])


# ---- the command line -----------------------------------------------------------


def _jax_serve(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("HEAT3D_LEDGER", None)
    out = subprocess.run([sys.executable, "-m", "heat3d_tpu", "serve", *argv], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]


def _port_serve(argv, capsys):
    from heat3d_tpu_torch.cli import main

    assert main(["serve", *argv, "--device", "cpu"]) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _same_lines(mine, ref, bf16_ids=()):
    """Equal ids, steps and batch members; the field statistics of a
    float32 request within 1e-6 (relative). A bf16 request's statistics
    move with a single bf16 ulp of one cell (XLA contracts a multiply-add
    the port rounds twice): its fields are held per cell instead
    (:func:`test_serve_requests_mixed_buckets_match_jax`)."""
    assert [(r["request_id"], r["steps"], r["batch_members"]) for r in mine] == \
        [(r["request_id"], r["steps"], r["batch_members"]) for r in ref]
    for a, b in zip(mine, ref):
        if a["request_id"] in bf16_ids:
            continue
        for k in ("field_mean", "field_max"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-9)


def test_serve_smoke_matches_jax(capsys):
    _same_lines(_port_serve(["--smoke"], capsys), _jax_serve(["--smoke"]))


def test_serve_requests_mixed_buckets_match_jax(tmp_path, capsys):
    recs = [
        {"grid": 12, "steps": 4, "alpha": 0.5, "bc_value": 1.0, "seed": 1},
        {"grid": 12, "steps": 3, "stencil": "27pt", "time_blocking": 2, "init": "random",
         "seed": 5},
        {"grid": 12, "steps": 6, "alpha": 0.8, "init": "gaussian", "seed": 2},
        {"grid": 10, "steps": 3, "dtype": "bf16", "bc_value": 0.3},
        {"grid": 12, "steps": 2, "equation": "advection-diffusion",
         "eq_params": {"vx": 1.5}},
        {"grid": 12, "steps": 3, "coef_field": ["layered", 1], "init": "random"},
        {"grid": 12, "steps": 5, "stencil": "27pt", "time_blocking": 2, "alpha": 0.4},
        {"grid": 12, "steps": 4, "coef_field": "checker", "bc_value": 0.5},
    ]
    path = tmp_path / "reqs.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    mine = _port_serve(["--requests", str(path), "--residuals", "--out",
                        str(tmp_path / "mine")], capsys)
    ref = _jax_serve(["--requests", str(path), "--residuals", "--out", str(tmp_path / "ref")])
    bf16 = {i for i, r in enumerate(recs) if r.get("dtype") == "bf16"}
    _same_lines(mine, ref, bf16)
    for rec, a, b in zip(recs, mine, ref):
        storage = "bfloat16" if rec.get("dtype") == "bf16" else "float32"
        want = np.load(b["field_path"])
        if want.dtype.kind == "V":  # the JAX package saves bf16 as ml_dtypes'
            import ml_dtypes

            want = want.view(ml_dtypes.bfloat16)
        assert_close_per_update(np.load(a["field_path"]), want.astype(np.float32), storage,
                                rec["steps"], err_msg=f"request {a['request_id']}")
        # the probe update's squared change: fp32 rounding in float32; a
        # bf16 field's change moves by a bf16 ulp (2^-8 relative) where a
        # cell rounded the other way
        np.testing.assert_allclose(a["residual_sumsq"], b["residual_sumsq"],
                                   rtol=2.0**-7 if storage == "bfloat16" else 1e-5)


def test_serve_bench_row_passes_the_jax_provenance_lint(tmp_path, capsys):
    from heat3d_tpu.analysis.provenance import check_row
    from heat3d_tpu_torch.serve.bench import bench_ensemble_throughput

    row = bench_ensemble_throughput(ScenarioBatch(_base(grid=8), _members(_specs(3))),
                                    steps=3, warmup=1, repeats=1, device="cpu")
    assert row["batch_shape"] == [3] and row["members_per_step"] == 3
    assert row["platform"] == "cpu" and sum(row["kernel_launches"].values()) == 0
    assert check_row(row) == []
    rows = tmp_path / "rows.jsonl"
    lines = _port_serve(["--bench", "--members", "2", "--grid", "8", "--steps", "2",
                         "--row", str(rows)], capsys)
    assert lines[0]["members_per_step"] == 2 and check_row(lines[0]) == []
    assert json.loads(rows.read_text())["members_per_step"] == 2


def test_serve_cli_null_request_value_exits_clean(tmp_path, capsys):
    from heat3d_tpu_torch.serve.cli import main

    p = tmp_path / "reqs.jsonl"
    p.write_text('{"grid": 12, "steps": null}\n')
    assert main(["--requests", str(p), "--device", "cpu"]) == 2
    assert "heat3d serve: error:" in capsys.readouterr().err


@pytest.mark.parametrize("kind,mehrstellen,compute", [
    ("7pt", False, torch.float32), ("27pt", False, torch.float32),
    ("27pt", True, torch.float32), ("27pt", True, torch.bfloat16)])
def test_batched_apply_is_each_members_solo_apply_bitwise(kind, mehrstellen, compute):
    """The chain and the Mehrstellen route run one body over a block's last
    three dims: over a batch of members with their own taps, member m's
    update equals the solo ``apply_taps_padded`` of its taps, bitwise; at
    fp32 the chain of one member also holds to JAX's
    ``stencil_jnp.apply_taps_padded_params``."""
    from heat3d_tpu_torch.ops import stencil_eager as se
    from torch_port_checks import _taps

    shape = (9, 10, 11)
    member_taps = [_taps(kind, shape) * f for f in (1.0, 0.5, 0.3)]
    u = np.random.default_rng(3).standard_normal((3,) + shape).astype(np.float32)
    ups = [se.pad_local(torch.from_numpy(x), BoundaryCondition.DIRICHLET, b)
           for x, b in zip(u, (0.0, 1.0, -0.5))]
    up = torch.stack(ups)
    if mehrstellen:
        c = torch.tensor([[se.compute_weight(x, compute)
                           for x in se.decompose_mehrstellen(t)] for t in member_taps],
                         dtype=torch.float32).to(compute).reshape(3, 3, 1, 1, 1)
        out = se._apply_mehrstellen_padded(up.to(compute), [c[:, i] for i in range(3)])
        out = out.to(up.dtype)
    else:
        flat = se.flat_taps(member_taps[0])
        w = se.member_weights(member_taps, se.emission_positions(flat), compute)
        out = se.apply_taps_padded_params(up, flat, w, compute_dtype=compute)
    for m in range(3):
        solo = se.apply_taps_padded(ups[m], member_taps[m], mehrstellen=mehrstellen,
                                    compute_dtype=compute)
        assert torch.equal(out[m], solo), m
    if not mehrstellen and compute == torch.float32:
        import jax.numpy as jnp

        from heat3d_tpu.core.stencils import flat_taps as jflat_taps
        from heat3d_tpu.ops import stencil_jnp

        jflat = jflat_taps(member_taps[1])
        jw = [np.float32(member_taps[1][di + 1, dj + 1, dk + 1])
              for di, dj, dk in stencil_jnp.emission_positions(jflat)]
        want = stencil_jnp.apply_taps_padded_params(
            jnp.asarray(ups[1].numpy()), jflat, jnp.asarray(jw, jnp.float32))
        assert_close_per_update(out[1].numpy(), np.asarray(want), "float32", 1)


@pytest.mark.parametrize("mesh_shape,periodic,width", [
    ((1, 1, 1), False, 1), ((2, 1, 1), True, 2), ((2, 2, 1), False, 1),
    ((1, 2, 2), True, 1)])
def test_batched_exchange_is_each_members_solo_exchange_bitwise(mesh_shape, periodic,
                                                                 width):
    """``BatchedExchangePlan`` runs the solo slab copies
    (``parallel.halo.push_axis_slabs``) on blocks with a batch extent and a
    (B, 1, 1, 1) bc tensor: member m's padded blocks equal a solo
    ``ExchangePlan`` apply of member m with its own boundary value,
    bitwise."""
    from heat3d_tpu_torch.parallel.plan import BatchedExchangePlan, ExchangePlan
    from heat3d_tpu_torch.parallel.topology import ShardMesh

    local = (4, 5, 6)
    n = int(np.prod(mesh_shape))
    mesh = ShardMesh(mesh_shape, local, [torch.device("cpu")] * n)
    bc = BoundaryCondition.PERIODIC if periodic else BoundaryCondition.DIRICHLET
    bcs = (0.0, 1.0, -0.25)
    rng = np.random.default_rng(5)
    us = [torch.from_numpy(rng.standard_normal((3,) + local).astype(np.float32))
          for _ in range(n)]
    bcv = torch.tensor(bcs, dtype=torch.float32).reshape(3, 1, 1, 1)
    pads = BatchedExchangePlan(mesh, bc, width, torch.float32, 3).apply(us, bcv)
    solo = ExchangePlan(mesh, bc, width, "ppermute", torch.float32)
    for m, b in enumerate(bcs):
        want = solo.apply([u[m].clone() for u in us], b)
        for r in range(n):
            assert torch.equal(pads[r][m], want[r]), (m, r)
