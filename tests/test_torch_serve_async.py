"""The port's async serving engine and its warm-up cache
(``heat3d_tpu_torch.serve.engine``, ``serve/aot.py``) on the CPU, held to
the JAX package's.

- The command line: ``serve --requests --async --residuals --device cpu``
  over mixed buckets and streams gives every result line (and saved
  field) bitwise equal to the port's synchronous command, and within the
  ``torch_port_checks`` tolerance of JAX's ``serve --async`` (bf16
  storage: one bf16 ulp, as ``test_torch_serve.py`` holds the
  synchronous lines); ``--verdict``, ``--no-aot`` and ``--slo`` /
  ``$HEAT3D_SLO_SPEC`` with JAX's rc on the same spec.
- The engine (the counterparts of ``tests/test_serve_async.py`` and of
  ``tests/engine_checks.py``): backpressure under concurrent submitters
  with a typed payload, ``cancel`` and shutdown refusal, the summary's
  shape equal to the queue's (and to JAX's), async equal to the drain
  bitwise, submission accepted while a batch flies, per-stream order
  under out-of-order completion, failure isolation.
- The warm-up cache: keys apart by bucket, B and exchange plan; an
  in-process hit with no ``compile_stall``; a fresh process lands a miss;
  a stale entry is warmed again; ``off`` measures and remembers nothing.
- The backend-loss requeue (the engine cases of ``tests/test_elastic.py``):
  ``is_backend_loss``, ``ServeStats``' refcounted degraded window, an
  injected ``partial-device-loss`` delivering results bitwise equal to a
  clean run with ``degraded_s > 0`` and ``serve_requeues_total`` counted,
  a scenario error failing at once, exhausted retries failing the chunk.
- The wait of a packed batch: ``utils.timing.stream_sync`` waits on
  exactly the solver's streams, never the whole card; a CUDA-marked case
  shows one worker's gather not waiting for another worker's long batch.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from heat3d_tpu_torch import obs
from heat3d_tpu_torch.core.config import (
    GridConfig,
    MeshConfig,
    Precision,
    RunConfig,
    SolverConfig,
    StencilConfig,
)
from heat3d_tpu_torch.resilience.faults import FaultPlan, _parse_spec
from heat3d_tpu_torch.resilience.retry import RetryPolicy
from heat3d_tpu_torch.serve.engine import AsyncServeEngine
from heat3d_tpu_torch.serve.queue import Backpressure, ScenarioQueue
from heat3d_tpu_torch.serve.scenario import Scenario, ScenarioBatch
from torch_port_checks import assert_close_per_update

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# mixed buckets and streams: 7pt, 27pt tb=2, bf16 storage, an equation
# family, coefficient fields
RECORDS = [
    {"grid": 12, "steps": 4, "alpha": 0.5, "bc_value": 1.0, "seed": 1},
    {"grid": 12, "steps": 3, "stencil": "27pt", "time_blocking": 2, "init": "random",
     "seed": 5, "stream": "t2"},
    {"grid": 12, "steps": 6, "alpha": 0.8, "init": "gaussian", "seed": 2},
    {"grid": 10, "steps": 3, "dtype": "bf16", "bc_value": 0.3, "stream": "t2"},
    {"grid": 12, "steps": 2, "equation": "advection-diffusion", "eq_params": {"vx": 1.5}},
    {"grid": 12, "steps": 3, "coef_field": ["layered", 1], "init": "random", "stream": "t3"},
    {"grid": 12, "steps": 5, "stencil": "27pt", "time_blocking": 2, "alpha": 0.4,
     "stream": "t2"},
    {"grid": 12, "steps": 4, "coef_field": "checker", "bc_value": 0.5, "stream": "t3"},
]


def _base(grid=8, steps=2, tb=1, mesh=(1, 1, 1)):
    return SolverConfig(
        grid=GridConfig.cube(grid),
        stencil=StencilConfig(kind="7pt"),
        mesh=MeshConfig(shape=mesh),
        precision=Precision.fp32(),
        run=RunConfig(num_steps=steps),
        backend="jnp",
        halo="ppermute",
        time_blocking=tb,
    )


MEMBERS = [
    Scenario(init="hot-cube", alpha=0.3, bc_value=1.0, steps=6, seed=1),
    Scenario(init="gaussian", alpha=0.8, bc_value=0.0, steps=5, seed=2),
    Scenario(init="random", alpha=0.5, bc_value=-0.5, steps=4, seed=3),
]


def _engine(**kw):
    kw.setdefault("device", "cpu")
    return AsyncServeEngine(**kw)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Every test gets its own warm-up store namespace and tune cache, no
    ambient ledger, SLO spec or fault plan."""
    monkeypatch.setenv("HEAT3D_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("HEAT3D_TUNE_CACHE", str(tmp_path / "tune.json"))
    for var in ("HEAT3D_LEDGER", "HEAT3D_SLO_SPEC", "HEAT3D_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    obs.deactivate()
    yield
    obs.deactivate()


def _events(path):
    return [json.loads(line) for line in open(path)]


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _port_serve(argv, capsys, rc=0):
    from heat3d_tpu_torch.cli import main

    assert main(["serve", *argv, "--device", "cpu"]) == rc
    out, err = capsys.readouterr()
    return _lines(out), err


# ---- the command line ----------------------------------------------------------


def test_async_lines_bitwise_to_sync_and_close_to_jax_async(tmp_path, capsys):
    path = tmp_path / "reqs.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in RECORDS) + "\n")
    sync, _ = _port_serve(["--requests", str(path), "--residuals", "--out",
                           str(tmp_path / "sync")], capsys)
    mine, _ = _port_serve(["--requests", str(path), "--residuals", "--async", "--out",
                           str(tmp_path / "async")], capsys)
    # per-stream submission order: each stream's ids ascend
    for stream in ("", "t2", "t3"):
        ids = [r["request_id"] for r in mine
               if (RECORDS[r["request_id"]].get("stream") or "") == stream]
        assert ids == sorted(ids) and ids
    by_id = {r["request_id"]: r for r in mine}
    assert sorted(by_id) == [r["request_id"] for r in sync] == list(range(len(RECORDS)))
    for s in sync:
        a = by_id[s["request_id"]]
        for k in ("steps", "batch_members", "field_mean", "field_max", "residual_sumsq"):
            assert a[k] == s[k], (s["request_id"], k)
        assert np.array_equal(np.load(a["field_path"]), np.load(s["field_path"]))

    env = dict(os.environ, JAX_PLATFORMS="cpu", HEAT3D_AOT_CACHE=str(tmp_path / "jaot"))
    env.pop("HEAT3D_LEDGER", None)
    out = subprocess.run([sys.executable, "-m", "heat3d_tpu", "serve", "--requests",
                          str(path), "--residuals", "--async", "--out",
                          str(tmp_path / "ref")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = {r["request_id"]: r for r in _lines(out.stdout)}
    assert sorted(ref) == sorted(by_id)  # streams interleave by completion in both
    for rid, rec in enumerate(RECORDS):
        a, b = by_id[rid], ref[rid]
        assert (a["steps"], a["batch_members"]) == (b["steps"], b["batch_members"])
        storage = "bfloat16" if rec.get("dtype") == "bf16" else "float32"
        want = np.load(b["field_path"])
        if want.dtype.kind == "V":  # the JAX package saves bf16 as ml_dtypes'
            import ml_dtypes

            want = want.view(ml_dtypes.bfloat16)
        assert_close_per_update(np.load(a["field_path"]), want.astype(np.float32), storage,
                                rec["steps"], err_msg=f"request {rid}")
        np.testing.assert_allclose(a["residual_sumsq"], b["residual_sumsq"],
                                   rtol=2.0**-7 if storage == "bfloat16" else 1e-5)


def test_serve_cli_async_smoke_verdict_and_results(capsys):
    lines, _ = _port_serve(["--async", "--smoke", "--verdict"], capsys)
    verdict = lines[-1]["serve_verdict"]
    assert verdict["ok"] and verdict["delivered"] == verdict["requests"] == 3
    eng = verdict["engine"]
    assert eng["batches"] >= 2 and eng["failed"] == 0
    assert eng["aot"]["misses"] == 2 and eng["aot"]["stalls"] == 2
    assert eng["aot"]["hits"] == 0 and eng["aot"]["exports"] == 0
    assert [r["request_id"] for r in lines[:-1]] == [0, 1, 2]
    sync, _ = _port_serve(["--smoke", "--verdict"], capsys)
    assert "engine" not in sync[-1]["serve_verdict"]  # omitted, not null
    for s, a in zip(sync[:-1], lines[:-1]):
        assert (s["field_mean"], s["field_max"], s["steps"]) == \
            (a["field_mean"], a["field_max"], a["steps"])


def test_serve_cli_no_aot_skips_the_warm_up(tmp_path, capsys):
    led = tmp_path / "led.jsonl"
    lines, _ = _port_serve(["--async", "--smoke", "--verdict", "--no-aot", "--ledger",
                            str(led)], capsys)
    aot = lines[-1]["serve_verdict"]["engine"]["aot"]
    assert aot["misses"] == aot["hits"] == aot["stalls"] == 0
    names = {e["event"] for e in _events(led)}
    assert not names & {"aot_cache_miss", "aot_cache_hit", "compile_stall"}
    warm, _ = _port_serve(["--async", "--smoke"], capsys)
    assert [r["field_mean"] for r in lines[:-1]] == [r["field_mean"] for r in warm]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_serve_cli_slo_rc_equals_jax(mode, tmp_path, capsys, monkeypatch):
    """``serve --slo``: a breaching drain exits 1 though every result
    delivered, a passing spec 0 (a mixed spec's step objective noted as
    not evaluable), a missing spec 2 before anything runs, and
    ``$HEAT3D_SLO_SPEC`` stands for ``--slo``: the rc equal to JAX's
    ``serve`` on the same spec."""
    from heat3d_tpu.serve.cli import main as jax_serve

    breach = tmp_path / "breach.json"
    breach.write_text(json.dumps({"objectives": [
        {"name": "q95", "kind": "serve_latency", "percentile": 95, "max_s": 1e-9}]}))
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps({"objectives": [
        {"name": "q95", "kind": "serve_latency", "percentile": 95, "max_s": 120.0},
        {"name": "deg", "kind": "serve_degraded", "max_s": 1.0},
        {"name": "step95", "kind": "step_time", "percentile": 95, "max_s": 1e-9}]}))
    flags = ["--async"] if mode == "async" else []
    for spec, want in ((breach, 1), (ok, 0), (tmp_path / "nope.json", 2)):
        lines, err = _port_serve(["--smoke", *flags, "--slo", str(spec)], capsys, rc=want)
        if want == 2:
            assert lines == [] and "--slo" in err
            continue
        assert len(lines) == 3
        assert f"slo verdict: {'breach' if want else 'pass'}" in err
        if want == 0:
            assert "step95 not evaluable at drain time" in err
        assert jax_serve(["--smoke", *flags, "--slo", str(spec)]) == want
        capsys.readouterr()
    monkeypatch.setenv("HEAT3D_SLO_SPEC", str(breach))
    _port_serve(["--smoke", *flags], capsys, rc=1)
    assert jax_serve(["--smoke", *flags]) == 1
    capsys.readouterr()


def test_serve_cli_async_failed_bucket_is_delivered_n_of_m(tmp_path, capsys):
    path = tmp_path / "reqs.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in [
        {"grid": 8, "steps": 2}, {"grid": 2, "time_blocking": 2, "steps": 2},
        {"grid": 8, "steps": 3, "alpha": 0.4}]) + "\n")
    lines, err = _port_serve(["--requests", str(path), "--async"], capsys, rc=1)
    assert [r["request_id"] for r in lines] == [0, 2]
    assert "delivered 2 of 3 requests" in err and "local extents" in err


# ---- the engine ------------------------------------------------------------------


def test_backpressure_under_concurrent_submitters():
    hold = threading.Event()
    started = threading.Event()

    def hook(bucket, rids):
        started.set()
        assert hold.wait(timeout=60)

    eng = _engine(max_depth=3, workers=1, before_execute=hook, aot=False)
    base = _base()
    eng.submit(base, Scenario(alpha=0.5, seed=0))
    assert started.wait(timeout=60)
    accepted, rejected = [], []
    lock = threading.Lock()

    def submitter(k):
        for i in range(3):
            try:
                rid = eng.submit(base, Scenario(alpha=0.4, seed=10 * k + i))
                with lock:
                    accepted.append(rid)
            except Backpressure as e:
                assert "queue full" in str(e) and isinstance(e, RuntimeError)
                assert e.max_depth == 3 and e.depth == 3 and e.stream == ""
                assert e.per_stream == {"": 3} and e.stream_cap == 3
                with lock:
                    rejected.append((k, i))

    threads = [threading.Thread(target=submitter, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(accepted) == 2 and len(rejected) == 10, (accepted, rejected)
    st = eng.stats()
    assert st["submitted"] == 13 and st["admitted"] == 3 and st["shed"] == 10
    hold.set()
    got = [r.request_id for r in eng.drain(timeout=120)]
    assert sorted(got) == sorted([0] + accepted)
    eng.shutdown()


def test_per_stream_cap_sheds_the_flood_and_keeps_the_other_stream():
    """The ``HEAT3D_SERVE_MAX_PER_STREAM`` leg of admission (the default
    mode of ``tests/soak_checks.py``): with every batch held, the flood is
    shed at its cap with typed per-stream occupancy, the other stream's
    requests are admitted, and after release they deliver in submission
    order, bitwise equal to an unloaded queue run."""
    ref_q = ScenarioQueue(device="cpu")
    good_base, flood_base = _base(12, steps=4), _base(10, steps=2)
    ref_rids = [ref_q.submit(good_base, sc) for sc in MEMBERS]
    ref = {r.request_id: r for r in ref_q.drain()}
    hold = threading.Event()
    eng = _engine(workers=1, max_per_stream=3, max_depth=64, aot=False,
                  before_execute=lambda b, r: hold.wait(timeout=120))
    good = [eng.submit(good_base, sc, stream="good") for sc in MEMBERS]
    flood, shed = [], 0
    for i in range(5):
        try:
            flood.append(eng.submit(flood_base, Scenario(alpha=0.4, steps=2, seed=i),
                                    stream="flood"))
        except Backpressure as e:
            shed += 1
            assert (e.stream, e.stream_cap, e.stream_depth) == ("flood", 3, 3)
            assert e.per_stream == {"good": 3, "flood": 3}
    assert len(flood) == 3 and shed == 2
    with pytest.raises(Backpressure, match="admission cap"):
        eng.submit(good_base, MEMBERS[0], stream="good")
    st = eng.stats()
    assert (st["admitted"], st["shed"], st["submitted"]) == (6, 3, 9)
    assert st["shed_by_stream"] == {"flood": 2, "good": 1}
    hold.set()
    got = {}
    order = []
    for r in eng.drain(timeout=300):
        got[r.request_id] = r
        if r.request_id in good:
            order.append(r.request_id)
    eng.shutdown()
    assert order == good and all(rid in got for rid in flood)
    for rid, ref_rid in zip(good, ref_rids):
        assert np.array_equal(got[rid].field, ref[ref_rid].field)


def test_cancel_pending_and_shutdown_refuses_submissions():
    hold = threading.Event()
    started = threading.Event()

    def hook(bucket, rids):
        started.set()
        assert hold.wait(timeout=60)

    eng = _engine(workers=1, before_execute=hook, aot=False)
    base = _base()
    rid1 = eng.submit(base, Scenario(alpha=0.5, seed=0))
    assert started.wait(timeout=60)
    rid2 = eng.submit(base, Scenario(alpha=0.4, seed=1))  # bucket busy
    assert eng.cancel(rid2) is True
    assert eng.cancel(rid1) is False  # in flight: results are coming
    assert eng.cancel(99) is False
    hold.set()
    assert [r.request_id for r in eng.drain(timeout=120)] == [rid1]
    stats = eng.stats()
    assert stats["cancelled"] == 1 and stats["delivered"] == 1
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(base, Scenario(alpha=0.5))
    eng.shutdown()  # idempotent


def test_engine_summary_matches_queue_and_jax_shape_for_slo(tmp_path):
    from heat3d_tpu.serve.queue import ServeStats as JaxServeStats
    from heat3d_tpu_torch.obs.perf import slo as slo_mod

    base = _base()
    q = ScenarioQueue(device="cpu")
    q.submit(base, Scenario(alpha=0.5, seed=0))
    list(q.drain())
    led = tmp_path / "led.jsonl"
    obs.activate(str(led))
    with _engine(workers=1, aot=False) as eng:
        eng.submit(base, Scenario(alpha=0.5, seed=0))
        list(eng.drain(timeout=120))
        summary = eng.metrics_summary()
    obs.deactivate()
    assert set(summary) == set(q.metrics_summary()) == set(JaxServeStats().summary(0))
    assert summary["delivered"] == 1 and summary["batches"] == 1
    assert summary["degraded"] is False and summary["requeues"] == 0
    (bucket_rec,) = summary["buckets"].values()
    assert {"count", "p50_s", "p95_s", "max_s"} <= set(bucket_rec)
    report = slo_mod.evaluate([], slo_mod.load_spec(None),
                              serve_summary={**summary, "source": "live engine"})
    assert report["verdict"] in ("pass", "warn")
    assert any(o["kind"] == "serve_latency" and o["status"] != "no_data"
               for o in report["objectives"])
    evs = _events(led)
    # one drain-final summary, and the engine's own events
    assert [e["event"] for e in evs].count("serve_metrics_summary") == 1
    names = {e["event"] for e in evs}
    assert {"serve_admission", "serve_dispatch", "serve_batch_ready", "serve_span"} <= names


def _requests(mesh=(1, 1, 1)):
    return ([(_base(16, steps=6, mesh=mesh), sc) for sc in MEMBERS]
            + [(_base(16, steps=6, tb=2, mesh=mesh), sc) for sc in MEMBERS[:2]]
            + [(_base(12, steps=3, mesh=mesh), MEMBERS[0])])


@pytest.mark.parametrize("mesh", [(1, 1, 1), (2, 1, 1)])
def test_async_equals_drain_bitwise(mesh):
    q = ScenarioQueue(device="cpu", with_residuals=True)
    sync_rids = [q.submit(b, sc) for b, sc in _requests(mesh)]
    sync = {r.request_id: r for r in q.drain()}
    with _engine(workers=2, with_residuals=True) as eng:
        rids = [eng.submit(b, sc) for b, sc in _requests(mesh)]
        got = {r.request_id: r for r in eng.drain(timeout=300)}
    assert sorted(got) == rids == sync_rids
    for rid in rids:
        assert np.array_equal(got[rid].field, sync[rid].field), rid
        assert got[rid].residual_sumsq == sync[rid].residual_sumsq
        assert got[rid].steps == sync[rid].steps


def test_submission_in_flight_and_per_stream_order():
    hold = threading.Event()
    first = threading.Event()
    calls = []

    def hook(bucket, rids):
        calls.append(rids)
        if len(calls) == 1:
            first.set()
            assert hold.wait(timeout=120)

    eng = _engine(workers=2, before_execute=hook, aot=False)
    rid_a = eng.submit(_base(16, steps=6), MEMBERS[0])
    assert first.wait(timeout=120)
    rid_a2 = eng.submit(_base(16, steps=6), MEMBERS[1])
    rid_b = eng.submit(_base(12, steps=3), MEMBERS[2])
    assert eng.stats()["accepted_in_flight"] >= 2
    t0 = time.monotonic()
    with eng._cond:
        while eng._req[rid_b].state != "done":
            assert time.monotonic() - t0 < 120, "bucket B never finished"
            eng._cond.wait(1.0)
        assert eng._req[rid_a].state == "dispatched"
        assert eng._pop_next() is None  # B waits for A: one stream
    hold.set()
    assert [r.request_id for r in eng.drain(timeout=300)] == [rid_a, rid_a2, rid_b]
    assert eng.stats()["max_in_flight"] >= 2
    eng.shutdown()


def test_failure_isolation():
    with _engine(workers=2) as eng:
        good1 = eng.submit(_base(16), MEMBERS[0])
        bad = eng.submit(_base(2, tb=2), MEMBERS[1])
        good2 = eng.submit(_base(12, steps=3), MEMBERS[2])
        delivered = []
        with pytest.raises(RuntimeError, match="failed"):
            for r in eng.drain(timeout=300):
                delivered.append(r.request_id)
        assert sorted(delivered) == [good1, good2]
        assert [f["request_id"] for f in eng.failures] == [bad]
        assert "local extents" in eng.failures[0]["error"]


def test_prewarm_forecast_warms_without_serving(tmp_path):
    led = tmp_path / "led.jsonl"
    obs.activate(str(led))
    eng = _engine(workers=1, max_batch=4)
    base = _base(10)
    ev = eng.prewarm(base, expected_members=3)
    assert ev is not None and ev.wait(timeout=60)
    assert eng.prewarm(base, expected_members=3) is None  # already warm (padded 4)
    eng.submit(base, Scenario(alpha=0.5, steps=2))
    list(eng.drain(timeout=60))
    # the live batch (padded 1) made the forecast's size warm: nothing queued
    assert eng.prewarm_forecast() == [] and eng.stats()["prewarmed"] == 2
    eng.shutdown()
    obs.deactivate()
    names = [e["event"] for e in _events(led)]
    assert names.count("aot_prewarm") >= 1
    st = eng.stats()["aot"]
    assert st["misses"] >= 2 and st["stalls"] == st["misses"]


# ---- the warm-up cache ------------------------------------------------------------


def _solver(tb=1, steps=3, members=2, **over):
    import dataclasses

    from heat3d_tpu_torch.serve.ensemble import EnsembleSolver

    base = dataclasses.replace(_base(steps=steps, tb=tb), **over)
    sc = [Scenario(alpha=0.5, bc_value=1.0, seed=0), Scenario(init="gaussian", alpha=0.8,
                                                              seed=1),
          Scenario(alpha=0.7, seed=2)]
    return EnsembleSolver(ScenarioBatch(base, sc[:members]), device="cpu")


def test_aot_key_separates_buckets_and_batch_shapes():
    from heat3d_tpu_torch.serve import aot

    a = aot.aot_key(_solver(tb=1))
    assert a == aot.aot_key(_solver(tb=1))  # deterministic
    assert a != aot.aot_key(_solver(tb=2))  # structural drift re-keys
    assert a != aot.aot_key(_solver(members=3))  # B re-keys
    assert a != aot.aot_key(_solver(halo_plan="partitioned"))  # the plan leg


def test_aot_in_process_hit_and_stale(tmp_path):
    from heat3d_tpu_torch.serve import aot

    led = tmp_path / "led.jsonl"
    obs.activate(str(led))
    s1 = _solver()
    r1 = aot.warm(s1)
    assert r1["outcome"] == "miss" and r1["compile_stall_s"] > 0
    assert r1["exported"] is False
    f1 = s1.gather(s1.run(s1.init_state()))
    s2 = _solver()
    r2 = aot.warm(s2, build_s=0.25)
    assert r2["outcome"] == "hit" and r2["load_s"] == 0.25
    assert r2["compile_stall_s"] is None
    assert np.array_equal(s2.gather(s2.run(s2.init_state())), f1)
    # a remembered entry from another toolchain is stale: warmed again
    key = aot.aot_key(s2)
    aot._WARMED[(aot.aot_dir(), key)]["torch_version"] = "0.0.1-other"
    r3 = aot.warm(_solver())
    assert r3["outcome"] == "stale" and r3["compile_stall_s"] > 0
    assert aot.warm(_solver())["outcome"] == "hit"
    obs.deactivate()
    names = [e["event"] for e in _events(led)]
    assert names.count("compile_stall") == 2 and names.count("aot_cache_miss") == 1
    assert names.count("aot_cache_hit") == 2 and names.count("aot_cache_stale") == 1
    assert "aot_export" not in names
    assert not os.path.exists(aot.aot_dir())  # the store is never written


def test_aot_fresh_process_lands_a_miss(tmp_path):
    code = (
        "import json, sys\n"
        "from heat3d_tpu_torch import obs\n"
        "from heat3d_tpu_torch.core.config import SolverConfig, GridConfig\n"
        "from heat3d_tpu_torch.serve.scenario import Scenario, ScenarioBatch\n"
        "from heat3d_tpu_torch.serve.ensemble import EnsembleSolver\n"
        "from heat3d_tpu_torch.serve import aot\n"
        "obs.activate(sys.argv[1])\n"
        "b = ScenarioBatch(SolverConfig(grid=GridConfig.cube(8), backend='jnp'),"
        " [Scenario(alpha=0.5)])\n"
        "print(json.dumps([aot.warm(EnsembleSolver(b, device='cpu'))['outcome']"
        " for _ in range(2)]))\n"
        "obs.deactivate()\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    for i in range(2):
        led = tmp_path / f"led{i}.jsonl"
        out = subprocess.run([sys.executable, "-c", code, str(led)], env=env,
                             capture_output=True, text=True, timeout=300, cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1]) == ["miss", "hit"]
        assert [e["event"] for e in _events(led)].count("compile_stall") == 1


@pytest.mark.parametrize("value", ["0", "off"])
def test_aot_disabled_measures_but_remembers_nothing(value, tmp_path, monkeypatch):
    from heat3d_tpu_torch.serve import aot

    monkeypatch.setenv("HEAT3D_AOT_CACHE", value)
    assert aot.aot_dir() is None
    led = tmp_path / "led.jsonl"
    obs.activate(str(led))
    for _ in range(2):
        r = aot.warm(_solver())
        assert r["outcome"] == "disabled" and r["compile_stall_s"] > 0
    obs.deactivate()
    names = [e["event"] for e in _events(led)]
    assert names.count("compile_stall") == 2
    assert not {"aot_export", "aot_cache_miss", "aot_cache_hit"} & set(names)


# ---- the backend-loss requeue ------------------------------------------------------


def test_is_backend_loss_classification():
    from heat3d_tpu.serve.engine.core import is_backend_loss as jax_is_loss
    from heat3d_tpu_torch.resilience.faults import InjectedBackendLoss
    from heat3d_tpu_torch.serve.engine import is_backend_loss

    from heat3d_tpu.resilience.faults import InjectedBackendLoss as JaxLoss

    assert is_backend_loss(InjectedBackendLoss("gone")) and jax_is_loss(JaxLoss("gone"))
    for exc in (ValueError("bad config"), TypeError("bad value"),
                RuntimeError("scenario bug")):
        assert not is_backend_loss(exc) and not jax_is_loss(exc)
    # the CUDA runtime speaking (XLA's runtime errors in JAX)
    assert is_backend_loss(torch.OutOfMemoryError("CUDA out of memory"))
    assert is_backend_loss(torch.AcceleratorError("CUDA error: an illegal memory access"))


def test_serve_stats_degraded_accounting_equals_jax():
    from heat3d_tpu.serve.queue import ServeStats as JaxStats
    from heat3d_tpu_torch.serve.queue import ServeStats

    for cls in (ServeStats, JaxStats):
        st = cls()
        s = st.summary(pending=0)
        assert s["degraded"] is False and s["degraded_s"] == 0.0 and s["requeues"] == 0
        st.mark_degraded()
        st.mark_degraded(new=False)  # the same chunk's second attempt: no new ref
        assert st.requeues == 2 and st.summary(pending=0)["degraded"] is True
        assert st.degraded_seconds() > 0
        st.clear_degraded()
        s = st.summary(pending=0)
        assert s["degraded"] is False and s["degraded_s"] > 0
        st.clear_degraded()  # idempotent
        st2 = cls()
        st2.mark_degraded()  # chunk A
        st2.mark_degraded()  # chunk B
        st2.clear_degraded()  # A resolves: B still degraded
        assert st2.summary(pending=0)["degraded"] is True
        st2.clear_degraded()
        assert st2.summary(pending=0)["degraded"] is False


def _fast_policy(n):
    return RetryPolicy(max_attempts=n, base_delay_s=0.01, multiplier=1.0, max_delay_s=0.01)


def test_injected_loss_requeues_bitwise_to_a_clean_run(tmp_path):
    base = _base(10)
    scs = [Scenario(alpha=0.5, steps=3, init="random", seed=4), Scenario(alpha=0.7, steps=4)]
    with _engine(autostart=False, with_residuals=True, aot=False) as clean:
        for sc in scs:
            clean.submit(base, sc)
        want = {r.request_id: r for r in clean.drain()}
    counter = obs.REGISTRY.counter("serve_requeues_total", "backend-loss batch requeues")
    before = counter.value()
    led = tmp_path / "led.jsonl"
    obs.activate(str(led))
    plan = FaultPlan(_parse_spec("partial-device-loss:batch=0:keep=1"))
    eng = _engine(autostart=False, faults=plan, retry_policy=_fast_policy(3),
                  with_residuals=True)
    rids = [eng.submit(base, sc) for sc in scs]
    got = {r.request_id: r for r in eng.drain()}
    eng.shutdown()
    obs.deactivate()
    assert sorted(got) == rids and not eng.failures
    for rid in rids:
        assert np.array_equal(got[rid].field, want[rid].field)
        assert got[rid].residual_sumsq == want[rid].residual_sumsq
    st = eng.stats()
    assert st["requeues"] == 1 and st["degraded_s"] > 0
    summary = eng.metrics_summary()
    assert summary["requeues"] == 1 and summary["degraded_s"] > 0
    assert summary["degraded"] is False  # the requeued chunk resolved
    # the rebuild after the loss is an in-process hit: no second stall
    assert (st["aot"]["misses"], st["aot"]["hits"], st["aot"]["stalls"]) == (1, 1, 1)
    assert counter.value() == before + 1
    assert "serve_requeues_total" in obs.REGISTRY.to_prometheus_text()
    evs = _events(led)
    names = [e["event"] for e in evs]
    assert names.count("serve_requeue") == 1 and names.count("compile_stall") == 1
    assert "fault_injected" in names
    (rq,) = [e for e in evs if e["event"] == "serve_requeue"]
    assert rq["request_ids"] == rids and rq["attempt"] == 1
    assert "InjectedBackendLoss" in rq["error"]
    roots = [e for e in evs if e["event"] == "serve_span" and e["span"] == "request"]
    assert {r["attempts"] for r in roots} == {2}
    assert any(e["event"] == "serve_span" and e["span"] == "requeue_gap" for e in evs)


def test_scenario_error_still_fails_immediately():
    eng = _engine(autostart=False)
    eng.submit(_base(2, tb=2), Scenario(alpha=0.5, steps=2))
    with pytest.raises(RuntimeError, match="failed"):
        list(eng.drain())
    eng.shutdown()
    assert len(eng.failures) == 1 and eng.stats()["requeues"] == 0
    assert eng.metrics_summary()["degraded_s"] == 0.0


def test_requeues_exhausted_fail_the_chunk():
    plan = FaultPlan(_parse_spec(
        "partial-device-loss:batch=0:keep=1,partial-device-loss:batch=1:keep=1"))
    eng = _engine(autostart=False, faults=plan, retry_policy=_fast_policy(2))
    eng.submit(_base(8), Scenario(alpha=0.5, steps=2))
    with pytest.raises(RuntimeError, match="failed"):
        list(eng.drain())
    eng.shutdown()
    assert len(eng.failures) == 1 and "InjectedBackendLoss" in eng.failures[0]["error"]
    assert eng.stats()["requeues"] == 1
    summary = eng.metrics_summary()
    assert summary["degraded"] is False and summary["degraded_s"] > 0


# ---- the wait of a packed batch -------------------------------------------------------


def test_stream_sync_waits_on_exactly_the_solvers_streams(monkeypatch):
    """``stream_sync`` records one event on the calling thread's current
    stream of each CUDA device of the solver's shards, then on each shard
    stream, and waits on those alone; it never synchronizes the card. The
    queue's batch waits through it."""
    from heat3d_tpu_torch.parallel.topology import Shard
    from heat3d_tpu_torch.utils import timing

    recorded, waited = [], []

    class FakeEvent:
        def record(self, stream):
            recorded.append(stream)
            self.stream = stream

        def synchronize(self):
            waited.append(self.stream)

    class Mesh:
        def __init__(self, shards):
            self.local_shards = shards

    def shard(dev, stream):
        return Shard(0, (0, 0, 0), torch.device(dev), stream, (0, 0, 0), (True,) * 6)

    class Solver:
        groups = [Mesh([shard("cuda:0", None)]),
                  Mesh([shard("cuda:0", "s1"), shard("cuda:1", "s2")]),
                  Mesh([shard("cuda:1", "s2")])]

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: f"current:{d}")

    def no_device_wide(*a, **k):
        raise AssertionError("device-wide synchronize")

    monkeypatch.setattr(torch.cuda, "synchronize", no_device_wide)
    want = ["current:cuda:0", "current:cuda:1", "s1", "s2"]
    assert timing.solver_streams(Solver()) == want
    timing.stream_sync(Solver())
    assert recorded == waited == want
    # on the CPU there is nothing to wait for, and the queue's batch runs
    # through stream_sync, never force_sync
    cpu = type("S", (), {"groups": [Mesh([shard("cpu", None)])]})()
    assert timing.solver_streams(cpu) == []
    monkeypatch.setattr(timing, "force_sync", no_device_wide)
    q = ScenarioQueue(device="cpu")
    q.submit(_base(8), Scenario(alpha=0.5, steps=2))
    assert len(list(q.drain())) == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the engine's worker streams run only on the GPU)")


@pytest.mark.cuda
def test_one_workers_gather_does_not_wait_for_another_workers_batch(cuda, monkeypatch):
    """Two bucket workers on one card: once the long batch's launches are
    queued (its worker waits in ``stream_sync`` after the run), a small
    batch of another bucket runs, gathers and delivers while the long one
    is still in flight — its waits cover its own stream only."""
    from heat3d_tpu_torch.utils import timing

    long_queued = threading.Event()
    real = timing.stream_sync
    calls = {"n": 0}

    def spy(solver):
        if solver.cfg.grid.shape == (256, 256, 256):
            calls["n"] += 1
            if calls["n"] == 2:  # after the run's launches, before its wait
                long_queued.set()
        real(solver)

    monkeypatch.setattr(timing, "stream_sync", spy)
    eng = AsyncServeEngine(workers=2, aot=False, device="cuda:0")
    rid_long = eng.submit(_base(256, steps=400), Scenario(alpha=0.5, steps=400),
                          stream="long")
    assert long_queued.wait(timeout=300)
    rid_short = eng.submit(_base(16, steps=2), Scenario(alpha=0.5, steps=2), stream="short")
    t0 = time.monotonic()
    with eng._cond:
        while eng._req[rid_short].state != "done":
            assert time.monotonic() - t0 < 120
            eng._cond.wait(0.5)
        assert eng._req[rid_long].state == "dispatched", "the short batch waited"
    got = {r.request_id for r in eng.drain(timeout=600)}
    eng.shutdown()
    assert got == {rid_long, rid_short}
