"""The port's soak, SLO and burn-rate layers (``heat3d_tpu_torch.serve.
loadgen``, ``obs/perf/slo.py``, ``obs/burn.py``, ``obs watch``/``obs slo``)
on the CPU, held to the JAX package's.

- Pure Python, equal to JAX: ``generate_arrivals`` arrival for arrival
  (seeded, ramped, bursty, weighted, ``HEAT3D_LOADGEN_SEED``),
  ``validate_mix`` message for message, the default soak SLO, the pow2
  warm-up ladder; ``slo.evaluate`` reports, ``validate_spec`` errors and
  ``obs slo``'s rc on the same ledgers and specs (all four kinds, the
  ``serve_result`` fallback, ``halo_share`` from a torch profile trace);
  ``BurnEvaluator`` alerts, windows and ``final_verdict`` on the same
  event stream; ``obs watch --once``'s status and rc.
- The soak on the CPU (``serve --loadgen --device cpu``, 4 s at most): a
  seeded soak with a partial device loss injected mid-run, monitored,
  with ledger rotation — verdict ``ok``, zero stalls after warmup, the
  degraded window judged with data, the live verdict equal to post-hoc
  ``obs slo``, a requeued request's trace kept, the row through the JAX
  provenance lint; the same mix under an impossible SLO exits 1; under
  ``--monitor --abort-on-burn`` it ends early with rc 1 and a partial
  verdict; the flag checks exit 2 before any soak, as JAX's.
"""

import contextlib
import io
import json
import os

import pytest

from heat3d_tpu.obs import burn as jburn
from heat3d_tpu.obs.perf import slo as jslo
from heat3d_tpu.serve import loadgen as jloadgen
from heat3d_tpu_torch import obs
from heat3d_tpu_torch.obs import burn
from heat3d_tpu_torch.obs.perf import slo
from heat3d_tpu_torch.serve import loadgen
from heat3d_tpu_torch.serve.queue import Backpressure


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("HEAT3D_AOT_CACHE", str(tmp_path / "aot"))
    monkeypatch.setenv("HEAT3D_TUNE_CACHE", str(tmp_path / "tune.json"))
    for var in ("HEAT3D_LEDGER", "HEAT3D_SLO_SPEC", "HEAT3D_FAULTS", "HEAT3D_LOADGEN_SEED",
                "HEAT3D_SLO_WARN_RATIO", "HEAT3D_BURN_FAST_S", "HEAT3D_BURN_SLOW_S",
                "HEAT3D_BURN_THRESHOLD", "HEAT3D_LEDGER_MAX_MB"):
        monkeypatch.delenv(var, raising=False)
    obs.deactivate()
    yield
    obs.deactivate()


def _mix(**over):
    mix = {
        "duration_s": 30,
        "seed": 7,
        "ramp": {"kind": "diurnal", "period_s": 30, "min_frac": 0.25},
        "streams": [
            {"name": "a", "rate_hz": 3.0, "scenarios": [{"grid": 8, "steps": 2}]},
            {"name": "b", "rate_hz": 1.0,
             "burst": {"every_s": 10, "len_s": 2, "multiplier": 6},
             "scenarios": [{"grid": 8, "steps": 2}, {"grid": 8, "steps": 3}]},
        ],
    }
    mix.update(over)
    return mix


def _tuples(arrivals):
    return [(a.t, a.stream, a.record_index) for a in arrivals]


# ---- the schedule ---------------------------------------------------------------


@pytest.mark.parametrize("over", [
    {}, {"seed": 8}, {"ramp": None}, {"duration_s": 100, "ramp": None},
    {"rate_hz": 6.0, "streams": [
        {"name": "tenant-a", "weight": 3, "scenarios": [{"grid": 8}, {"grid": 8}]},
        {"name": "flood", "weight": 1, "burst": {"every_s": 10, "len_s": 2, "multiplier": 8},
         "scenarios": [{"grid": 8}]}]},
], ids=["base", "seed8", "flat", "long", "weighted"])
def test_generate_arrivals_equals_jax(over):
    mix = _mix(**over)
    mine = loadgen.generate_arrivals(mix)
    assert mine and _tuples(mine) == _tuples(jloadgen.generate_arrivals(mix))
    assert [a.t for a in mine] == sorted(a.t for a in mine)


def test_arrivals_seed_from_env_and_per_stream_independence(monkeypatch):
    unseeded = _mix()
    del unseeded["seed"]
    monkeypatch.setenv(loadgen.ENV_LOADGEN_SEED, "7")
    assert _tuples(loadgen.generate_arrivals(unseeded)) == \
        _tuples(loadgen.generate_arrivals(_mix())) == \
        _tuples(jloadgen.generate_arrivals(unseeded))
    solo = [a for a in loadgen.generate_arrivals(_mix()) if a.stream == "a"]
    mix3 = _mix()
    mix3["streams"].append({"name": "c", "rate_hz": 9.0, "scenarios": [{"grid": 8}]})
    assert [a for a in loadgen.generate_arrivals(mix3) if a.stream == "a"] == solo


def test_shaping_and_ladder_equal_jax():
    ramp = {"kind": "diurnal", "period_s": 100, "min_frac": 0.25}
    burst = {"every_s": 10, "len_s": 2, "multiplier": 6}
    for t in (0.0, 0.5, 5.0, 11.9, 50.0, 73.3):
        assert loadgen._rate_factor(t, ramp, 100) == jloadgen._rate_factor(t, ramp, 100)
        assert loadgen._burst_factor(t, burst) == jloadgen._burst_factor(t, burst)
    assert loadgen._rate_factor(50.0, ramp, 100) == pytest.approx(1.0)
    for mb in (1, 2, 3, 8, 64):
        assert loadgen._pow2_ladder(mb) == jloadgen._pow2_ladder(mb)


@pytest.mark.parametrize(
    "mutate, needle",
    [
        (lambda m: m.update(bogus=1), "unknown key"),
        (lambda m: m.pop("duration_s"), "duration_s"),
        (lambda m: m["streams"][1].update(name="a"), "duplicate stream"),
        (lambda m: m["streams"][0].update(scenarios=[]), "scenarios"),
        (lambda m: m["streams"][1]["burst"].pop("len_s"), "burst.len_s"),
        (lambda m: m.update(ramp={"kind": "square"}), "ramp.kind"),
        (lambda m: m["streams"][0].update(rate_hz=-1), "rate_hz"),
        (lambda m: m.update(monitor={"interval_s": 0}), "monitor.interval_s"),
        (lambda m: m.update(seed="x"), "seed"),
    ],
)
def test_validate_mix_names_the_field_at_fault(mutate, needle):
    mine, ref = _mix(), _mix()
    mutate(mine)
    mutate(ref)
    with pytest.raises(ValueError, match=needle) as got:
        loadgen.validate_mix(mine)
    with pytest.raises(ValueError) as want:
        jloadgen.validate_mix(ref)
    assert str(got.value) == str(want.value)


def test_default_soak_slo_is_jaxs_and_valid():
    assert loadgen.DEFAULT_SOAK_SLO == jloadgen.DEFAULT_SOAK_SLO
    spec = slo.validate_spec(dict(loadgen.DEFAULT_SOAK_SLO), origin="default")
    assert {"serve_degraded", "serve_latency"} <= {o["kind"] for o in spec["objectives"]}


def test_backpressure_payload_is_typed():
    e = Backpressure("serve queue full", depth=4, max_depth=4, stream="x",
                     stream_depth=2, stream_cap=2, per_stream={"x": 2, "y": 2})
    assert isinstance(e, RuntimeError)
    assert (e.depth, e.max_depth, e.stream, e.stream_cap) == (4, 4, "x", 2)
    assert e.per_stream == {"x": 2, "y": 2}


def test_soak_row_passes_the_jax_provenance_lint():
    from heat3d_tpu.analysis.provenance import check_row

    verdict = {
        "seed": 7, "duration_s": 8.0, "arrivals": 20, "submitted": 20,
        "admitted": 18, "shed": 2, "delivered": 18, "failed": 0,
        "requeues": 1, "degraded_s": 0.4, "batches": 9, "scale_events": 1,
        "warmup_s": 1.2, "compile_stall_after_warmup": 0,
        "sustained_member_gcell_per_s": 0.05, "per_bucket": {}, "ok": True,
    }
    row = loadgen.soak_row(verdict, "pass", ts="2026-08-06T00:00:00Z", device="cpu")
    assert check_row(row) == []
    assert row["platform"] == "cpu" and row["devices"] == 1
    want = jloadgen.soak_row(verdict, "pass", ts="2026-08-06T00:00:00Z")
    assert set(want) <= set(row) and {k for k in row if k not in want} == {"device_name"}
    assert any("conservation" in p for p in check_row(dict(row, admitted=17)))


# ---- SLO evaluation --------------------------------------------------------------


def _slo_events(p95=0.2, step_dur=None, degraded_s=None):
    summary = {"ts": 1.0, "run_id": "r", "proc": 0, "seq": 0,
               "event": "serve_metrics_summary", "kind": "point",
               "buckets": {"(16, 16, 16)": {"count": 4, "p50_s": p95 / 2, "p95_s": p95,
                                            "max_s": p95},
                           "(8, 8, 8)": {"count": 2, "p50_s": 0.01, "p95_s": 0.02,
                                         "max_s": 0.02}},
               "depth_max": 3}
    if degraded_s is not None:
        summary.update(degraded=degraded_s > 5, degraded_s=degraded_s, requeues=2)
    evs = [summary]
    if step_dur is not None:
        evs.append({"ts": 2.0, "run_id": "r", "proc": 0, "seq": 1, "event": "run_loop",
                    "kind": "span", "t0": 0.0, "t1": step_dur, "dur_s": step_dur,
                    "depth": 0, "status": "ok", "steps": 10})
    return evs


SPECS = {
    "latency": {"objectives": [{"name": "q95", "kind": "serve_latency", "percentile": 95,
                                "max_s": 1.0}]},
    "warn": {"objectives": [{"name": "q95", "kind": "serve_latency", "percentile": 95,
                             "max_s": 0.21}]},
    "breach": {"objectives": [{"name": "q95", "kind": "serve_latency", "percentile": 95,
                               "max_s": 0.1}]},
    "bucket": {"objectives": [{"name": "q50", "kind": "serve_latency", "percentile": 50,
                               "max_s": 0.1, "bucket": "(8,"}]},
    "no_data": {"objectives": [{"name": "q95", "kind": "serve_latency", "percentile": 95,
                                "max_s": 0.1, "bucket": "(999,"}]},
    "step": {"objectives": [{"name": "step-p95", "kind": "step_time", "percentile": 95,
                             "max_s": 0.05}]},
    "degraded": {"warn_ratio": 0.5, "objectives": [
        {"name": "deg", "kind": "serve_degraded", "max_s": 10.0}]},
    "halo": {"objectives": [{"name": "halo-share", "kind": "halo_share", "max_frac": 0.15}]},
    "mixed": {"objectives": [
        {"kind": "serve_latency", "percentile": 99, "max_s": 0.5},
        {"kind": "step_time", "percentile": 50, "max_s": 1.0},
        {"kind": "serve_degraded", "max_s": 3.0},
        {"kind": "halo_share", "max_frac": 0.5}]},
}


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("ledger", [
    dict(), dict(step_dur=1.0), dict(degraded_s=2.0), dict(degraded_s=15.0, step_dur=0.2),
], ids=["summary", "steps", "degraded", "degraded-breach"])
def test_evaluate_equals_jax(spec, ledger):
    evs = _slo_events(**ledger)
    for phase_us in (None, {"halo_exchange": 20.0, "stencil": 150.0, "(unattributed)": 9.0}):
        mine = slo.evaluate(evs, slo.validate_spec(json.loads(json.dumps(SPECS[spec]))),
                            phase_us=phase_us)
        ref = jslo.evaluate(evs, jslo.validate_spec(json.loads(json.dumps(SPECS[spec]))),
                            phase_us=phase_us)
        assert mine == ref


def test_serve_result_fallback_equals_jax():
    evs = [{"event": "serve_result", "kind": "point", "queue_latency_s": v}
           for v in (0.1, 0.2, 0.3)]
    spec = SPECS["latency"]
    rep = slo.evaluate(evs, spec)
    assert rep == jslo.evaluate(evs, spec)
    o = rep["objectives"][0]
    assert o["bucket"] == "(all)" and o["value"] == pytest.approx(0.3)
    assert rep["sources"]["serve"] == "serve_result reconstruction"
    assert slo.load_spec(None) == jslo.load_spec(None)
    assert slo.load_spec(None).get("default_spec") is True


@pytest.mark.parametrize("bad", [
    [], {"objectives": 3}, {"objectives": [3]},
    {"objectives": [{"kind": "nope", "max_s": 1}]},
    {"objectives": [{"kind": "serve_latency", "percentile": 95}]},
    {"objectives": [{"kind": "serve_latency", "percentile": 75, "max_s": 1.0}]},
    {"objectives": [{"kind": "halo_share", "max_s": 1.0}]},
    {"objectives": [{"kind": "serve_degraded", "max_s": 0}]},
])
def test_validate_spec_errors_equal_jax(bad):
    with pytest.raises(ValueError) as got:
        slo.validate_spec(json.loads(json.dumps(bad)), origin="s.json")
    with pytest.raises(ValueError) as want:
        jslo.validate_spec(json.loads(json.dumps(bad)), origin="s.json")
    assert str(got.value) == str(want.value)


def _write(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _both(argv, capsys):
    rc = slo.main(argv)
    out = capsys.readouterr().out
    jrc = jslo.main(argv)
    jout = capsys.readouterr().out
    return rc, jrc, out, jout


def test_obs_slo_rc_equals_jax(tmp_path, capsys, monkeypatch):
    from heat3d_tpu_torch.obs.cli import main as obs_main

    led = _write(tmp_path / "led.jsonl", _slo_events(0.2, step_dur=1.0, degraded_s=2.0))
    for name, want in (("latency", 0), ("warn", 0), ("breach", 1), ("no_data", 0),
                       ("step", 1), ("degraded", 0), ("mixed", 0)):
        spec = _write(tmp_path / f"{name}.json", [SPECS[name]])
        rc, jrc, out, jout = _both([led, "--spec", spec, "--json"], capsys)
        assert rc == jrc == want, name
        mine, ref = json.loads(out), json.loads(jout)
        assert mine == ref
        assert obs_main(["slo", led, "--spec", spec]) == want
        capsys.readouterr()
    # $HEAT3D_SLO_SPEC stands for --spec; the built-in default without either
    monkeypatch.setenv("HEAT3D_SLO_SPEC", str(tmp_path / "breach.json"))
    assert _both([led], capsys)[:2] == (1, 1)
    monkeypatch.delenv("HEAT3D_SLO_SPEC")
    assert _both([led], capsys)[:2] == (0, 0)
    # unreadable spec / ledger, malformed spec: rc 2 in both
    bad = _write(tmp_path / "bad.json", [{"objectives": [{"kind": "nope"}]}])
    for argv in ([led, "--spec", str(tmp_path / "nope.json")],
                 [str(tmp_path / "nope.jsonl")], [led, "--spec", bad]):
        assert _both(argv, capsys)[:2] == (2, 2)


def test_obs_slo_halo_share_from_a_torch_profile(tmp_path, capsys):
    """``--profile`` reads the port's torch trace (``obs.perf.timeline``):
    halo 20 of 187 attributed device us breaches a 0.1 ceiling; without a
    capture ``no_data`` and rc 0, as JAX without one."""
    from test_torch_perf_obs import synthetic_trace

    led = _write(tmp_path / "led.jsonl", _slo_events())
    spec = _write(tmp_path / "halo.json", [{"objectives": [
        {"name": "halo-share", "kind": "halo_share", "max_frac": 0.1}]}])
    rc, jrc, out, _ = _both([led, "--spec", spec, "--json"], capsys)
    assert rc == jrc == 0 and json.loads(out)["objectives"][0]["status"] == "no_data"
    prof = tmp_path / "prof"
    prof.mkdir()
    (prof / "heat3d-1-2.pt.trace.json").write_text(json.dumps(synthetic_trace()))
    assert slo.main([led, "--spec", spec, "--profile", str(prof), "--json"]) == 1
    o = json.loads(capsys.readouterr().out)["objectives"][0]
    assert o["value"] == pytest.approx(round(20.0 / 187.0, 6))
    assert o == jslo.evaluate_objective(
        jslo.validate_spec(json.loads(open(spec).read()))["objectives"][0], None, [],
        {"halo_exchange": 20.0, "stencil": 150.0, "residual": 10.0, "step": 2.0,
         "run_loop": 5.0}, 0.9)


def test_slo_verdict_event_lints(tmp_path, capsys):
    from heat3d_tpu_torch.obs.check import main as check_main

    led = _write(tmp_path / "in.jsonl", _slo_events(step_dur=1.0))
    out_led = str(tmp_path / "verdict.jsonl")
    obs.activate(out_led)
    assert slo.main([led, "--spec", _write(tmp_path / "s.json", [SPECS["step"]])]) == 1
    obs.deactivate()
    capsys.readouterr()
    (v,) = [json.loads(x) for x in open(out_led) if '"slo_verdict"' in x]
    assert v["verdict"] == "breach" and v["objectives"][0]["name"] == "step-p95"
    assert check_main(["--taxonomy", out_led]) == 0


# ---- the burn-rate evaluator -----------------------------------------------------------

BURN_SPEC = {"objectives": [
    {"name": "p95-lat", "kind": "serve_latency", "percentile": 95, "max_s": 0.1},
    {"name": "deg", "kind": "serve_degraded", "max_s": 1.0},
    {"name": "step", "kind": "step_time", "percentile": 50, "max_s": 0.5},
]}


def _result(ts, lat, bucket="b0"):
    return {"ts": ts, "event": "serve_result", "kind": "point", "bucket": bucket,
            "queue_latency_s": lat}


def _burn_stream():
    evs = [_result(980.0 + 0.5 * i, 0.01) for i in range(120)]
    evs += [{"ts": 1000.0 + i, "event": "serve_submit", "kind": "point", "queue_depth": i}
            for i in range(5)]
    evs += [{"ts": 1030.0, "event": "serve_requeue", "kind": "point"},
            {"ts": 1035.0, "event": "serve_metrics_summary", "kind": "point",
             "buckets": {"b0": {"count": 120, "p50_s": 0.01, "p95_s": 0.01, "max_s": 0.01}},
             "degraded": True, "degraded_s": 0.4, "requeues": 1},
            {"ts": 1036.0, "event": "run_loop", "kind": "span", "status": "ok",
             "steps": 4, "dur_s": 1.2}]
    burst = [_result(1040.0 + 0.1 * i, 0.5) for i in range(3)]
    sustained = [_result(1041.0 + i, 0.5) for i in range(59)]
    return [evs, burst, sustained]


def test_burn_evaluator_equals_jax_on_the_same_stream():
    """Healthy traffic, then a burst (fast burns, slow does not: no
    alert), then a sustained breach (both windows: alert) — every
    evaluation, status and the final verdict equal to JAX's, and the
    final verdict equal to post-hoc ``slo.evaluate`` of the whole stream."""
    mine = burn.BurnEvaluator(slo.validate_spec(json.loads(json.dumps(BURN_SPEC))),
                              fast_s=10.0, slow_s=60.0, threshold=1.0)
    ref = jburn.BurnEvaluator(jslo.validate_spec(json.loads(json.dumps(BURN_SPEC))),
                              fast_s=10.0, slow_s=60.0, threshold=1.0)
    alerting = []
    seen = []
    for chunk in _burn_stream():
        seen += chunk
        for e in chunk:  # one at a time: the tailer's worst case
            mine.consume([e])
        ref.consume(chunk)
        rep = mine.evaluate()
        assert rep == ref.evaluate()
        assert mine.status() == ref.status()
        alerting.append(rep["alerting"])
    assert alerting == [[], [], ["p95-lat"]]
    final = mine.final_verdict()
    assert final == ref.final_verdict()
    posthoc = slo.evaluate(seen, mine.spec)
    pin = [(o["name"], o["status"], o["burn_rate"], o["value"]) for o in final["objectives"]]
    assert pin == [(o["name"], o["status"], o["burn_rate"], o["value"])
                   for o in posthoc["objectives"]]


def test_burn_knobs_and_bounded_state(monkeypatch):
    monkeypatch.setenv("HEAT3D_BURN_FAST_S", "7")
    monkeypatch.setenv("HEAT3D_BURN_SLOW_S", "3")  # below fast: raised to it
    monkeypatch.setenv("HEAT3D_BURN_THRESHOLD", "2.5")
    be = burn.BurnEvaluator(dict(BURN_SPEC))
    jbe = jburn.BurnEvaluator(dict(BURN_SPEC))
    assert (be.fast_s, be.slow_s, be.threshold) == (jbe.fast_s, jbe.slow_s,
                                                    jbe.threshold) == (7.0, 7.0, 2.5)
    be = burn.BurnEvaluator(dict(BURN_SPEC), fast_s=5.0, slow_s=10.0)
    be.consume([_result(float(i), 0.01) for i in range(10_000)])
    assert sum(len(dq) for dq in be._lat.values()) <= 12


def test_obs_watch_once_equals_jax(tmp_path, capsys):
    from heat3d_tpu.obs.cli import main as jax_obs
    from heat3d_tpu_torch.obs.cli import main as obs_main

    p = str(tmp_path / "led.jsonl")
    obs.activate(p)
    for i in range(10):
        obs.get().event("serve_submit", request_id=i, queue_depth=i % 3)
        obs.get().event("serve_result", request_id=i, bucket="b0", queue_latency_s=0.02)
    obs.get().event("serve_requeue", request_ids=[3], attempt=1)
    obs.deactivate()
    spec = _write(tmp_path / "spec.json", [{"objectives": [BURN_SPEC["objectives"][0]]}])
    hot = _write(tmp_path / "hot.json", [{"objectives": [
        {"name": "hot", "kind": "serve_latency", "percentile": 50, "max_s": 0.001}]}])
    for s, want in ((spec, 0), (hot, 1)):
        assert obs_main(["watch", p, "--once", "--spec", s, "--json"]) == want
        mine = json.loads(capsys.readouterr().out)
        assert jax_obs(["watch", p, "--once", "--spec", s, "--json"]) == want
        assert mine == json.loads(capsys.readouterr().out)
    assert mine["buckets"]["b0"]["count"] == 10 and mine["flags"] == {"serve_requeue": 1}
    assert obs_main(["watch", p, "--once", "--spec", spec]) == 0
    text = capsys.readouterr().out
    assert "-- watch @" in text and "burn p95-lat" in text and "serve_requeue=1" in text
    assert obs_main(["watch", p, "--once", "--spec", str(tmp_path / "nope.json")]) == 2


# ---- the soak on the CPU ----------------------------------------------------------------


def _soak_mix():
    return {
        "duration_s": 4,
        "seed": 11,
        "ramp": {"kind": "diurnal", "period_s": 4, "min_frac": 0.5},
        "engine": {"max_batch": 2, "max_per_stream": 2, "workers": 1},
        "monitor": {"interval_s": 0.2, "fast_window_s": 2, "slow_window_s": 4},
        "streams": [
            {"name": "tenant-a", "rate_hz": 3.0, "scenarios": [
                {"grid": 12, "steps": 4, "alpha": 0.5, "seed": 1},
                {"grid": 12, "steps": 3, "alpha": 0.8, "init": "gaussian", "seed": 2}]},
            {"name": "flood", "rate_hz": 6.0,
             "burst": {"every_s": 2, "len_s": 1, "multiplier": 5},
             "scenarios": [{"grid": 16, "steps": 20, "alpha": 0.3, "seed": 3}]},
        ],
    }


def _soak(tmp_path, argv, mix):
    from heat3d_tpu_torch.serve.cli import main as serve_main

    spec = tmp_path / "mix.json"
    spec.write_text(json.dumps(mix))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_main(["--loadgen", str(spec), "--verdict", "--device", "cpu", *argv])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])["soak_verdict"]


def test_soak_with_midrun_device_loss_monitored(tmp_path, monkeypatch):
    from heat3d_tpu.analysis.provenance import check_file
    from heat3d_tpu_torch.obs.cli import main as obs_main
    from heat3d_tpu_torch.obs.cli import read_ledger
    from heat3d_tpu_torch.obs.ledger import ledger_segments

    monkeypatch.setenv("HEAT3D_FAULTS", "partial-device-loss:after=2:keep=1")
    monkeypatch.setenv("HEAT3D_LEDGER_MAX_MB", "0.02")  # rotation mid-soak
    ledger = str(tmp_path / "led.jsonl")
    row = tmp_path / "soak.jsonl"
    mix = _soak_mix()
    mix["slo"] = {"objectives": [
        {"name": "lenient-p95", "kind": "serve_latency", "percentile": 95, "max_s": 300.0},
        {"name": "soak-degraded", "kind": "serve_degraded", "max_s": 60.0}]}
    rc, v = _soak(tmp_path, ["--ledger", ledger, "--monitor", "--row", str(row)], mix)
    assert rc == 0 and v["ok"] and v["slo"] == "pass", v
    assert v["accounting_ok"] and v["order_ok"] and v["failed"] == 0
    assert v["admitted"] + v["shed"] == v["submitted"] == v["arrivals"]
    assert v["compile_stall_after_warmup"] == 0 and v["aot"]["hits"] >= 1
    assert v["requeues"] >= 1 and v["degraded_s"] > 0 and not v["partial"]
    assert v["monitor"]["alerts"] == 0 and v["monitor"]["final"] == "pass"
    assert len(ledger_segments(ledger)) >= 2
    # the rotated stream lints clean as one stream, against the taxonomy
    from heat3d_tpu_torch.obs.check import main as check_main

    with contextlib.redirect_stdout(io.StringIO()):
        assert check_main(["--taxonomy", ledger]) == 0
    events = read_ledger(ledger)
    names = [e["event"] for e in events]
    for required in ("loadgen_start", "aot_prewarm", "serve_admission", "fault_injected",
                     "serve_requeue", "soak_verdict", "slo_verdict", "monitor_start",
                     "monitor_summary"):
        assert required in names, required
    (sv,) = [e for e in events if e["event"] == "slo_verdict"]
    (deg,) = [o for o in sv["objectives"] if o["name"] == "soak-degraded"]
    assert deg["status"] == "ok" and deg["burn_rate"] > 0  # judged with data
    # the live verdict equals post-hoc obs slo on the same (rotated) ledger
    posthoc = slo.evaluate(events, slo.validate_spec(dict(mix["slo"])))
    (ms,) = [e for e in events if e["event"] == "monitor_summary"]
    assert ms["final"] == posthoc["verdict"]
    assert {o["name"]: (o["status"], o["burn_rate"]) for o in ms["objectives"]} == \
        {o["name"]: (o["status"], o["burn_rate"]) for o in posthoc["objectives"]}
    # a requeued request keeps one trace through the degraded window
    rids = [r for e in events if e["event"] == "serve_requeue" for r in e["request_ids"]]
    spans = [e for e in events if e["event"] == "serve_span" and e["request_id"] in rids]
    (root,) = [s for s in spans if s["span"] == "request" and s["request_id"] == rids[0]]
    assert root["attempts"] >= 2 and len({s["trace_id"] for s in spans
                                          if s["request_id"] == rids[0]}) == 1
    assert any(s["span"] == "requeue_gap" for s in spans)
    with contextlib.redirect_stdout(io.StringIO()):
        assert obs_main(["trace", ledger, str(rids[0]), "--json"]) == 0
    assert not check_file(str(row))
    r = json.loads(row.read_text())
    assert r["bench"] == "soak" and r["seed"] == 11 and r["platform"] == "cpu"


def test_soak_breach_exits_1(tmp_path):
    mix = _soak_mix()
    mix["duration_s"] = 2
    mix["slo"] = {"objectives": [
        {"name": "impossible-p95", "kind": "serve_latency", "percentile": 95,
         "max_s": 1e-9}]}
    rc, v = _soak(tmp_path, [], mix)
    assert rc == 1 and v["slo"] == "breach" and not v["ok"]
    assert v["accounting_ok"] and v["order_ok"] and v["failed"] == 0


def test_monitored_soak_aborts_on_burn(tmp_path):
    ledger = str(tmp_path / "led.jsonl")
    mix = _soak_mix()
    mix["slo"] = {"objectives": [
        {"name": "impossible-p50", "kind": "serve_latency", "percentile": 50,
         "max_s": 1e-9}]}
    rc, v = _soak(tmp_path, ["--ledger", ledger, "--monitor", "--abort-on-burn"], mix)
    assert rc == 1 and v["aborted"] and not v["ok"] and v["partial"], v
    assert v["abort_reason"] == "slo_burn" and v["monitor"]["alerts"] >= 1
    assert v["duration_s"] < mix["duration_s"]
    events = [json.loads(x) for x in open(ledger)]
    alerts = [e for e in events if e["event"] == "slo_burn_alert"]
    assert alerts and alerts[0]["objective"] == "impossible-p50"
    assert alerts[0]["fast_burn"] >= 1.0
    (sv,) = [e for e in events if e["event"] == "soak_verdict"]
    assert sv["aborted"] is True


@pytest.mark.parametrize("argv", [
    ["--monitor"], ["--abort-on-burn"], ["--smoke"], ["--slo", "nope.json"],
], ids=["monitor-no-ledger", "abort-no-ledger", "with-smoke", "missing-slo"])
def test_loadgen_flag_checks_exit_2_before_the_soak(argv, tmp_path, capsys):
    """Bad flags are refused before the soak burns its duration, rc 2 in
    both packages."""
    from heat3d_tpu.serve.cli import main as jax_serve
    from heat3d_tpu_torch.serve.cli import main as serve_main

    spec = tmp_path / "mix.json"
    mix = _soak_mix()
    mix["duration_s"] = 600  # would run ten minutes if not refused
    spec.write_text(json.dumps(mix))
    argv = [str(tmp_path / a) if a.endswith(".json") else a for a in argv]
    assert serve_main(["--loadgen", str(spec), "--device", "cpu", *argv]) == 2
    assert jax_serve(["--loadgen", str(spec), *argv]) == 2
    assert "heat3d serve: error:" in capsys.readouterr().err
